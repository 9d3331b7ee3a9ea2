"""admit_ms.bulk: per wave, `LogicEngine.step`'s admission: the queue
popped and `SlotTable.acquire`, from the program's own span
`engine.admit` (`repro_torch.obs`, recorded while the traced run's
profiler listens) (ms)."""
from benchkit.program_spans import per_wave_ms


def read(run):
    return per_wave_ms(run, "engine.admit")
