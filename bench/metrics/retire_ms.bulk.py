"""retire_ms.bulk: per wave, the step's retire: outputs gathered into each
request, `SlotTable.release` and the finished requests tracked, from the
program's own span `engine.retire` (`repro_torch.obs`, recorded while
the traced run's profiler listens) (ms)."""
from benchkit.program_spans import per_wave_ms


def read(run):
    return per_wave_ms(run, "engine.retire")
