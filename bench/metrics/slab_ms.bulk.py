"""slab_ms.bulk: per wave, the step's capacity x inputs bool slab zeroed
and the admitted chunks scattered into it, from the program's own span
`engine.slab` (`repro_torch.obs`, recorded while the traced run's
profiler listens) (ms)."""
from benchkit.program_spans import per_wave_ms


def read(run):
    return per_wave_ms(run, "engine.slab")
