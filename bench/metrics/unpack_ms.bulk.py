"""unpack_ms.bulk: per wave, the runner's host time in `unpack_bits`, from
the program's own span `runner.unpack` (`repro_torch.obs`, recorded
while the traced run's profiler listens) (ms)."""
from benchkit.program_spans import per_wave_ms


def read(run):
    return per_wave_ms(run, "runner.unpack")
