"""pack_ms.bulk: per wave, the runner's host time in `pack_bits`, from the
program's own span `runner.pack` (`repro_torch.obs`, recorded while the
traced run's profiler listens) (ms)."""
from benchkit.program_spans import per_wave_ms


def read(run):
    return per_wave_ms(run, "runner.pack")
