"""h2d_host_ms.bulk: per wave, the runner's host time moving the slab to
the device (`torch.from_numpy(bits).to(device)`, a pageable copy), from
the program's own span `runner.h2d` (`repro_torch.obs`, recorded while
the traced run's profiler listens) (ms)."""
from benchkit.program_spans import per_wave_ms


def read(run):
    return per_wave_ms(run, "runner.h2d")
