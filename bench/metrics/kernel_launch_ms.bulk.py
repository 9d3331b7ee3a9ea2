"""kernel_launch_ms.bulk: per wave, the runner's host time enqueuing K2
(`mega_forward_words`), from the program's own span `runner.kernel`
(`repro_torch.obs`, recorded while the traced run's profiler listens)
(ms)."""
from benchkit.program_spans import per_wave_ms


def read(run):
    return per_wave_ms(run, "runner.kernel")
