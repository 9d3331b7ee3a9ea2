"""d2h_wait_ms.bulk: per wave, the runner's `.cpu().numpy()`: the host's
wait for the stream, then the copy back, from the program's own span
`runner.d2h` (`repro_torch.obs`, recorded while the traced run's
profiler listens) (ms)."""
from benchkit.program_spans import per_wave_ms


def read(run):
    return per_wave_ms(run, "runner.d2h")
