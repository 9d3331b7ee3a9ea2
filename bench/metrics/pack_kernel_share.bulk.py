"""pack_kernel_share.bulk: the share of the window's `runner.pack` and
`runner.unpack` spans that note `kernel=True`, the wave's bits laid out
and back by the hand-written pack and unpack kernels (%); None where the
port notes no `kernel` on them (the spans are `repro_torch.obs`'s,
recorded while the traced run's profiler listens)."""
from benchkit.program_spans import in_window


def read(run):
    notes = [s.attrs["kernel"] for s in in_window(run)
             if s.label in ("runner.pack", "runner.unpack")
             and "kernel" in s.attrs]
    if not notes:
        return None
    return 100.0 * sum(map(bool, notes)) / len(notes)
