"""staged_h2d_share.bulk: the share of the window's `runner.h2d` spans
that note `staged=True`, the slab crossing through the runner's reused
pinned buffers a chunk at a time (%); None where the port notes no
`staged` (the span is `repro_torch.obs`'s, recorded while the traced
run's profiler listens)."""
from benchkit.program_spans import in_window


def read(run):
    notes = [s.attrs["staged"] for s in in_window(run)
             if s.label == "runner.h2d" and "staged" in s.attrs]
    if not notes:
        return None
    return 100.0 * sum(map(bool, notes)) / len(notes)
