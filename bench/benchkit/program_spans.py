"""The program's own spans (``repro_torch.obs``) in a traced run.

The port records spans of its phases (``LogicEngine.step`` and its runner)
while a torch profiler is active, that is over the device trace of a
``--trace 1`` run, on ``time.perf_counter``: the clock of the harness's
spans.  Its log lives as long as the process, so a run keeps the spans
that lie between the start of its first harness ``engine.step`` span and
the end of its last.  A program without the spans (an older port: no
``repro_torch.obs``) gives nothing to read.
"""
from __future__ import annotations


def in_window(run) -> list:
    """The program's spans inside the run's window of harness steps."""
    try:
        from repro_torch import obs
    except ImportError:
        return []
    steps = run.spans.intervals("engine.step")
    if not len(steps):
        return []
    lo, hi = steps[0, 0], steps[-1, 1]
    return [s for s in obs.spans() if s.start >= lo and s.end <= hi]


def per_wave_ms(run, label: str) -> float | None:
    """Span ``label``'s mean per program ``engine.step`` (ms); None where
    the run holds no such span or no wave."""
    spans = in_window(run)
    waves = sum(s.label == "engine.step" for s in spans)
    took = [s.end - s.start for s in spans if s.label == label]
    if not waves or not took:
        return None
    return sum(took) / waves * 1e3
