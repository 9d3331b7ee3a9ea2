"""The reductions the metric readers share: spans, trace and counters to
numbers.  Each returns None where the run holds nothing to read."""
from __future__ import annotations

import numpy as np

from benchkit import roofline

KERNEL = "mega_kernel"


def quantile(values, q: float) -> float | None:
    """The ``q`` quantile taking the nearest value at or above it (no
    interpolation, so a missed request's infinite latency stays one)."""
    v = np.asarray(values, dtype=float)
    if not v.size:
        return None
    return float(np.quantile(v, q, method="higher"))


def per_wave_ms(run, label: str) -> float | None:
    """Mean span ``label`` per engine wave of the window (ms)."""
    waves = len(run.spans.intervals("engine.step"))
    d = run.spans.durations(label)
    if not waves or not d.size:
        return None
    return float(d.sum()) / waves * 1e3


def engine_host_ms(run) -> float | None:
    """A wave's time in ``LogicEngine.step`` outside its runner (ms)."""
    step = run.spans.durations("engine.step")
    runner = run.spans.durations("runner")
    if not step.size or not runner.size:
        return None
    return float(step.sum() - runner.sum()) / step.size * 1e3


def kernel_launches(run) -> tuple[int, float]:
    tr = run.device_trace
    if tr is None or tr.busy_s is None:
        return 0, 0.0
    return tr.op_seconds(lambda name: KERNEL in name)


def copy_ms(run) -> float | None:
    """Device time of host-device copies per wave (ms), over the trace."""
    waves, _ = kernel_launches(run)
    if not waves:
        return None
    _, secs = run.device_trace.op_seconds(
        lambda name: name.startswith("Memcpy HtoD")
        or name.startswith("Memcpy DtoH"))
    return secs / waves * 1e3


def k2_roofline(run) -> float | None:
    """The mega kernel's least time over its device time (%)."""
    n, secs = kernel_launches(run)
    if not n or run.shape is None or secs <= 0:
        return None
    bound_s, _ = roofline.launch_bound_s(run.shape)
    return bound_s / (secs / n) * 100


def logic_mfu(run) -> float | None:
    """Gate word operations the window's served samples needed, over the
    window at the card's int32 peak (%)."""
    if run.shape is None or not run.window_s:
        return None
    ops = roofline.served_word_ops(run.samples, run.shape["gates"])
    return ops / (run.window_s * roofline.INT32_OPS_PER_S) * 100


def idle_share(run) -> float | None:
    """The share of the traced window in which no operation ran on the
    device (%)."""
    tr = run.device_trace
    if tr is None or tr.busy_s is None or tr.window_s <= 0:
        return None
    return (1 - tr.busy_s / tr.window_s) * 100


def per_window_ms(run, label: str) -> float | None:
    """Span ``label``'s total per second of the window (ms/s)."""
    if not run.window_s or not run.traced:
        return None
    return float(run.spans.durations(label).sum()) / run.window_s * 1e3
