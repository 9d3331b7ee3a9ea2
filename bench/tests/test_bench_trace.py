"""The trace's device operations are placed on the host clock by its two
anchors, at the host's rate whatever rate the trace's clock ran at."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from benchkit.spans import Spans
from benchkit.trace import ANCHOR, DeviceTrace


def event(name, start_s, end_s):
    from torch.autograd import DeviceType
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                           time_range=SimpleNamespace(start=start_s * 1e6,
                                                      end=end_s * 1e6))


def traced(scale: float, offset: float = 7.0, linger: bool = False):
    """A 2-s trace on the host's clock [100, 102]: an anchor at each end,
    and every 10 ms a 1-ms copy and a 0.5-ms kernel inside a 3-ms runner
    span; the trace's clock reads ``offset + scale * (host - 100)``.
    ``linger``: a set-up profile's anchor shows up too, long before."""
    at = lambda h: offset + scale * (h - 100.0)     # noqa: E731
    events = [event(f"{ANCHOR}(long)", at(100.0), at(100.000001)),
              event(f"{ANCHOR}(long)", at(102.0), at(102.000001))]
    if linger:
        events.insert(0, event(f"{ANCHOR}(long)", at(90.0), at(90.000001)))
    spans = Spans()
    spans.on = True
    for h in 100.001 + 0.01 * np.arange(199):
        events.append(event("Memcpy HtoD (Pageable -> Device)", at(h),
                            at(h + 0.001)))
        events.append(event("mega_kernel<true, 1>", at(h + 0.0015),
                            at(h + 0.002)))
        spans.add("runner", h - 0.0005, h + 0.0025)
    tr = DeviceTrace(SimpleNamespace(), SimpleNamespace(type="cpu"))
    tr.prof = SimpleNamespace(events=lambda: events)
    tr.anchors = [100.0, 102.0]
    tr.t_start, tr.t_stop = 100.0, 102.0
    return tr.summary(spans)


@pytest.mark.parametrize("linger", [False, True])
@pytest.mark.parametrize("scale", [1.0, 0.5, 2.0, 1.0003])
def test_device_times_are_read_at_the_hosts_rate(scale, linger):
    s = traced(scale, linger=linger)
    assert s.anchors_found == 2 + linger
    assert s.clock_scale == pytest.approx(1 / scale)
    n, secs = s.op_seconds(lambda name: "mega_kernel" in name)
    assert n == 199 and secs == pytest.approx(199 * 0.0005, rel=1e-6)
    _, copies = s.op_seconds(lambda name: name.startswith("Memcpy"))
    assert copies == pytest.approx(199 * 0.001, rel=1e-6)
    assert s.busy_s == pytest.approx(199 * 0.0015, rel=1e-6)
    assert s.window_s == 2.0
    # every gap between a wave's copy and its kernel lies in its runner
    assert s.gaps["runner"][0] >= 199


def test_no_anchors_no_device_reading():
    s = traced(1.0)
    tr = DeviceTrace(SimpleNamespace(), SimpleNamespace(type="cpu"))
    tr.prof = SimpleNamespace(events=lambda: [])
    tr.anchors, tr.t_start, tr.t_stop = [], 0.0, 1.0
    empty = tr.summary(Spans())
    assert empty.busy_s is None and empty.clock_scale is None
    assert s.busy_s is not None
