"""The device trace of a traced run: ``torch.profiler`` over a steady part
of the window.

The profiler runs for a few seconds inside the window (not over all of
it: the trace of a 30-second window is too large to read back within a
run's time).  The device's operations, kernels and copies, are placed on
the host clock by two anchors: at the traced span's start and at its end
the harness waits for the device to drain and launches one tiny marker
kernel (``torch.cuda._sleep``'s spin kernel), reading ``perf_counter`` at
the launch.  The span opens a moment after the profiler does: a device
operation launched at once may go unrecorded.  The two anchors' device timestamps and host readings fix the
map from the trace's clock to the host's, offset and rate, so a trace
whose device clock runs at another rate than the host's is read at the
host's (``TraceSummary.clock_scale`` says by how much it was off).  With
the operations and the harness's spans on one clock, each idle gap of the
device is named by the innermost span the host was in.

Beside the anchors the harness asks ``nvidia-smi`` once at each end for
the card's clocks and power (``TraceSummary.card``), since a device time
means little without the clock it ran at.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

#: the marker kernel's name in the trace, and its length in clock cycles
ANCHOR, ANCHOR_CYCLES = "spin_kernel", 1000
#: seconds the profiler records before the traced span opens
SETTLE_S = 0.25
#: profiler bookkeeping that is not device work
NOT_WORK = ("Activity Buffer Request",)
#: what the card is asked at each end of the trace
CARD_QUERY = ("nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
              "clocks.mem,power.draw,power.limit,temperature.gpu",
              "--format=csv,noheader")
OUTSIDE = "outside the harness's spans"
TOP = 10
#: a device operation's name in the breakdown is cut to this many letters
#: (a kernel's full signature runs to hundreds)
NAME_CHARS = 100


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float | None                  # None: no device operation seen
    ops: dict = field(default_factory=dict)    # name -> [count, seconds]
    gaps: dict = field(default_factory=dict)   # host label -> [count, s]
    #: host seconds a second of the trace's device clock (1: it kept time)
    clock_scale: float | None = None
    anchors_found: int = 0
    card: list = field(default_factory=list)   # nvidia-smi at each end

    def op_seconds(self, match) -> tuple[int, float]:
        """Count and device seconds of the operations whose name
        ``match(name)`` accepts."""
        n, s = 0, 0.0
        for name, (count, secs) in self.ops.items():
            if match(name):
                n += count
                s += secs
        return n, s

    def breakdown(self) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1][1])[:TOP]
        return {"device_ops": [[name[:NAME_CHARS], secs]
                               for name, (_, secs) in ops],
                "idle_gaps": [[f"{label} ({count} gaps)", secs]
                              for label, (count, secs) in gaps]}


class DeviceTrace:
    """Start and stop ``torch.profiler`` inside the window; read it after."""

    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.cuda = device.type == "cuda"
        self.prof = None
        self.anchors: list[float] = []    # host clock at each anchor launch
        self.queries: list = []           # nvidia-smi processes
        self.t_open = self.t_start = self.t_stop = None

    def _anchor(self) -> None:
        if not self.cuda:
            return
        self.torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        self.torch.cuda._sleep(ANCHOR_CYCLES)
        self.anchors.append((t0 + time.perf_counter()) / 2)
        self.torch.cuda.synchronize(self.device)

    def _ask_card(self) -> None:
        if not self.cuda:
            return
        import subprocess
        try:
            self.queries.append(subprocess.Popen(
                CARD_QUERY, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        except OSError as exc:
            self.queries.append(repr(exc))

    def _card(self) -> list:
        out = []
        for q in self.queries:
            if isinstance(q, str):
                out.append(q)
                continue
            try:
                text, _ = q.communicate(timeout=30)
            except Exception as exc:          # noqa: BLE001
                q.kill()
                q.wait()
                text = repr(exc)
            out.append(text.strip())
        self.queries.clear()
        return out

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def prime(self) -> None:
        """Profile an anchor once in set-up, so that the profiler's and
        the marker kernel's start-up do not fall inside the window."""
        with self._profile():
            self._anchor()
        self.anchors.clear()

    def start(self) -> None:
        """Open the profile; the traced span opens at ``settle``."""
        self._ask_card()
        self.prof = self._profile()
        self.prof.__enter__()
        self.t_open = time.perf_counter()

    def settle(self, now: float) -> None:
        """Open the traced span with its first anchor once the profiler
        has recorded for ``SETTLE_S``."""
        if self.t_start is None and now >= self.t_open + SETTLE_S:
            self._anchor()
            self.t_start = time.perf_counter()

    def stop(self) -> None:
        self.t_stop = time.perf_counter()
        if self.t_start is None:          # the span never opened
            self.t_start = self.t_stop
        else:
            self._anchor()
        self.prof.__exit__(None, None, None)
        self._ask_card()

    @property
    def started(self) -> bool:
        return self.prof is not None

    def summary(self, spans) -> TraceSummary:
        """Device work and idle gaps within the profiled window, each gap
        named by the host span it fell in (``spans``: ``Spans``)."""
        from torch.autograd import DeviceType
        events = [e for e in self.prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.name not in NOT_WORK]
        card = self._card()
        lo, hi = self.t_start, self.t_stop
        summary = TraceSummary(window_s=hi - lo, busy_s=None, card=card)
        marks = sorted(e.time_range.start / 1e6 for e in events
                       if ANCHOR in e.name)
        summary.anchors_found = len(marks)
        if len(marks) < 2 or len(self.anchors) != 2 or \
                marks[-1] <= marks[-2]:
            return summary
        # host clock = h0 + (trace clock - g0) * scale; the last two
        # anchors are this span's (a set-up profile's may linger before)
        (g0, g1), (h0, h1) = marks[-2:], self.anchors
        scale = (h1 - h0) / (g1 - g0)
        summary.clock_scale = scale
        lo, hi = self.t_start, self.t_stop
        ops: dict[str, list] = {}
        ivs = []
        for e in events:
            if ANCHOR in e.name:
                continue
            s = max(lo, h0 + (e.time_range.start / 1e6 - g0) * scale)
            t = min(hi, h0 + (e.time_range.end / 1e6 - g0) * scale)
            if t <= s:
                continue
            rec = ops.setdefault(e.name, [0, 0.0])
            rec[0] += 1
            rec[1] += t - s
            ivs.append((s, t))
        summary.ops = ops
        if not ivs:
            return summary
        busy, gaps, cur_lo, cur_hi = 0.0, [], None, lo
        for s, t in sorted(ivs):
            if cur_lo is None or s > cur_hi:
                if cur_lo is not None:
                    busy += cur_hi - cur_lo
                if s > cur_hi:
                    gaps.append((cur_hi, s))
                cur_lo, cur_hi = s, t
            else:
                cur_hi = max(cur_hi, t)
        busy += cur_hi - cur_lo
        if hi > cur_hi:
            gaps.append((cur_hi, hi))
        summary.busy_s = busy
        summary.gaps = _name_gaps(gaps, spans)
        return summary


def _name_gaps(gaps, spans) -> dict:
    """Split the idle gaps by what the host was doing: each stretch of a
    gap goes to the innermost (shortest) harness span that covers it, or to
    ``OUTSIDE``; per label, the gaps it took part of and the seconds."""
    table = [(label, spans.intervals(label)) for label in spans.labels()]
    out: dict[str, list] = {}
    for s, t in gaps:
        inside = []                 # (duration, start, end, label) overlapping
        for label, iv in table:
            if not len(iv):
                continue
            lo = max(0, np.searchsorted(iv[:, 0], s, side="right") - 1)
            hi = np.searchsorted(iv[:, 0], t, side="left")
            for a, b in iv[lo:hi]:
                if b > s and a < t:
                    inside.append((b - a, max(a, s), min(b, t), label))
        cuts = sorted({s, t, *(x for _, a, b, _ in inside for x in (a, b))})
        took: dict[str, float] = {}
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            cover = [(d, label) for d, x, y, label in inside if x <= mid <= y]
            label = min(cover)[1] if cover else OUTSIDE
            took[label] = took.get(label, 0.0) + float(b - a)
        for label, secs in took.items():
            rec = out.setdefault(label, [0, 0.0])
            rec[0] += 1
            rec[1] += secs
    return out
