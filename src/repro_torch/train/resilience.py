# Copied from src/repro/train/resilience.py (no JAX import).
"""Straggler detection + heartbeat / failure handling (1000-node posture).

On a real fleet these monitors run per-host and feed the job controller:
a straggling host triggers (a) collective timeout re-tuning, (b) hot-spare
swap-in, or (c) checkpoint-restart excluding the host (elastic downsize —
the checkpoint layer is mesh-agnostic so the restart reshards). Here the
logic is exercised by tests/simulation; the policies are real.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class StragglerMonitor:
    """p-quantile based step-time outlier detector with hysteresis."""

    window: int = 50
    threshold: float = 2.0        # x median
    min_samples: int = 10
    consecutive: int = 3          # flags needed before alarm
    _times: deque = field(default_factory=lambda: deque(maxlen=256))
    _flags: int = 0

    def record(self, step_seconds: float) -> bool:
        """Returns True when the host should be declared a straggler."""
        self._times.append(step_seconds)
        if len(self._times) < self.min_samples:
            return False
        recent = sorted(list(self._times)[-self.window:])
        median = recent[len(recent) // 2]
        if step_seconds > self.threshold * median:
            self._flags += 1
        else:
            self._flags = 0
        return self._flags >= self.consecutive

    @property
    def median(self) -> float:
        if not self._times:
            return 0.0
        r = sorted(self._times)
        return r[len(r) // 2]


@dataclass
class Heartbeat:
    """Dead-man switch: a host missing ``timeout`` seconds is presumed dead."""

    timeout: float = 60.0
    _last: dict = field(default_factory=dict)

    def beat(self, host: str, now: float | None = None) -> None:
        self._last[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self._last.items() if now - t > self.timeout]


class PreemptionGuard:
    """Cooperative preemption: SIGTERM -> finish step, checkpoint, exit.

    Register with ``install()``; the trainer polls ``should_stop``.
    """

    def __init__(self):
        self.should_stop = False

    def install(self) -> "PreemptionGuard":
        import signal

        def handler(signum, frame):
            self.should_stop = True

        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass   # non-main thread (tests)
        return self
