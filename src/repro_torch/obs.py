"""Spans of the port's own phases on the host clock.

``span(label, **attrs)`` is a context manager around one phase of the
program (``LogicEngine.step`` and its runner time theirs with it).  It
records only while someone listens:

- while a torch profiler is active (``torch.profiler.profile``), read
  from torch's own flag on every call; the span then also opens a
  ``record_function`` range named ``label`` (``RANGE``), so the
  profiler's timeline shows it above the kernels it launched;
- inside ``with recording():``, without a profiler.

A recorded span is one :class:`Span` in a bounded in-memory log: its
label, start and end on ``time.perf_counter``, its index and the index of
the span it ran inside on the same thread (``parent``), the thread, and
its attributes (``note``).  ``spans()`` returns the log, oldest first, and
``clear()`` empties it; past ``LIMIT`` entries the oldest are dropped and
counted (``dropped()``).  Otherwise ``span`` returns one shared object
that does nothing: no allocation, no clock read.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _profiler

#: entries the log keeps (about 6,000 waves of ``LogicEngine.step``)
LIMIT = 1 << 16
#: the profiler's range around a span: torch's fast form of
#: ``record_function``, the same user range in the trace (on the H100's
#: host under a profiler 2.2 µs against ``record_function``'s 12.4)
RANGE = torch._C._profiler._RecordFunctionFast


class Span:
    """One recorded phase; the context manager ``span`` returns."""

    __slots__ = ("label", "start", "end", "index", "parent", "thread",
                 "attrs", "_range")

    def __init__(self, label: str, attrs: dict):
        self.label, self.attrs = label, attrs
        self.start = self.end = None
        self.index = next(_index)
        self.parent = self._range = None
        self.thread = threading.get_ident()

    def note(self, **attrs) -> None:
        """Add attributes to the span."""
        self.attrs.update(attrs)

    def __enter__(self) -> Span:
        stack = _stack()
        if stack:
            self.parent = stack[-1].index
        stack.append(self)
        self.start = time.perf_counter()
        if _profiler._is_profiler_enabled:
            self._range = RANGE(self.label)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end = time.perf_counter()
        _stack().pop()
        _log.add(self)


class _Off:
    """The span returned while nothing records."""

    __slots__ = ()

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> None:
        pass

    def note(self, **attrs) -> None:
        pass


class _Log:
    def __init__(self):
        self.entries: deque = deque(maxlen=LIMIT)
        self.dropped = 0
        self.recording = 0          # depth of open ``recording()`` blocks
        self.lock = threading.Lock()

    def add(self, sp: Span) -> None:
        with self.lock:
            if len(self.entries) == self.entries.maxlen:
                self.dropped += 1
            self.entries.append(sp)


_OFF = _Off()
_log = _Log()
_index = itertools.count()
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(label: str, **attrs):
    """Time the ``with`` block as ``label`` while recording is on."""
    if _log.recording or _profiler._is_profiler_enabled:
        return Span(label, attrs)
    return _OFF


@contextmanager
def recording():
    """Record spans inside the block, without a profiler."""
    with _log.lock:
        _log.recording += 1
    try:
        yield
    finally:
        with _log.lock:
            _log.recording -= 1


def spans() -> list[Span]:
    """The recorded spans, oldest first (each in the order it ended)."""
    with _log.lock:
        return list(_log.entries)


def dropped() -> int:
    """Spans dropped from the log since the last ``clear``."""
    return _log.dropped


def clear() -> None:
    with _log.lock:
        _log.entries.clear()
        _log.dropped = 0
