"""Spans the harness records around its calls into the program's layers.

A span is a label with the host clock (``time.perf_counter``) at its
start and end.  Spans are kept in memory and read after the window.  The
harness records them only in a traced run (``--trace 1``); in an untraced
run nothing is wrapped.

``wrap`` replaces a method *on one instance* (the engine's ``step``, a
cache entry's runner) with a timed call of the original; ``watch_gc``
records the interpreter's garbage collections as spans ``gc``;
``unwrap_all`` puts every original back.
"""
from __future__ import annotations

import gc
import time
from collections import defaultdict

import numpy as np


class Spans:
    def __init__(self):
        self._spans: dict[str, list] = defaultdict(list)
        self._wrapped: list[tuple[object, str, object, bool]] = []
        self.on = False             # record only between start and stop

    def add(self, label: str, t0: float, t1: float) -> None:
        if self.on:
            self._spans[label].append((t0, t1))

    def wrap(self, owner, name: str, label: str) -> bool:
        """Time every call of ``owner.name`` as ``label``; False where
        ``owner`` has no such callable."""
        fn = getattr(owner, name, None)
        if not callable(fn):
            return False
        had = name in vars(owner) if hasattr(owner, "__dict__") else False
        add = self.add

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                add(label, t0, time.perf_counter())

        setattr(owner, name, timed)
        self._wrapped.append((owner, name, fn, had))
        return True

    def wrap_item(self, mapping: dict, key, label: str) -> None:
        """Time every call of ``mapping[key]`` as ``label``."""
        fn = mapping[key]
        add = self.add

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                add(label, t0, time.perf_counter())

        mapping[key] = timed
        self._wrapped.append((mapping, key, fn, True))

    def watch_gc(self) -> None:
        """Record each garbage collection as a span ``gc``."""
        started = []

        def on_gc(phase, info):
            if phase == "start":
                started.append(time.perf_counter())
            elif started:
                self.add("gc", started.pop(), time.perf_counter())

        gc.callbacks.append(on_gc)
        self._wrapped.append((gc.callbacks, None, on_gc, False))

    def unwrap_all(self) -> None:
        for owner, name, fn, had in reversed(self._wrapped):
            if owner is gc.callbacks:
                gc.callbacks.remove(fn)
                continue
            if isinstance(owner, dict):
                owner[name] = fn
            elif had:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)
        self._wrapped.clear()

    def intervals(self, label: str) -> np.ndarray:
        """(n, 2) start and end of every span ``label``, in order."""
        got = self._spans.get(label, [])
        return np.asarray(sorted(got), dtype=float).reshape(-1, 2)

    def durations(self, label: str) -> np.ndarray:
        iv = self.intervals(label)
        return iv[:, 1] - iv[:, 0]

    def labels(self) -> list[str]:
        return sorted(self._spans)
