"""Closed loop on the engine: a fixed number of requests always in it.

The mix gives the engine's ``capacity``, the requests kept ``outstanding``
and their sizes: ``request_samples`` for a fixed size, or ``size_mean``
and ``size_max`` for geometric sizes (``benchkit.traffic.sizes``).  Each
request's bits are a view into the payload pool at an offset drawn from
the seed.  Whenever a wave completes requests, as many new ones are
submitted (``LogicEngine.submit``, or ``submit_chain`` for a stack of
layers), so the engine never runs dry and every wave is as full as the
sizes allow.

Set-up serves one request alone (the first request: store load, launch
records, upload, first launch), then ``warmup_waves`` waves of the loop
itself.  The window runs waves until ``--seconds`` have passed; the wave
that is running then finishes, and the window closes when it does, so
the rate counts all the work and all the time.  Requests still queued at
the close are served and judged, not counted.  A share ``check_share``
of the requests, drawn from the seed, keeps its bits to be judged.
"""
from __future__ import annotations

import time

import numpy as np

from benchkit.harness import GRACE_S
from benchkit.traffic import offsets, sizes

BLOCK = 1 << 16


class Feed:
    """Request sizes, pool offsets and check marks, drawn in blocks."""

    def __init__(self, ctx, mix):
        self.fixed = mix.get("request_samples")
        self.size_mean, self.size_max = mix.get("size_mean"), \
            mix.get("size_max")
        self.share = float(mix["check_share"])
        self.rows = len(ctx.pool)
        self.r_size, self.r_off, self.r_check = (
            ctx.rng("sizes"), ctx.rng("offsets"), ctx.rng("check"))
        self.i = BLOCK

    def _refill(self) -> None:
        n = np.full(BLOCK, self.fixed) if self.fixed else \
            sizes(self.size_mean, self.size_max, BLOCK, self.r_size)
        self.n = n.tolist()
        self.off = offsets(self.rows, n, self.r_off).tolist()
        self.check = (self.r_check.random(BLOCK) < self.share).tolist()
        self.i = 0

    def next(self):
        if self.i == BLOCK:
            self._refill()
        i = self.i
        self.i += 1
        return self.off[i], self.n[i], self.check[i]


def run(ctx) -> None:
    mix = ctx.mix
    eng = ctx.engine(int(mix["capacity"]))
    graphs = ctx.graphs
    if len(graphs) == 1:
        graph = graphs[0]
        submit = lambda bits: eng.submit(graph, bits)     # noqa: E731
    else:
        submit = lambda bits: eng.submit_chain(graphs, bits)  # noqa: E731
    pool, feed = ctx.pool, Feed(ctx, mix)
    outstanding = int(mix["outstanding"])

    # the first request alone
    off, n, _ = feed.next()
    t = time.perf_counter()
    uid = submit(pool[off:off + n])
    while uid not in eng.step():
        pass
    out = eng.result(uid)
    ctx.sync()
    ctx.first_request(time.perf_counter() - t)
    ctx.keep(off, n, out)

    inflight: dict[int, tuple] = {}

    def top_up():
        while len(inflight) < outstanding:
            off, n, check = feed.next()
            inflight[submit(pool[off:off + n])] = (off, n, check)

    def wave(judged: bool):
        done = eng.step()
        samples = 0
        for uid in done:
            off, n, check = inflight.pop(uid)
            out = eng.result(uid)
            samples += n
            if check and judged:
                ctx.keep(off, n, out)
        top_up()
        return len(done), samples

    top_up()
    for _ in range(int(mix["warmup_waves"])):
        wave(False)
    ctx.warmed()

    completed = samples = 0
    t0 = ctx.begin_window()
    end = t0 + ctx.seconds
    tick = ctx.tick
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        tick(now)
        k, s = wave(True)
        completed += k
        samples += s
    t_close = time.perf_counter()
    ctx.end_window(t0, t_close)

    # what is still in the engine was due in the window: serve and judge it
    due = dict(inflight)
    give_up = time.perf_counter() + GRACE_S
    while not eng.idle and time.perf_counter() < give_up:
        for uid in eng.step():
            off, n, check = due.pop(uid)
            out = eng.result(uid)
            if check:
                ctx.keep(off, n, out)
    ctx.run.samples = samples
    ctx.run.unanswered = ctx.run.failed = len(due)
    ctx.run.attempted = completed + len(inflight)
