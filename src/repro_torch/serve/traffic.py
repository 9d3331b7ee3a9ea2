# Copied from src/repro/serve/traffic.py; only the repro imports differ.
"""Closed-loop traffic generation for the serving front door.

The ROADMAP's "millions of users" claim is only testable against
realistic load: bursty arrivals, ragged request sizes, a tenant mix.
This module builds seeded-deterministic traffic traces — Poisson
(exponential interarrivals) or heavy-tail (Pareto interarrivals, the
open-loop burst model) — and drives a :class:`~repro.serve.frontdoor
.FrontDoor` closed-loop: every request is actually awaited, every
outcome (completion latency, shed reason, deadline miss) recorded, and
the result folded into a :class:`TrafficReport` whose numbers are what
``benchmarks/run.py`` persists as ``serve.traffic.*`` rows in
``BENCH_logic.json`` (schema in benchmarks/README.md).
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serve.frontdoor import FrontDoor, Priority, RequestRejected

_ARRIVALS = ("poisson", "pareto")


@dataclass(frozen=True)
class TrafficPattern:
    """One tenant's offered-load model.

    * ``arrival="poisson"`` draws exponential interarrivals (rate
      ``rate_rps``); ``"pareto"`` draws Lomax/Pareto-II interarrivals
      with shape ``pareto_alpha`` scaled to the same mean rate — the
      heavy tail produces the bursts that exercise shedding.
    * Request sizes are geometric with mean ``size_mean`` clipped to
      ``size_max`` — ragged (rarely multiples of 32), so slot/word
      sharing is always in play.
    * ``deadline_s`` ± ``deadline_jitter`` (uniform fraction) per
      request; ``priority_mix`` is ``((Priority, weight), ...)``.
    """

    tenant: str
    rate_rps: float = 100.0
    arrival: str = "poisson"
    pareto_alpha: float = 1.5
    n_requests: int = 100
    size_mean: float = 24.0
    size_max: int = 256
    deadline_s: float = 0.25
    deadline_jitter: float = 0.0
    priority_mix: tuple = ((Priority.NORMAL, 1.0),)

    def __post_init__(self):
        if self.arrival not in _ARRIVALS:
            raise ValueError(f"arrival must be one of {_ARRIVALS}, "
                             f"got {self.arrival!r}")
        if self.pareto_alpha <= 1.0:
            raise ValueError("pareto_alpha must be > 1 (finite mean)")
        if self.rate_rps <= 0 or self.n_requests < 1:
            raise ValueError("rate_rps must be > 0 and n_requests >= 1")


@dataclass(frozen=True)
class TrafficRequest:
    """One scheduled arrival of a trace."""

    t: float                        # arrival offset from trace start (s)
    tenant: str
    n_samples: int
    deadline_s: float
    priority: Priority


def interarrivals(pattern: TrafficPattern, n: int,
                  rng: np.random.Generator) -> np.ndarray:
    """``n`` interarrival gaps (seconds) for ``pattern``'s process."""
    mean = 1.0 / pattern.rate_rps
    if pattern.arrival == "poisson":
        return rng.exponential(mean, n)
    # Lomax (Pareto II): mean = scale / (alpha - 1); scale chosen so the
    # heavy-tail process offers the same long-run rate as the Poisson one
    a = pattern.pareto_alpha
    return rng.pareto(a, n) * (mean * (a - 1.0))


def build_trace(patterns: list[TrafficPattern],
                seed: int = 0) -> list[TrafficRequest]:
    """Merge per-tenant arrival streams into one time-sorted trace.

    Deterministic in ``(patterns, seed)``: each pattern gets its own
    child seed, so adding a tenant never perturbs another's stream.
    """
    rng = np.random.default_rng(seed)
    trace: list[TrafficRequest] = []
    for pat, child in zip(patterns, rng.spawn(len(patterns))):
        t = np.cumsum(interarrivals(pat, pat.n_requests, child))
        sizes = np.minimum(child.geometric(1.0 / max(1.0, pat.size_mean),
                                           pat.n_requests), pat.size_max)
        prios = [p for p, _ in pat.priority_mix]
        weights = np.asarray([w for _, w in pat.priority_mix], float)
        picks = child.choice(len(prios), pat.n_requests,
                             p=weights / weights.sum())
        jit = child.uniform(-pat.deadline_jitter, pat.deadline_jitter,
                            pat.n_requests) if pat.deadline_jitter else \
            np.zeros(pat.n_requests)
        trace.extend(
            TrafficRequest(t=float(t[i]), tenant=pat.tenant,
                           n_samples=int(sizes[i]),
                           deadline_s=float(pat.deadline_s * (1.0 + jit[i])),
                           priority=prios[int(picks[i])])
            for i in range(pat.n_requests))
    return sorted(trace, key=lambda r: (r.t, r.tenant))


@dataclass
class TrafficReport:
    """Outcome of one closed-loop trace run (the ``serve.traffic.*``
    row source).  ``deadline-miss`` counts admitted requests that
    failed their deadline either way — completed late or expired before
    dispatch; ``shed`` counts every :class:`RequestRejected`; goodput
    counts only samples completed in-deadline."""

    offered: int = 0
    completed: int = 0
    shed: int = 0
    deadline_missed: int = 0            # late completions + queue expiries
    goodput_samples: int = 0
    elapsed_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    shed_by_code: dict = field(default_factory=dict)
    per_tenant: dict = field(default_factory=dict)

    def _pct(self, q: float) -> float | None:
        if not self.latencies_s:
            return None
        return float(np.percentile(np.asarray(self.latencies_s), q))

    @property
    def p50_ms(self) -> float | None:
        p = self._pct(50)
        return None if p is None else p * 1e3

    @property
    def p99_ms(self) -> float | None:
        p = self._pct(99)
        return None if p is None else p * 1e3

    @property
    def shed_rate(self) -> float:
        return self.shed / max(1, self.offered)

    @property
    def deadline_miss_rate(self) -> float:
        return self.deadline_missed / max(1, self.offered)

    @property
    def goodput_sps(self) -> float:
        return self.goodput_samples / max(1e-9, self.elapsed_s)

    def to_dict(self) -> dict:
        return {
            "offered": self.offered, "completed": self.completed,
            "shed": self.shed, "shed_by_code": dict(self.shed_by_code),
            "shed_rate": round(self.shed_rate, 4),
            "deadline_missed": self.deadline_missed,
            "deadline_miss_rate": round(self.deadline_miss_rate, 4),
            "goodput_samples_per_s": round(self.goodput_sps, 1),
            "p50_ms": None if self.p50_ms is None else round(self.p50_ms, 3),
            "p99_ms": None if self.p99_ms is None else round(self.p99_ms, 3),
            "elapsed_s": round(self.elapsed_s, 4),
            "per_tenant": dict(self.per_tenant),
        }


async def run_trace(door: FrontDoor, trace: list[TrafficRequest], *,
                    seed: int = 0, time_scale: float = 1.0
                    ) -> TrafficReport:
    """Drive ``door`` with ``trace`` closed-loop and report.

    Arrivals are scheduled at ``trace[i].t * time_scale`` on the wall
    clock; request payloads are seeded random bits per tenant.  The
    front door must already have every tenant in the trace registered.
    """
    rng = np.random.default_rng(seed)
    report = TrafficReport()
    lock = asyncio.Lock()               # report mutation is awaited-only
    n_inputs = {name: t.graph.n_inputs for name, t in door.tenants.items()}

    async def issue(req: TrafficRequest, bits: np.ndarray) -> None:
        t0 = time.monotonic()
        try:
            out = await door.submit(req.tenant, bits,
                                    deadline_s=req.deadline_s,
                                    priority=req.priority)
            latency = time.monotonic() - t0
            async with lock:
                report.completed += 1
                report.latencies_s.append(latency)
                tenant = report.per_tenant.setdefault(
                    req.tenant, {"completed": 0, "shed": 0})
                tenant["completed"] += 1
                if latency > req.deadline_s:
                    report.deadline_missed += 1
                else:
                    report.goodput_samples += int(out.shape[0])
        except RequestRejected as exc:
            async with lock:
                report.shed += 1
                code = exc.reason.code
                report.shed_by_code[code] = \
                    report.shed_by_code.get(code, 0) + 1
                if code == "deadline_expired":
                    report.deadline_missed += 1
                tenant = report.per_tenant.setdefault(
                    req.tenant, {"completed": 0, "shed": 0})
                tenant["shed"] += 1

    await door.start()
    start = time.monotonic()
    tasks = []
    for req in trace:
        delay = start + req.t * time_scale - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        bits = rng.integers(0, 2, (req.n_samples,
                                   n_inputs[req.tenant])).astype(bool)
        report.offered += 1
        tasks.append(asyncio.create_task(issue(req, bits)))
    await asyncio.gather(*tasks)
    report.elapsed_s = time.monotonic() - start
    return report


def run_trace_sync(door: FrontDoor, trace: list[TrafficRequest], *,
                   seed: int = 0, time_scale: float = 1.0) -> TrafficReport:
    """Synchronous convenience wrapper (one fresh event loop)."""
    async def go():
        async with door:
            return await run_trace(door, trace, seed=seed,
                                   time_scale=time_scale)
    return asyncio.run(go())
