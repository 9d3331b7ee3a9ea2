# Copied from src/repro/serve/frontdoor.py; only the repro imports and the
# engine's device (its construction and the stepping thread's scope)
# differ.
"""Async serving front door over :class:`~repro.serve.LogicEngine`.

``LogicEngine``/``SlotTable`` are a library API: callers submit, step,
and claim, and nothing enforces deadlines, sheds load, isolates tenants,
or survives a mid-request eviction/recompile storm.  This module is the
production front door (DESIGN.md §9) that turns the compiled-logic
artifact into a *service whose failure behavior is specified*:

admission (``submit``)
    Every request carries a **deadline** and a **priority class**.
    Admission is synchronous and can reject immediately with a
    machine-readable :class:`ShedReason`: the bounded queue is full
    (``queue_full`` — unless a strictly lower-priority victim can be
    displaced, ``displaced``), or the projected wait — queued + inflight
    samples over the engine's measured wave throughput — already
    exceeds the deadline (``deadline_infeasible``).  Shedding at the
    door, before any work is queued, is what keeps the p99 of *admitted*
    requests bounded under overload.

dispatch (the one async loop)
    Queued tickets are popped highest-priority-first, round-robin
    across tenants within a class (no tenant starves another), capped
    per tenant by ``max_inflight``.  **Expired work is dropped before
    dispatch, not after**: a ticket whose deadline passed while queued
    is rejected (``deadline_expired``) without touching the engine.
    Dispatched tickets enter the engine's slot/word batching; the
    engine steps in a thread-pool executor so the event loop keeps
    admitting while the fabric runs.

faults and retries
    Recoverable faults — a program LRU-evicted mid-flight, a transient
    compile failure (:class:`~repro.core.errors.TransientCompileError`)
    — are retried with bounded exponential backoff; permanent compile
    failures shed with ``compile_failed``; exhausted retries with
    ``retries_exhausted``.  :class:`FaultPolicy` injects all three
    fault kinds (drop / delay / fail-compile / evict) with seeded
    determinism so every degradation path is testable, not accidental.

tenancy
    Many ``CompileSpec``-keyed models share one engine + one
    :class:`~repro.serve.ProgramCache` (thread-safe since this PR).
    Results route by engine uid, so a tenant can never observe another
    tenant's bits; fairness is round-robin at dispatch, isolation is
    the per-tenant inflight cap.

The closed-loop traffic generator that drives this under Poisson /
heavy-tail arrivals lives in :mod:`repro.serve.traffic`.
"""
from __future__ import annotations

import asyncio
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

from repro_torch.core.artifact_store import ArtifactStore
from repro_torch.core.errors import TransientCompileError, is_transient
from repro_torch.core.gate_ir import LogicGraph
from repro_torch.core.spec import CompileSpec
from repro_torch.serve.logic_engine import (LogicEngine, current_stream,
                                            device_scope)


class Priority(IntEnum):
    """Admission priority classes (lower value = served first)."""

    HIGH = 0
    NORMAL = 1
    BATCH = 2


#: every rejection's ``ShedReason.code`` is one of these (the
#: machine-readable contract: clients and tests switch on the code,
#: never on message text)
SHED_CODES = (
    "queue_full",           # bounded admission queue at capacity
    "deadline_infeasible",  # projected wait already exceeds the deadline
    "deadline_expired",     # expired while queued/retrying: dropped pre-dispatch
    "displaced",            # evicted from the queue by a higher-priority arrival
    "injected_drop",        # FaultPolicy dropped it at dispatch
    "compile_failed",       # permanent compile failure (errors.py taxonomy)
    "retries_exhausted",    # transient faults outlived the retry budget
    "shutdown",             # front door stopped without draining
)


@dataclass(frozen=True)
class ShedReason:
    """Why a request was rejected — machine-readable, code-first."""

    code: str                           # one of SHED_CODES
    tenant: str = ""
    detail: str = ""
    projected_wait_s: float | None = None

    def __post_init__(self):
        if self.code not in SHED_CODES:
            raise ValueError(f"unknown shed code {self.code!r}")

    def to_dict(self) -> dict:
        d = {"code": self.code, "tenant": self.tenant}
        if self.detail:
            d["detail"] = self.detail
        if self.projected_wait_s is not None:
            d["projected_wait_s"] = round(self.projected_wait_s, 6)
        return d


class RequestRejected(RuntimeError):
    """Raised to the submitter when the front door sheds a request."""

    def __init__(self, reason: ShedReason):
        super().__init__(f"request shed: {reason.to_dict()}")
        self.reason = reason


@dataclass
class FaultPolicy:
    """Seeded-deterministic fault injection for the front door.

    Rates are per-decision probabilities drawn from one
    ``numpy.random.default_rng(seed)`` stream, so a given (policy,
    traffic) pair replays the exact same fault schedule.  Fault kinds:

    * ``drop_rate`` — drop the request at dispatch (client sees an
      ``injected_drop`` rejection; models a lossy ingress hop).
    * ``delay_rate`` / ``delay_s`` — stall dispatch by ``delay_s``
      (models a slow ingress hop; inflates latency and can push a
      request over its deadline — the graceful-degradation path).
    * ``compile_fail_rate`` / ``compile_fail_first`` — raise
      :class:`TransientCompileError` from the compiler's fault hook on
      an admission-time cache-miss compile (``compile_fail_first`` N
      fails the first N compiles deterministically; the rate draws
      after that).  Exercises retry-with-backoff.
    * ``evict_rate`` — before an engine wave, LRU-evict one program
      cache entry (an eviction storm); the engine's mid-flight
      recompile path must absorb it.
    """

    seed: int = 0
    drop_rate: float = 0.0
    delay_rate: float = 0.0
    delay_s: float = 0.002
    compile_fail_rate: float = 0.0
    compile_fail_first: int = 0
    evict_rate: float = 0.0

    injected: dict = field(default_factory=lambda: {
        "drop": 0, "delay": 0, "compile_fail": 0, "evict": 0})

    def __post_init__(self):
        for name in ("drop_rate", "delay_rate", "compile_fail_rate",
                     "evict_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        self._rng = np.random.default_rng(self.seed)
        self._compile_calls = 0

    def _draw(self, rate: float, kind: str) -> bool:
        hit = rate > 0.0 and float(self._rng.random()) < rate
        if hit:
            self.injected[kind] += 1
        return hit

    def take_drop(self) -> bool:
        return self._draw(self.drop_rate, "drop")

    def take_delay(self) -> float:
        """Injected dispatch delay in seconds (0.0 = none)."""
        return self.delay_s if self._draw(self.delay_rate, "delay") else 0.0

    def take_compile_fail(self) -> bool:
        self._compile_calls += 1
        if self._compile_calls <= self.compile_fail_first:
            self.injected["compile_fail"] += 1
            return True
        return self._draw(self.compile_fail_rate, "compile_fail")

    def take_evict(self) -> bool:
        return self._draw(self.evict_rate, "evict")


@dataclass
class Tenant:
    """One registered model sharing the front door's engine + cache."""

    name: str
    graph: LogicGraph
    max_inflight: int | None = None
    inflight: int = 0                  # dispatched, not yet finished
    submitted: int = 0
    completed: int = 0
    shed: int = 0


@dataclass
class _Ticket:
    """One admitted request waiting for dispatch / completion."""

    tenant: Tenant
    bits: np.ndarray
    priority: Priority
    arrival_t: float
    deadline: float                    # absolute, on the front door clock
    future: asyncio.Future
    attempts: int = 0                  # dispatch attempts so far

    @property
    def n_samples(self) -> int:
        return int(self.bits.shape[0])


class FrontDoor:
    """Async admission layer over one shared :class:`LogicEngine`.

    Args:
      engine: the engine to front (one is built from ``spec`` /
        ``capacity`` when omitted).  The engine's ``ProgramCache`` is
        shared by every tenant; per-engine runner keying plus uid-routed
        results keep tenants isolated.
      spec / capacity / store / device: engine construction knobs when
        ``engine`` is omitted (``device``: where it runs, CUDA unless
        ``"cpu"``; ``store`` warm-starts the door's ProgramCache from a
        shared artifact-store directory — a fresh front-door process
        serves its first request with zero compiles when the store was
        precompiled, e.g. by ``tools/precompile.py``).
      max_queue: bound on queued (admitted, undispatched) requests
        across all tenants — beyond it arrivals shed ``queue_full``
        unless they can displace a strictly lower-priority victim.
      default_deadline_s: deadline for submits that don't carry one.
      max_retries: dispatch attempts per request beyond the first for
        transient faults; exhausted -> ``retries_exhausted``.
      backoff_s / backoff_cap_s: exponential retry backoff
        ``min(cap, backoff * 2**(attempt-1))``.
      fault_policy: optional :class:`FaultPolicy`; installs the
        compiler fault hook when compile faults are configured.
      dispatch_batch: max tickets dispatched per loop round (bounds the
        per-round admission latency under a flood).
    """

    def __init__(self, engine: LogicEngine | None = None, *,
                 spec: CompileSpec | None = None, capacity: int = 256,
                 store: ArtifactStore | None = None,
                 max_queue: int = 64, default_deadline_s: float = 1.0,
                 max_retries: int = 3, backoff_s: float = 0.002,
                 backoff_cap_s: float = 0.05,
                 fault_policy: FaultPolicy | None = None,
                 dispatch_batch: int = 16, device=None):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if engine is not None and store is not None:
            raise ValueError(
                "store backs the door-owned engine; attach an "
                "ArtifactStore to the shared engine's ProgramCache at its "
                "own construction instead")
        self.engine = engine if engine is not None else \
            LogicEngine(spec, capacity=capacity, store=store, device=device)
        # the executor thread that steps the engine takes this device and
        # the constructing thread's stream on it (see _step)
        self._stream = current_stream(self.engine.device)
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.dispatch_batch = dispatch_batch
        self.fault_policy = fault_policy
        self._clock = time.monotonic
        if fault_policy is not None and (fault_policy.compile_fail_rate > 0
                                         or fault_policy.compile_fail_first):
            self.engine.cache.compiler.fault_hook = self._compile_fault_hook
        # injected compile failures arm only around admission-time
        # dispatch: the engine's mid-wave recompile (eviction recovery)
        # stays fault-free so every admitted request keeps making
        # progress — DESIGN.md §9 fault taxonomy.
        self._compile_faults_armed = False

        self._tenants: dict[str, Tenant] = {}
        # priority tier -> tenant name -> FIFO of tickets; dispatch
        # walks tiers in order and round-robins tenants within a tier
        self._queues: dict[Priority, OrderedDict[str, deque[_Ticket]]] = {
            p: OrderedDict() for p in Priority}
        self._rr: dict[Priority, int] = {p: 0 for p in Priority}
        self._n_queued = 0
        self._queued_samples = 0
        self._inflight: dict[int, _Ticket] = {}     # engine uid -> ticket
        self._inflight_samples = 0
        self._retry_tasks: set[asyncio.Task] = set()

        self._task: asyncio.Task | None = None
        self._wake: asyncio.Event | None = None
        self._stopping = False

        # service-rate estimate: median of the last 16 engine-wave
        # wall-clocks.  Median, not EWMA: cold-compile and
        # eviction-recompile waves are huge outliers, and an estimate
        # they inflate would shed EVERYTHING as deadline_infeasible —
        # the opposite of graceful degradation.
        self._wave_times: deque[float] = deque(maxlen=16)

        # metrics
        self.offered = 0
        self.admitted = 0
        self.completed = 0
        self.retries = 0
        self.deadline_misses = 0        # admitted but finished late
        self.goodput_samples = 0        # samples completed in-deadline
        self.shed_by_code: dict[str, int] = {}
        self._latencies: list[float] = []

    # -- tenancy -------------------------------------------------------------

    def register(self, name: str, graph: LogicGraph, *,
                 max_inflight: int | None = None) -> Tenant:
        """Register a tenant model.  Compilation is lazy (first
        dispatch compiles through the shared cache), so registration is
        cheap and a registration-time fault cannot exist."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        tenant = Tenant(name=name, graph=graph, max_inflight=max_inflight)
        self._tenants[name] = tenant
        for tier in self._queues.values():
            tier[name] = deque()
        return tenant

    @property
    def tenants(self) -> dict[str, Tenant]:
        return dict(self._tenants)

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        if self._task is not None:
            return
        self._wake = asyncio.Event()
        self._stopping = False
        self._task = asyncio.create_task(self._run())

    async def stop(self, drain: bool = True) -> None:
        """Stop the dispatch loop.  ``drain=True`` serves everything
        already admitted first; ``drain=False`` sheds queued tickets
        with ``shutdown`` (inflight engine work still completes)."""
        if self._task is None:
            return
        if not drain:
            for tier in self._queues.values():
                for name, q in tier.items():
                    while q:
                        self._reject(q.popleft(), "shutdown", queued=True)
        self._stopping = True
        self._wake.set()
        await self._task
        self._task = None
        for t in list(self._retry_tasks):
            t.cancel()

    async def __aenter__(self) -> "FrontDoor":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=not any(exc))

    # -- admission -----------------------------------------------------------

    async def submit(self, tenant: str, bits: np.ndarray, *,
                     deadline_s: float | None = None,
                     priority: Priority = Priority.NORMAL) -> np.ndarray:
        """Admit one request and await its ``(n, n_outputs)`` result.

        Raises :class:`RequestRejected` (with a machine-readable
        ``.reason``) when shed — at admission, pre-dispatch expiry, or
        fault handling; raises ``KeyError`` for an unknown tenant and
        ``ValueError`` for a shape mismatch (caller bugs, not load)."""
        ten = self._tenants[tenant]
        bits = np.asarray(bits, dtype=bool)
        if bits.ndim != 2 or bits.shape[1] != ten.graph.n_inputs:
            raise ValueError(f"tenant {tenant!r} inputs must be "
                             f"(n, {ten.graph.n_inputs}), got {bits.shape}")
        if bits.shape[0] == 0:          # trivially complete: no admission
            return np.zeros((0, ten.graph.n_outputs), dtype=bool)
        if self._task is None:
            await self.start()          # lazy start on first submit
        now = self._clock()
        rel_deadline = (self.default_deadline_s if deadline_s is None
                        else deadline_s)
        self.offered += 1
        ten.submitted += 1
        reason = self._admission_check(ten, bits.shape[0], rel_deadline,
                                       priority)
        if reason is not None:
            ten.shed += 1
            self.shed_by_code[reason.code] = \
                self.shed_by_code.get(reason.code, 0) + 1
            raise RequestRejected(reason)
        ticket = _Ticket(tenant=ten, bits=bits, priority=priority,
                         arrival_t=now, deadline=now + rel_deadline,
                         future=asyncio.get_running_loop().create_future())
        self.admitted += 1
        self._enqueue(ticket)
        return await ticket.future

    def _admission_check(self, tenant: Tenant, n_samples: int,
                         rel_deadline: float, priority: Priority
                         ) -> ShedReason | None:
        """None = admit; a ShedReason = reject at the door."""
        wait = self.projected_wait_s(n_samples)
        if wait is not None and wait > rel_deadline:
            return ShedReason("deadline_infeasible", tenant=tenant.name,
                              projected_wait_s=wait,
                              detail=f"deadline_s={rel_deadline:.4f}")
        if self._n_queued >= self.max_queue:
            if self._displace(priority):
                return None
            return ShedReason("queue_full", tenant=tenant.name,
                              detail=f"max_queue={self.max_queue}")
        return None

    @property
    def wave_s(self) -> float | None:
        """Robust engine-wave service-time estimate (median of the last
        16 waves); ``None`` until a wave has been measured."""
        if not self._wave_times:
            return None
        return float(np.median(np.asarray(self._wave_times)))

    def projected_wait_s(self, n_samples: int = 0) -> float | None:
        """Estimated queueing delay for a new ``n_samples``-sample
        request: backlog (queued + inflight + this request) in engine
        waves times the measured wave time.  ``None`` until the first
        wave has been measured (admission then skips the feasibility
        check rather than guessing)."""
        wave = self.wave_s
        if wave is None:
            return None
        backlog = self._queued_samples + self._inflight_samples + n_samples
        waves = -(-backlog // self.engine.capacity)
        return waves * wave

    def _displace(self, priority: Priority) -> bool:
        """Evict the most recent, lowest-priority queued ticket that is
        STRICTLY lower-priority than the arrival; False when none is."""
        for tier_prio in sorted(Priority, reverse=True):
            if tier_prio <= priority:
                return False
            tier = self._queues[tier_prio]
            for name in reversed(list(tier.keys())):
                if tier[name]:
                    victim = tier[name].pop()
                    self._n_queued -= 1
                    self._queued_samples -= victim.n_samples
                    self._reject(victim, "displaced", queued=False,
                                 detail=f"by_priority={priority.name}")
                    return True
        return False

    def _enqueue(self, ticket: _Ticket, *, front: bool = False) -> None:
        q = self._queues[ticket.priority][ticket.tenant.name]
        (q.appendleft if front else q.append)(ticket)
        self._n_queued += 1
        self._queued_samples += ticket.n_samples
        if self._wake is not None:
            self._wake.set()

    # -- rejection / completion bookkeeping ----------------------------------

    def _reject(self, ticket: _Ticket, code: str, *, queued: bool = False,
                detail: str = "") -> None:
        """Reject an already-admitted ticket (post-admission shed)."""
        if queued:      # caller did not already fix the queue counters
            self._n_queued -= 1
            self._queued_samples -= ticket.n_samples
        reason = ShedReason(code, tenant=ticket.tenant.name, detail=detail)
        ticket.tenant.shed += 1
        self.shed_by_code[code] = self.shed_by_code.get(code, 0) + 1
        if code == "deadline_expired":
            self.deadline_misses += 1
        if not ticket.future.done():
            ticket.future.set_exception(RequestRejected(reason))

    def _complete(self, ticket: _Ticket, result: np.ndarray) -> None:
        now = self._clock()
        latency = now - ticket.arrival_t
        self._latencies.append(latency)
        self.completed += 1
        ticket.tenant.completed += 1
        if now > ticket.deadline:
            self.deadline_misses += 1
        else:
            self.goodput_samples += ticket.n_samples
        if not ticket.future.done():
            ticket.future.set_result(result)

    # -- the dispatch loop ---------------------------------------------------

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            batch = self._pop_batch(self._clock())
            for ticket in batch:
                await self._dispatch(ticket)
            if self._inflight:
                finished = await loop.run_in_executor(None, self._step)
                self._route(finished)
                continue
            if batch:
                continue
            if self._stopping and not self._n_queued and not self._inflight \
                    and not self._retry_tasks:
                return
            try:        # idle: sleep until new work or a 5 ms deadline tick
                await asyncio.wait_for(self._wake.wait(), timeout=0.005)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()

    def _pop_batch(self, now: float) -> list[_Ticket]:
        """Highest-priority-first, round-robin across tenants within a
        tier, per-tenant inflight caps respected, expired tickets
        dropped before dispatch."""
        out: list[_Ticket] = []
        budget = self.dispatch_batch
        for prio in Priority:
            tier = self._queues[prio]
            names = list(tier.keys())
            if not names or budget <= 0:
                continue
            start = self._rr[prio] % len(names)
            stalled = 0                 # tenants in a row with nothing to give
            i = start
            while budget > 0 and stalled < len(names):
                name = names[i % len(names)]
                i += 1
                q = tier[name]
                # deadline check BEFORE dispatch: expired work never
                # reaches the engine
                while q and q[0].deadline < now:
                    t = q.popleft()
                    self._n_queued -= 1
                    self._queued_samples -= t.n_samples
                    self._reject(t, "deadline_expired")
                ten = self._tenants[name]
                if not q or (ten.max_inflight is not None
                             and ten.inflight >= ten.max_inflight):
                    stalled += 1
                    continue
                stalled = 0
                t = q.popleft()
                self._n_queued -= 1
                self._queued_samples -= t.n_samples
                ten.inflight += 1       # reserved; released on finish/shed
                out.append(t)
                budget -= 1
            self._rr[prio] = i
        return out

    def _compile_fault_hook(self, graph, spec) -> None:
        pol = self.fault_policy
        if (pol is not None and self._compile_faults_armed
                and pol.take_compile_fail()):
            raise TransientCompileError(
                "injected transient compile failure "
                f"(FaultPolicy seed={pol.seed})")

    async def _dispatch(self, ticket: _Ticket) -> None:
        pol = self.fault_policy
        if pol is not None:
            if pol.take_drop():
                ticket.tenant.inflight -= 1
                self._reject(ticket, "injected_drop")
                return
            delay = pol.take_delay()
            if delay:
                await asyncio.sleep(delay)
                if ticket.deadline < self._clock():
                    ticket.tenant.inflight -= 1
                    self._reject(ticket, "deadline_expired",
                                 detail="expired during injected delay")
                    return
        try:
            self._compile_faults_armed = True
            uid = self.engine.submit(ticket.tenant.graph, ticket.bits)
        except Exception as exc:
            ticket.tenant.inflight -= 1
            if is_transient(exc):
                self._schedule_retry(ticket, exc)
            else:
                self._reject(ticket, "compile_failed", detail=repr(exc))
            return
        finally:
            self._compile_faults_armed = False
        self._inflight[uid] = ticket
        self._inflight_samples += ticket.n_samples

    def _schedule_retry(self, ticket: _Ticket, exc: Exception) -> None:
        ticket.attempts += 1
        if ticket.attempts > self.max_retries:
            self._reject(ticket, "retries_exhausted",
                         detail=f"attempts={ticket.attempts} last={exc!r}")
            return
        self.retries += 1
        backoff = min(self.backoff_cap_s,
                      self.backoff_s * 2 ** (ticket.attempts - 1))

        async def requeue():
            await asyncio.sleep(backoff)
            if ticket.deadline < self._clock():
                self._reject(ticket, "deadline_expired",
                             detail="expired during retry backoff")
            else:       # retries re-enter at the FRONT: age beats arrival
                self._enqueue(ticket, front=True)

        task = asyncio.create_task(requeue())
        self._retry_tasks.add(task)
        task.add_done_callback(self._retry_tasks.discard)

    def _step(self) -> list[int]:
        """One engine wave in the executor thread; measures wave time
        for the admission-control throughput estimate and applies the
        eviction-storm fault."""
        pol = self.fault_policy
        if pol is not None and pol.take_evict():
            self.engine.cache.evict()   # LRU storm; step() recompiles
        t0 = self._clock()
        with device_scope(self.engine.device, self._stream):
            finished = self.engine.step()
        self._wave_times.append(self._clock() - t0)
        return finished

    def _route(self, finished: list[int]) -> None:
        for uid in finished:
            ticket = self._inflight.pop(uid, None)
            if ticket is None:          # engine-level submitter wasn't us
                continue
            result = self.engine.result(uid)
            ticket.tenant.inflight -= 1
            self._inflight_samples -= ticket.n_samples
            self._complete(ticket, result)

    # -- metrics -------------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return self._n_queued

    def reset_metrics(self) -> None:
        """Zero the request counters and latency window (e.g. after the
        compile/jit warmup waves), so steady-state measurements aren't
        polluted by cold starts.  The wave-time window, tenant registry,
        and engine/cache state stay — they ARE the warm state."""
        self.offered = self.admitted = self.completed = 0
        self.retries = self.deadline_misses = self.goodput_samples = 0
        self.shed_by_code = {}
        self._latencies = []
        for t in self._tenants.values():
            t.submitted = t.completed = t.shed = 0

    def metrics(self) -> dict:
        lat = np.asarray(self._latencies, dtype=float)
        shed = int(sum(self.shed_by_code.values()))
        return {
            "offered": self.offered,
            "admitted": self.admitted,
            "completed": self.completed,
            "shed": shed,
            "shed_by_code": dict(self.shed_by_code),
            "shed_rate": shed / max(1, self.offered),
            "deadline_misses": self.deadline_misses,
            "deadline_miss_rate": self.deadline_misses / max(1, self.offered),
            "retries": self.retries,
            "goodput_samples": self.goodput_samples,
            "latency_p50_ms": (float(np.percentile(lat, 50)) * 1e3
                               if lat.size else None),
            "latency_p99_ms": (float(np.percentile(lat, 99)) * 1e3
                               if lat.size else None),
            "wave_est_ms": (None if self.wave_s is None
                            else self.wave_s * 1e3),
            "faults_injected": (dict(self.fault_policy.injected)
                                if self.fault_policy else {}),
            "tenants": {n: {"submitted": t.submitted,
                            "completed": t.completed, "shed": t.shed,
                            "inflight": t.inflight}
                        for n, t in self._tenants.items()},
            "engine": self.engine.stats(),
        }
