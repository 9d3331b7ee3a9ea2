"""The port's serving front door and traffic generator against the
reference's, on the CPU.

One counterpart of each test in ``tests/test_frontdoor.py``: the same
admission, deadline, shedding, fault, tenancy and traffic semantics, run
through ``repro_torch.serve`` with ``device="cpu"``.  Where a test checks
served bits, it holds them against the reference ``FrontDoor``'s result
for the same graph and bits (Pallas in interpret mode) as well as against
the graph's own evaluation; the bits are words, so no tolerance applies.
Fault rates are 0 or 1 or drawn from fixed seeds, and deadlines are
generous, so no test here depends on how fast this host runs, but one: the
reference's 2x test, whose latency bound reads the wall clock here as the
reference's own test does.
"""
import asyncio
import os
import threading

import numpy as np
import pytest

from repro.core.gate_ir import LogicGraph as RefGraph
from repro.core.spec import CompileSpec as RefSpec
from repro.serve import FrontDoor as RefFrontDoor
from repro.serve import TrafficPattern as RefPattern
from repro.serve import build_trace as ref_build_trace
from repro.serve.traffic import interarrivals as ref_interarrivals
from repro_torch.core.errors import (PermanentCompileError,
                                     TransientCompileError, is_transient)
from repro_torch.core.gate_ir import random_graph
from repro_torch.core.spec import CompileSpec
from repro_torch.serve import (FaultPolicy, FrontDoor, LogicEngine, Priority,
                               ProgramCache, RequestRejected, SHED_CODES,
                               SlotTable, TrafficPattern, build_trace,
                               run_trace)
from repro_torch.serve.traffic import interarrivals

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:           # tier-1 containers may lack hypothesis
    HAVE_HYPOTHESIS = False

STRESS = os.environ.get("REPRO_FRONTDOOR_STRESS") == "1"


def _graph(rng, n_in=12, n_gates=200, n_out=8):
    return random_graph(rng, n_in, n_gates, n_out, locality=48)


def _door(**kw):
    kw.setdefault("spec", CompileSpec(n_unit=16))
    kw.setdefault("capacity", 64)
    kw.setdefault("default_deadline_s", 10.0)
    kw.setdefault("device", "cpu")
    return FrontDoor(**kw)


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=90))


def _ref_served(graphs: dict, requests: list) -> list:
    """The reference FrontDoor's results for ``requests``, a list of
    ``(tenant, bits)`` against ``graphs`` (tenant -> port graph, rebuilt
    gate for gate as a reference graph), all submitted at once."""
    async def go():
        door = RefFrontDoor(spec=RefSpec(n_unit=16), capacity=64,
                            max_queue=max(1, len(requests)),
                            default_deadline_s=60.0)
        for name, g in graphs.items():
            door.register(name, RefGraph(n_inputs=g.n_inputs,
                                         gates=list(g.gates),
                                         outputs=list(g.outputs),
                                         name=g.name))
        async with door:
            return await asyncio.gather(
                *(door.submit(name, bits) for name, bits in requests))
    return _run(go())


def _assert_as_reference(graphs: dict, served: list) -> None:
    """``served`` is a list of ``(tenant, bits, out)`` from the port's
    door: each ``out`` equals the reference door's and the tenant's own
    graph's bits, never another tenant's."""
    want = _ref_served(graphs, [(name, bits) for name, bits, _ in served])
    for (name, bits, out), ref in zip(served, want):
        assert out.shape == ref.shape == (bits.shape[0],
                                          graphs[name].n_outputs)
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, graphs[name].evaluate(bits))


async def _warm(door, tenants, rng, waves=4):
    """Compile + wave-window warmup per tenant."""
    for _ in range(waves):
        for name, g in tenants:
            bits = rng.integers(0, 2, (16, g.n_inputs)).astype(bool)
            out = await door.submit(name, bits, deadline_s=60.0)
            assert (out == g.evaluate(bits)).all()
    door.reset_metrics()


# ---------------------------------------------------------------------------
# basic lifecycle + tenancy isolation
# ---------------------------------------------------------------------------

def test_multi_tenant_parity_and_isolation(rng):
    """Two tenants share one engine/cache; every result equals the
    reference door's for its OWN tenant, never another tenant's bits."""
    g_a, g_b = _graph(rng), _graph(rng, n_in=10, n_gates=150, n_out=6)
    graphs = {"a": g_a, "b": g_b}

    async def go():
        door = _door()
        door.register("a", g_a)
        door.register("b", g_b)
        async with door:
            reqs = []
            for i in range(12):
                name = "a" if i % 2 == 0 else "b"
                g = graphs[name]
                bits = rng.integers(0, 2, (7 + i, g.n_inputs)).astype(bool)
                reqs.append((name, bits))
            outs = await asyncio.gather(
                *(door.submit(n, bits) for n, bits in reqs))
        return door, [(n, b, o) for (n, b), o in zip(reqs, outs)]

    door, served = _run(go())
    _assert_as_reference(graphs, served)
    m = door.metrics()
    assert m["completed"] == 12 and m["shed"] == 0
    assert m["engine"]["cache_entries"] == 2    # one entry per tenant


def test_unknown_tenant_and_bad_shape_are_caller_errors(rng):
    g = _graph(rng)

    async def go():
        door = _door()
        door.register("a", g)
        async with door:
            with pytest.raises(KeyError):
                await door.submit("nope", np.zeros((2, g.n_inputs), bool))
            with pytest.raises(ValueError):
                await door.submit("a", np.zeros((2, g.n_inputs + 1), bool))
            # empty request completes trivially, no admission consumed
            out = await door.submit("a", np.zeros((0, g.n_inputs), bool))
            assert out.shape == (0, g.n_outputs)
        assert door.metrics()["offered"] == 0

    _run(go())


def test_duplicate_tenant_rejected(rng):
    door = _door()
    door.register("a", _graph(rng))
    with pytest.raises(ValueError):
        door.register("a", _graph(rng))


# ---------------------------------------------------------------------------
# shedding: bounded queue, priorities, deadlines
# ---------------------------------------------------------------------------

def test_queue_full_sheds_with_machine_readable_reason(rng):
    g = _graph(rng, n_gates=400)

    async def go():
        door = _door(max_queue=2)
        door.register("a", g)
        # don't start the loop: the queue can only fill
        payloads = [rng.integers(0, 2, (8, g.n_inputs)).astype(bool)
                    for _ in range(6)]
        tasks = [asyncio.create_task(door.submit("a", x)) for x in payloads]
        await asyncio.sleep(0)          # let admissions run
        results = await asyncio.gather(*tasks, return_exceptions=True)
        await door.stop(drain=True)
        return payloads, results

    payloads, results = _run(go())
    shed = [r for r in results if isinstance(r, RequestRejected)]
    assert shed, "overflow must shed"
    for exc in shed:
        d = exc.reason.to_dict()
        assert d["code"] in SHED_CODES
        assert d["code"] == "queue_full" and d["tenant"] == "a"
    ok = [("a", x, r) for x, r in zip(payloads, results)
          if isinstance(r, np.ndarray)]
    assert len(ok) + len(shed) == 6          # nothing hangs
    _assert_as_reference({"a": g}, ok)


def test_high_priority_displaces_batch(rng):
    g = _graph(rng)

    async def go():
        door = _door(max_queue=2)
        door.register("a", g)
        bits = rng.integers(0, 2, (4, g.n_inputs)).astype(bool)
        # all three tasks are created before the event loop runs any of
        # them, so the HIGH arrival sees a full queue of BATCH work
        batch = [asyncio.create_task(
            door.submit("a", bits, priority=Priority.BATCH))
            for _ in range(2)]
        high = asyncio.create_task(
            door.submit("a", bits, priority=Priority.HIGH))
        results = await asyncio.gather(*batch, high, return_exceptions=True)
        await door.stop(drain=True)
        return bits, results

    bits, results = _run(go())
    codes = [r.reason.code for r in results
             if isinstance(r, RequestRejected)]
    assert codes == ["displaced"], codes
    assert isinstance(results[2], np.ndarray)   # HIGH was served
    _assert_as_reference({"a": g}, [("a", bits, results[2])])


def test_expired_work_dropped_before_dispatch(rng):
    """A request whose deadline passes while queued is rejected
    pre-dispatch (deadline_expired): the engine never sees it."""
    g = _graph(rng)

    async def go():
        door = _door()
        door.register("a", g)
        bits = rng.integers(0, 2, (4, g.n_inputs)).astype(bool)
        with pytest.raises(RequestRejected) as ei:
            await door.submit("a", bits, deadline_s=0.0)
        assert ei.value.reason.code == "deadline_expired"
        assert door.engine.invocations == 0
        m = door.metrics()
        assert m["deadline_misses"] == 1 and m["completed"] == 0
        await door.stop(drain=True)

    _run(go())


def test_projected_wait_sheds_infeasible_deadlines(rng):
    g = _graph(rng)

    async def go():
        door = _door(max_queue=512, capacity=64)
        door.register("a", g)
        await _warm(door, [("a", g)], rng)
        assert door.wave_s is not None
        # a deadline far below one wave of queueing with a full backlog
        # must shed at the door, carrying the projected wait
        blocker = [asyncio.create_task(door.submit(
            "a", rng.integers(0, 2, (64, g.n_inputs)).astype(bool)))
            for _ in range(12)]
        await asyncio.sleep(0)
        with pytest.raises(RequestRejected) as ei:
            await door.submit(
                "a", rng.integers(0, 2, (64, g.n_inputs)).astype(bool),
                deadline_s=min(1e-4, door.wave_s / 10))
        reason = ei.value.reason
        assert reason.code == "deadline_infeasible"
        assert reason.projected_wait_s > 0
        assert "projected_wait_s" in reason.to_dict()
        await asyncio.gather(*blocker)
        await door.stop(drain=True)

    _run(go())


# ---------------------------------------------------------------------------
# fault injection: drop / delay / fail-compile / evict
# ---------------------------------------------------------------------------

def test_injected_drop_sheds(rng):
    g = _graph(rng)

    async def go():
        door = _door(fault_policy=FaultPolicy(seed=0, drop_rate=1.0))
        door.register("a", g)
        with pytest.raises(RequestRejected) as ei:
            await door.submit("a",
                              rng.integers(0, 2, (4, g.n_inputs))
                              .astype(bool))
        assert ei.value.reason.code == "injected_drop"
        assert door.fault_policy.injected["drop"] == 1
        await door.stop(drain=True)

    _run(go())


def test_transient_compile_failure_retried_to_success(rng):
    """compile_fail_first=2: dispatch 1 and retry 1 fail, retry 2
    compiles; the request completes, with the retry trail visible."""
    g = _graph(rng)

    async def go():
        door = _door(fault_policy=FaultPolicy(seed=0, compile_fail_first=2),
                     max_retries=3, backoff_s=0.001)
        door.register("a", g)
        bits = rng.integers(0, 2, (6, g.n_inputs)).astype(bool)
        out = await door.submit("a", bits)
        await door.stop(drain=True)
        return door, bits, out

    door, bits, out = _run(go())
    _assert_as_reference({"a": g}, [("a", bits, out)])
    m = door.metrics()
    assert m["retries"] == 2
    assert m["engine"]["cache_compile_failures"] == 2
    assert m["faults_injected"]["compile_fail"] == 2


def test_retries_exhausted_sheds_with_reason(rng):
    g = _graph(rng)

    async def go():
        door = _door(fault_policy=FaultPolicy(seed=0, compile_fail_rate=1.0),
                     max_retries=2, backoff_s=0.001)
        door.register("a", g)
        with pytest.raises(RequestRejected) as ei:
            await door.submit("a", rng.integers(0, 2, (4, g.n_inputs))
                              .astype(bool))
        assert ei.value.reason.code == "retries_exhausted"
        assert "TransientCompileError" in ei.value.reason.detail
        await door.stop(drain=True)

    _run(go())


def test_permanent_compile_failure_sheds_immediately(rng):
    """A non-retryable failure must not burn the retry budget."""
    g = _graph(rng)

    async def go():
        door = _door(max_retries=5)
        door.register("a", g)

        def hook(graph, spec):
            raise PermanentCompileError("fabric limit exceeded")
        door.engine.cache.compiler.fault_hook = hook
        door._compile_faults_armed = False   # hook fires regardless
        with pytest.raises(RequestRejected) as ei:
            await door.submit("a", rng.integers(0, 2, (4, g.n_inputs))
                              .astype(bool))
        assert ei.value.reason.code == "compile_failed"
        assert door.metrics()["retries"] == 0
        await door.stop(drain=True)

    _run(go())


def test_error_taxonomy_classification():
    assert is_transient(TransientCompileError("x"))
    assert not is_transient(PermanentCompileError("x"))
    assert not is_transient(ValueError("x"))
    assert TransientCompileError.retryable
    assert not PermanentCompileError.retryable


def test_eviction_storm_mid_flight_recovers(rng):
    """evict_rate=1: every wave is preceded by an LRU eviction, so every
    wave recompiles mid-flight; results stay bit-exact and nothing
    wedges."""
    g_a, g_b = _graph(rng), _graph(rng, n_in=10, n_gates=150, n_out=6)
    graphs = {"a": g_a, "b": g_b}

    async def go():
        door = _door(fault_policy=FaultPolicy(seed=3, evict_rate=1.0))
        door.register("a", g_a)
        door.register("b", g_b)
        served = []
        async with door:
            for i in range(4):
                for name, g in graphs.items():
                    bits = rng.integers(0, 2, (5 + i, g.n_inputs)) \
                        .astype(bool)
                    served.append((name, bits,
                                   await door.submit(name, bits)))
        return door, served

    door, served = _run(go())
    _assert_as_reference(graphs, served)
    assert door.fault_policy.injected["evict"] > 0
    assert door.engine.cache.misses > 2      # storms forced recompiles


def test_fault_policy_seeded_determinism():
    a = FaultPolicy(seed=42, drop_rate=0.3, delay_rate=0.3)
    b = FaultPolicy(seed=42, drop_rate=0.3, delay_rate=0.3)
    seq_a = [(a.take_drop(), a.take_delay()) for _ in range(50)]
    seq_b = [(b.take_drop(), b.take_delay()) for _ in range(50)]
    assert seq_a == seq_b
    assert a.injected == b.injected
    with pytest.raises(ValueError):
        FaultPolicy(drop_rate=1.5)


# ---------------------------------------------------------------------------
# fairness
# ---------------------------------------------------------------------------

def test_flooding_tenant_does_not_starve_other(rng):
    """Tenant a floods; tenant b's request still completes while a's flood
    is in flight, by round-robin dispatch and a's inflight cap."""
    g_a, g_b = _graph(rng, n_gates=300), _graph(rng, n_in=10, n_out=6)

    async def go():
        door = _door(max_queue=256, dispatch_batch=4)
        door.register("a", g_a, max_inflight=2)
        door.register("b", g_b)
        await _warm(door, [("a", g_a), ("b", g_b)], rng)
        flood = [asyncio.create_task(door.submit(
            "a", rng.integers(0, 2, (32, g_a.n_inputs)).astype(bool)))
            for _ in range(40)]
        await asyncio.sleep(0)
        bits = rng.integers(0, 2, (8, g_b.n_inputs)).astype(bool)
        out = await door.submit("b", bits)
        # b completed while most of a's flood was still queued/inflight
        pending = sum(not t.done() for t in flood)
        await asyncio.gather(*flood)
        await door.stop(drain=True)
        return bits, out, pending

    bits, out, pending = _run(go())
    assert pending > 0, \
        "flood drained before b was served: can't observe fairness"
    _assert_as_reference({"a": g_a, "b": g_b}, [("b", bits, out)])


# ---------------------------------------------------------------------------
# the integration test: degradation under overload, with faults on
# ---------------------------------------------------------------------------

def test_graceful_degradation_at_2x_load_with_faults(rng):
    """An overload with fault injection on (eviction storm + injected
    dispatch delay): the trace's arrivals reach the door at once
    (``time_scale=0``), so the bounded queue must shed; every rejection
    carries a machine-readable shed reason, zero requests hang, every
    admitted request completes with its own tenant's bits (as the
    reference door serves them), and the traffic report carries the
    serve.traffic.* counters.  The reference's latency bound at its own
    pacing is held by the next test."""
    g_a = _graph(rng, n_in=14, n_gates=250, n_out=8)
    g_b = _graph(rng, n_in=10, n_gates=180, n_out=6)
    graphs = {"a": g_a, "b": g_b}
    n = 150 if STRESS else 50

    async def go():
        fault = FaultPolicy(seed=5, evict_rate=0.2, delay_rate=0.1,
                            delay_s=0.002)
        door = FrontDoor(spec=CompileSpec(n_unit=16), capacity=128,
                         max_queue=16, default_deadline_s=30.0,
                         fault_policy=fault, device="cpu")
        door.register("a", g_a, max_inflight=8)
        door.register("b", g_b, max_inflight=8)
        await _warm(door, list(graphs.items()), rng, waves=6)
        served = []
        submit = door.submit

        async def recorded(name, bits, **kw):
            out = await submit(name, bits, **kw)
            served.append((name, bits, out))
            return out

        door.submit = recorded
        trace = build_trace([
            TrafficPattern(tenant="a", rate_rps=1000.0, n_requests=n,
                           size_mean=24, size_max=96, deadline_s=30.0),
            TrafficPattern(tenant="b", rate_rps=1000.0, n_requests=n,
                           arrival="pareto", pareto_alpha=1.5,
                           size_mean=24, size_max=96, deadline_s=30.0),
        ], seed=17)
        report = await run_trace(door, trace, seed=19, time_scale=0.0)
        await door.stop(drain=True)
        return report, door, served

    report, door, served = _run(go())

    # zero hangs: every offered request resolved one way or the other
    assert report.completed + report.shed == report.offered == 2 * n
    # every rejection machine-readable
    assert all(code in SHED_CODES for code in report.shed_by_code)
    # the serve.traffic.* counters all materialized
    d = report.to_dict()
    for key in ("p50_ms", "p99_ms", "goodput_samples_per_s", "shed_rate",
                "deadline_miss_rate"):
        assert key in d
    # overloaded: the bounded queue shed rather than queueing without
    # bound, and what it admitted completed in its deadline
    assert report.shed_by_code.get("queue_full", 0) > 0
    assert report.deadline_missed == 0
    assert len(served) == report.completed > 0
    _assert_as_reference(graphs, served)
    # degradation ran under real faults
    assert door.fault_policy.injected["evict"] > 0 or \
        door.fault_policy.injected["delay"] > 0


def test_graceful_degradation_at_2x_load_holds_the_reference_bound(rng):
    """The reference's own 2x test (``tests/test_frontdoor.py:379-447``)
    at its own parameters, run through the port on the CPU: at ~2x the
    sustainable rate, paced on the wall clock as ``run_trace`` paces it by
    default, with an eviction storm and injected dispatch delays on, the
    admitted p99 stays within 3 x the unloaded p99 + 75 ms; every
    rejection is machine-readable, nothing hangs, and every admitted
    request gets the bits the reference door serves."""
    g_a = _graph(rng, n_in=14, n_gates=250, n_out=8)
    g_b = _graph(rng, n_in=10, n_gates=180, n_out=6)
    graphs = {"a": g_a, "b": g_b}
    n = 150 if STRESS else 50

    async def go():
        fault = FaultPolicy(seed=5, evict_rate=0.2, delay_rate=0.1,
                            delay_s=0.002)
        door = FrontDoor(spec=CompileSpec(n_unit=16), capacity=128,
                         max_queue=16, default_deadline_s=0.5,
                         fault_policy=fault, device="cpu")
        door.register("a", g_a, max_inflight=8)
        door.register("b", g_b, max_inflight=8)
        tenants = list(graphs.items())
        await _warm(door, tenants, rng, waves=6)

        # unloaded p99: sequential closed-loop requests, no queueing
        for name, g in tenants * 10:
            bits = rng.integers(0, 2, (24, g.n_inputs)).astype(bool)
            out = await door.submit(name, bits, deadline_s=60.0)
            assert (out == g.evaluate(bits)).all()
        unloaded_p99 = door.metrics()["latency_p99_ms"]
        door.reset_metrics()

        wave = door.wave_s
        sustainable_rps = door.engine.capacity / max(wave, 1e-4) / 24
        rate = 2.0 * sustainable_rps / 2
        trace = build_trace([
            TrafficPattern(tenant="a", rate_rps=rate, n_requests=n,
                           size_mean=24, size_max=96, deadline_s=0.4),
            TrafficPattern(tenant="b", rate_rps=rate, n_requests=n,
                           arrival="pareto", pareto_alpha=1.5,
                           size_mean=24, size_max=96, deadline_s=0.4),
        ], seed=17)
        served = []
        submit = door.submit

        async def recorded(name, bits, **kw):
            out = await submit(name, bits, **kw)
            served.append((name, bits, out))
            return out

        door.submit = recorded
        report = await run_trace(door, trace, seed=19)
        await door.stop(drain=True)
        return unloaded_p99, report, door, served

    unloaded_p99, report, door, served = _run(go())

    assert report.completed + report.shed == report.offered == 2 * n
    assert all(code in SHED_CODES for code in report.shed_by_code)
    d = report.to_dict()
    for key in ("p50_ms", "p99_ms", "goodput_samples_per_s", "shed_rate",
                "deadline_miss_rate"):
        assert key in d
    assert report.shed > 0 or report.deadline_missed > 0
    if report.p99_ms is not None:
        bound = 3.0 * unloaded_p99 + 75.0
        assert report.p99_ms <= bound, \
            f"admitted p99 {report.p99_ms:.1f}ms > bound {bound:.1f}ms " \
            f"(unloaded {unloaded_p99:.1f}ms)"
    assert door.fault_policy.injected["evict"] > 0 or \
        door.fault_policy.injected["delay"] > 0
    assert len(served) == report.completed
    _assert_as_reference(graphs, served)


# ---------------------------------------------------------------------------
# traffic generator
# ---------------------------------------------------------------------------

def test_trace_deterministic_and_sorted():
    pats = [TrafficPattern(tenant="a", rate_rps=200, n_requests=40),
            TrafficPattern(tenant="b", rate_rps=100, n_requests=30,
                           arrival="pareto")]
    t1, t2 = build_trace(pats, seed=1), build_trace(pats, seed=1)
    assert t1 == t2
    assert t1 != build_trace(pats, seed=2)
    assert all(t1[i].t <= t1[i + 1].t for i in range(len(t1) - 1))
    assert {r.tenant for r in t1} == {"a", "b"}
    # ragged sizes: not all multiples of 32
    assert any(r.n_samples % 32 for r in t1)
    # the same seeded trace as the reference's, arrival by arrival
    ref = ref_build_trace([RefPattern(tenant="a", rate_rps=200,
                                      n_requests=40),
                           RefPattern(tenant="b", rate_rps=100,
                                      n_requests=30, arrival="pareto")],
                          seed=1)
    assert [(r.t, r.tenant, r.n_samples, r.deadline_s, int(r.priority))
            for r in t1] == \
        [(r.t, r.tenant, r.n_samples, r.deadline_s, int(r.priority))
         for r in ref]


def test_interarrival_rates_match():
    rng = np.random.default_rng(0)
    for arrival in ("poisson", "pareto"):
        pat = TrafficPattern(tenant="a", rate_rps=50.0, arrival=arrival,
                             n_requests=1)
        gaps = interarrivals(pat, 20_000, rng)
        assert gaps.min() >= 0
        # long-run rate within 10% of the configured mean
        assert abs(gaps.mean() - 0.02) < 0.002, arrival
        ref = ref_interarrivals(RefPattern(tenant="a", rate_rps=50.0,
                                           arrival=arrival, n_requests=1),
                                1000, np.random.default_rng(7))
        np.testing.assert_array_equal(
            interarrivals(pat, 1000, np.random.default_rng(7)), ref)


def test_traffic_pattern_validation():
    with pytest.raises(ValueError):
        TrafficPattern(tenant="a", arrival="bursty")
    with pytest.raises(ValueError):
        TrafficPattern(tenant="a", pareto_alpha=1.0)
    with pytest.raises(ValueError):
        TrafficPattern(tenant="a", rate_rps=0)


# ---------------------------------------------------------------------------
# ProgramCache thread-safety: concurrent engines, one cache
# ---------------------------------------------------------------------------

def test_program_cache_thread_safe_under_contention(rng):
    """Threads hammer get/evict on a shared bounded cache: no
    exceptions, no corrupted entries, and every returned artifact still
    executes its own graph bit-exactly."""
    graphs = [_graph(rng, n_gates=60 + 7 * i, n_out=5) for i in range(6)]
    oracle = {g.fingerprint(): g for g in graphs}
    cache = ProgramCache(max_entries=3)
    spec = CompileSpec(n_unit=8, optimize="none")
    errors: list[BaseException] = []
    barrier = threading.Barrier(4)

    def worker(seed: int) -> None:
        r = np.random.default_rng(seed)
        barrier.wait()
        try:
            for i in range(40):
                g = graphs[int(r.integers(len(graphs)))]
                entry = cache.get(g, spec)
                got = oracle[entry.artifact.graph.fingerprint()]
                bits = r.integers(0, 2, (4, got.n_inputs)).astype(bool)
                assert (entry.artifact.execute(bits)
                        == got.evaluate(bits)).all()
                if i % 7 == 0:
                    cache.evict()
        except BaseException as exc:     # surfaced on the main thread
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(cache) <= 3
    assert cache.stats()["entries"] == len(cache)


def test_program_cache_evict_api(rng):
    cache = ProgramCache()
    assert cache.evict() is None                    # empty: nothing to do
    g = _graph(rng, n_gates=50)
    entry = cache.get(g, CompileSpec(n_unit=8))
    assert cache.evict(("nope",)) is None           # unknown key
    assert cache.evict(entry.key) == entry.key
    assert len(cache) == 0
    cache.get(g, CompileSpec(n_unit=8))
    assert cache.evict() is not None                # LRU eviction
    assert len(cache) == 0


# ---------------------------------------------------------------------------
# SlotTable under cancellation: leak-freedom + isolation
# ---------------------------------------------------------------------------

def _slot_invariants(table: SlotTable, active: dict) -> None:
    held = [r for rows in active.values() for r in rows.tolist()]
    assert len(held) == len(set(held)), "row handed to two requests"
    assert table.n_active == len(held)
    assert table.n_active + table.n_free == table.capacity
    assert all(0 <= r < table.capacity for r in held)


def _slot_script(capacity: int, ops: list) -> None:
    """Replay (acquire n | cancel i) ops, checking invariants after every
    op: cancelling mid-wave and retiring ragged requests must never leak
    rows and never alias another request's rows."""
    table = SlotTable(capacity)
    active: dict[int, np.ndarray] = {}
    uid = 0
    for kind, arg in ops:
        if kind == "acquire":
            rows = table.acquire(arg)
            if arg > table.capacity - sum(len(v) for v in active.values()):
                assert rows is None
            if rows is not None:
                assert len(rows) == arg
                active[uid] = rows
                uid += 1
        elif active:        # cancel/retire both release; order differs
            keys = sorted(active)
            key = keys[arg % len(keys)]
            table.release(active.pop(key))
        _slot_invariants(table, active)
    for rows in active.values():        # drain: nothing leaked
        table.release(rows)
    assert table.n_free == capacity and table.n_active == 0
    full = table.acquire(capacity)      # every row really came back
    assert full is not None and len(set(full.tolist())) == capacity


def test_slot_table_cancellation_deterministic(rng):
    """Seeded fuzz (always runs): ragged acquire sizes incl. 0 and
    over-capacity, interleaved with cancellations."""
    for seed in range(5):
        r = np.random.default_rng(seed)
        ops = []
        for _ in range(120):
            if r.random() < 0.6:
                ops.append(("acquire", int(r.integers(0, 40))))
            else:
                ops.append(("cancel", int(r.integers(0, 1 << 30))))
        _slot_script(int(r.integers(1, 97)), ops)


def test_slot_table_double_release_and_range_guard():
    t = SlotTable(8)
    rows = t.acquire(4)
    t.release(rows)
    with pytest.raises(RuntimeError):
        t.release(rows)                  # cancel-after-retire must be loud
    with pytest.raises(ValueError):
        t.release(np.array([99]))


if HAVE_HYPOTHESIS:
    @settings(max_examples=60, deadline=None)
    @given(
        capacity=st.integers(min_value=1, max_value=96),
        ops=st.lists(
            st.one_of(
                st.tuples(st.just("acquire"),
                          st.integers(min_value=0, max_value=48)),
                st.tuples(st.just("cancel"),
                          st.integers(min_value=0, max_value=1 << 30))),
            max_size=200))
    def test_hypothesis_slot_table_never_leaks(capacity, ops):
        _slot_script(capacity, list(ops))


# ---------------------------------------------------------------------------
# O(1) claim path: retained-set + lazy compaction
# ---------------------------------------------------------------------------

def test_claim_bookkeeping_stays_bounded_under_churn(rng):
    """High request churn with claim-newest-first (the worst case for
    head-compaction): the finished-order deque stays within a constant
    factor of the live retained set."""
    g = _graph(rng, n_in=6, n_gates=40, n_out=4)
    eng = LogicEngine(CompileSpec(n_unit=8), capacity=32, device="cpu")
    live: list[int] = []
    for i in range(120):
        live.append(eng.submit(g, rng.integers(0, 2, (3, 6)).astype(bool)))
        eng.drain()
        if len(live) > 4:               # always claim the NEWEST first
            eng.result(live.pop())
            eng.result(live.pop())
        assert len(eng._finished_order) <= 2 * len(eng._retained) + 8
    for uid in live:
        eng.result(uid)
    assert not eng._retained and not eng._requests
    assert len(eng._finished_order) <= 8


def test_max_retained_counts_only_unclaimed_after_refactor(rng):
    """Claimed uids are stale deque entries: they must not consume
    max_retained slots nor resurrect on later retires."""
    g = _graph(rng, n_in=6, n_gates=40, n_out=4)
    eng = LogicEngine(CompileSpec(n_unit=8), capacity=32, max_retained=3,
                      device="cpu")
    uids = []
    for _ in range(3):
        uids.append(eng.submit(g, rng.integers(0, 2, (2, 6)).astype(bool)))
        eng.drain()
    eng.result(uids[1])                  # claim the middle one
    for _ in range(2):                   # two more: u0,u2 + 2 new = 4 > 3
        uids.append(eng.submit(g, rng.integers(0, 2, (2, 6)).astype(bool)))
        eng.drain()
    with pytest.raises(KeyError):
        eng.result(uids[0])              # oldest unclaimed was dropped
    with pytest.raises(KeyError):
        eng.result(uids[1])              # claimed: gone, not resurrected
    for uid in uids[2:]:
        assert eng.result(uid).shape == (2, 4)
