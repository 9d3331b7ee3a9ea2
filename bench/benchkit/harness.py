"""Run one cell: set up, warm up, measure for ``--seconds``, judge, report.

The cell's driver (``bench/drivers/<driver>.py``) builds the engine from
a :class:`Context`, warms up, and runs the window; this module owns
everything the drivers share: the set-up clock, the spans and the device
trace of a traced run, the reference's judgement after the window, the
metric readers, and the result line.
"""
from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from benchkit import judge, layout, program, readers
from benchkit.inputs import make_layers
from benchkit.spans import Spans
from benchkit.trace import DeviceTrace
from benchkit.traffic import pattern_pool

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke")
#: the device trace of a traced run: from this share of the window, for
#: at most this long (a steady part of it)
TRACE_FROM, TRACE_SECONDS = 0.4, 3.0
#: how long after the window's close an answer due in it is waited for
GRACE_S = 60.0
#: rows of the payload pool: every request's bits are a view into it
POOL_ROWS = 1 << 16


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    cell: str
    seconds: float
    traced: bool
    spans: Spans
    setup_s: float | None = None
    first_request_s: float | None = None
    window_s: float | None = None
    samples: int = 0                 # samples completed in the window
    attempted: int = 0               # requests due in the window
    failed: int = 0                  # failed or never answered
    unanswered: int = 0              # due and never answered at all
    engine: dict = field(default_factory=dict)   # window's engine counters
    shape: dict | None = None        # program.served_shape
    device_trace: object = None      # trace.TraceSummary
    checks: dict = field(default_factory=dict)   # judge.limits
    rows_checked: int = 0
    setup: dict = field(default_factory=dict)    # set-up line


class Context:
    """What a driver gets: the served graphs, the payload pool, seeded
    generators, and the window's clock and instruments."""

    def __init__(self, *, cell, root, device, graphs, layers, pool,
                 pool_idx, seed, seconds, traced, t_process, run, hook=None):
        self.cell, self.root, self.device = cell, root, device
        self.mix, self.config = cell.mix, cell.config
        self.graphs, self.layers = graphs, layers
        self.pool, self.pool_idx = pool, pool_idx
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.run = run
        self.spans = run.spans
        self.checks: list = []
        self._t_process = t_process
        self._hook = hook
        self._engine = None
        self.tracer = None
        self._trace_at = self._trace_s = None

    # -- the program ---------------------------------------------------------
    def engine(self, capacity: int):
        t = time.perf_counter()
        where = program.cache_dir(self.root, self.cell.config_name,
                                  self.cell.config_path)
        self._engine = program.engine(self.config, capacity, self.device,
                                      where)
        self.run.setup["phases"]["engine_s"] = time.perf_counter() - t
        return self._engine

    def rng(self, purpose: str) -> np.random.Generator:
        """A generator of its own for each purpose, from the run seed."""
        tag = int.from_bytes(purpose.encode()[:8].ljust(8, b"\0"), "little")
        return np.random.default_rng([self.seed, tag])

    def keep(self, off: int, n: int, out) -> None:
        """Judge this request's served bits after the window."""
        self.checks.append((int(off), int(n), out))

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    # -- set-up and window ---------------------------------------------------
    def first_request(self, seconds: float) -> None:
        self.run.first_request_s = seconds
        self._t_first = time.perf_counter()

    def warmed(self) -> None:
        """Set-up is over: instrument a traced run, apply a test's hook."""
        self.sync()
        self.run.setup["phases"]["warmup_s"] = time.perf_counter() - \
            self._t_first
        if self._hook is not None:
            self._hook(self._engine, self)
        if self.traced:
            self._instrument()

    def _instrument(self) -> None:
        eng = self._engine
        self.spans.wrap(eng, "step", "engine.step")
        self.spans.wrap(eng, "submit", "engine.submit")
        self.spans.wrap(eng, "submit_chain", "engine.submit")
        self.spans.wrap(eng, "result", "engine.result")
        for entry in program.served_entries(eng):
            for key in list(getattr(entry, "runners", {})):
                self.spans.wrap_item(entry.runners, key, "runner")
        self.spans.watch_gc()
        import torch
        self.tracer = DeviceTrace(torch, self.device)
        self.tracer.prime()

    def begin_window(self) -> float:
        t0 = time.perf_counter()
        self.run.setup_s = t0 - self._t_process
        self.spans.on = self.traced
        self._trace_at = t0 + TRACE_FROM * self.seconds
        self._trace_s = min(TRACE_SECONDS,
                            (1 - TRACE_FROM) * self.seconds / 2)
        self._engine_before = self._counters()
        return t0

    def end_window(self, t0: float, t_close: float) -> None:
        self.spans.on = False
        self.run.window_s = t_close - t0
        self.run.engine = {k: v - self._engine_before.get(k, 0)
                           for k, v in self._counters().items()}
        if self.tracer is not None and self.tracer.started and \
                self.tracer.t_stop is None:
            self.tracer.stop()

    def _counters(self) -> dict:
        stats = self._engine.stats()
        return {k: stats[k] for k in ("invocations", "samples_served")}

    def tick(self, now: float) -> None:
        """Start or stop the device trace of a traced run (the driver
        calls this between waves)."""
        tr = self.tracer
        if tr is None or tr.t_stop is not None:
            return
        if not tr.started:
            if now >= self._trace_at:
                tr.start()
        elif tr.t_start is None:
            tr.settle(now)
        elif now >= tr.t_start + self._trace_s:
            tr.stop()


def run_cell(root: Path, cell: layout.Cell, *, seed: int, seconds: float,
             traced: bool, device, t_process: float, hook=None,
             phases: dict | None = None) -> Run:
    """Set up, drive and measure one run of ``cell`` on ``device``;
    ``phases`` holds the set-up's earlier phases (seconds)."""
    run = Run(cell=cell.name, seconds=seconds, traced=traced, spans=Spans())
    phases = run.setup["phases"] = dict(phases or {})
    t = time.perf_counter()
    if device.type == "cuda":
        from repro_torch.kernels.logic_dsp import kernel as K
        K.library()
        phases["kernels_s"] = time.perf_counter() - t
        run.setup["nvcc_s"] = K.build_info.get("seconds", 0.0)
    layers = make_layers(cell.config)
    where = program.cache_dir(root, cell.config_name, cell.config_path)
    graphs, info = program.graphs(layers, where)
    phases["graphs_s"] = info["graphs_s"]
    run.setup["synthesized"] = info["synthesized"]
    run.setup["cache"] = str(where.relative_to(root))
    pool_idx = pattern_pool(len(layers[0].patterns), POOL_ROWS,
                            np.random.SeedSequence(seed).spawn(1)[0])
    pool = layers[0].patterns[pool_idx].astype(bool)
    ctx = Context(cell=cell, root=root, device=device, graphs=graphs,
                  layers=layers, pool=pool, pool_idx=pool_idx, seed=seed,
                  seconds=seconds, traced=traced, t_process=t_process,
                  run=run, hook=hook)
    layout.driver(root, cell.mix).run(ctx)
    run.setup.update(setup_s=run.setup_s,
                     first_request_s=run.first_request_s,
                     **{f"cache_{k}": v
                        for k, v in ctx._engine.cache.stats().items()})
    if device.type == "cuda":
        import torch
        run.setup["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    run.shape = program.served_shape(ctx._engine, device)
    if ctx.tracer is not None and ctx.tracer.started:
        tr = run.device_trace = ctx.tracer.summary(run.spans)
        steps = run.spans.intervals("engine.step")
        run.setup["trace"] = {
            "clock_scale": tr.clock_scale, "anchors": tr.anchors_found,
            "card": tr.card,
            "kernel_launches": readers.kernel_launches(run)[0],
            "steps": int(((steps[:, 0] >= ctx.tracer.t_start)
                          & (steps[:, 1] <= ctx.tracer.t_stop)).sum())}
    run.spans.unwrap_all()
    ctx._engine = None
    # the reference runs once the window has closed and the peak is read
    compared = judge.compare(ctx.checks, layers, pool_idx)
    run.checks = judge.limits(compared, run.unanswered)
    run.rows_checked = compared["rows_checked"]
    return run


def metrics(root: Path, cell: layout.Cell, run: Run) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer (traced),
    each from its reader; a reader that finds nothing is left out."""
    out = {}
    for m in (cell.per_layer if run.traced else cell.end_to_end):
        value = layout.metric_reader(root, m["name"])(run)
        if value is None or not math.isfinite(value):
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def loaded_forbidden() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(root: Path, cell: layout.Cell, run: Run, device) -> dict:
    checks = run.checks
    line = {"correct": judge.holds(checks), "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics(root, cell, run)}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": None, "count": cell.chips,
           "memory_peak_bytes": run.setup.get("memory_peak_bytes", 0)}
    if device.type == "cuda":
        import torch
        dev["kind"] = torch.cuda.get_device_name(device)
    if run.traced:
        tr = run.device_trace
        dev["busy_s"] = tr.busy_s if tr is not None and tr.busy_s else 0.0
        dev["window_s"] = tr.window_s if tr is not None else 0.0
    line["device"] = dev
    if run.traced and run.device_trace is not None:
        line["breakdown"] = run.device_trace.breakdown()
    line["checks"] = checks
    return line


def main(args, root: Path, t_process: float) -> int:
    t = time.perf_counter()
    import torch
    phases = {"start_s": t - t_process,
              "import_torch_s": time.perf_counter() - t}
    cell = layout.resolve_cell(root, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{have} available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    t = time.perf_counter()
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    phases["cuda_context_s"] = time.perf_counter() - t
    run = run_cell(root, cell, seed=args.seed, seconds=args.seconds,
                   traced=bool(args.trace), device=device,
                   t_process=t_process, phases=phases)
    found = loaded_forbidden()
    if found:
        print(f"the run loaded {found}: the benchmark measures repro_torch "
              "alone", file=sys.stderr)
        return 4
    print(json.dumps({"setup": run.setup}), flush=True)
    line = result_line(root, cell, run, device)
    for name, c in line["checks"].items():
        bound = f"<= {c['max']}" if "max" in c else f">= {c['min']}"
        print(f"{name} {c['value']} (limit {bound})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
