# Copied from src/repro/core/cost_model.py; only the repro imports differ.
"""Analytical compute-cycle model (paper §6.2, eqs. (2)-(23)) on TPU terms.

The paper models FFCL execution as a two-stage pipeline — (i) data movement
(DDR->URAM->BRAM: input vectors, opcodes, addresses) and (ii) compute
(BRAM->DSP regs, logic op, DSP regs->BRAM) — overlapped by double buffering:

    n_cc,opt = (m + 1) * max(n_data_moves, n_compute)            (eq. 2)

TPU mapping of each memory tier (DESIGN.md §2):

    DDR banks           -> HBM          (819 GB/s/chip)
    URAM (global)       -> VMEM staging of the program streams
    BRAM (local)        -> VMEM data buffer rows
    DSP registers       -> VREGs
    48-lane SIMD        -> 32 samples/int32 word x W words per gate-op row

All terms are returned in *cycles* of the compute fabric clock so the
paper's equations carry over verbatim; ``seconds()`` divides by the clock.
The packing factors keep the paper's names: lambda_ (addresses per bus
beat), delta (input words per beat), zeta (opcodes per beat).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TpuFabric:
    """Hardware constants for the cost model (TPU v5e, public numbers).

    peak_flops/hbm_bw/ici_bw are the roofline constants mandated for this
    project; VPU numbers are derived: 197 TFLOP/s bf16 over 4 MXUs of
    128x128x2 flops/cycle -> ~1.5 GHz core clock; the VPU issues one lane-op
    per (8,128) vreg slab per cycle.
    """

    clock_hz: float = 1.5e9
    vpu_sublanes: int = 8
    vpu_lanes: int = 128
    hbm_bw: float = 819e9           # bytes/s
    vmem_bw: float = 3.3e12         # bytes/s VMEM<->VREG (22 B/cycle/lane est)
    vmem_bytes: int = 64 * 2**20    # v5e ~128MiB/2 cores -> 64MiB/core budget
    ici_bw: float = 50e9            # bytes/s/link
    peak_flops: float = 197e12      # bf16
    dma_beat_bytes: int = 512       # HBM burst granule (paper: 512-bit AXI)
    # Fixed cost per sub-kernel step: the dependent gather->op->scatter chain
    # (VMEM load-use latency) + scalar-core loop control. This is the TPU
    # analogue of the paper's per-subkernel n_exe_logic_ops pipeline fill;
    # it is what makes FEW units expensive (many steps) and creates the
    # U-shaped latency of Fig. 6.
    step_overhead_cycles: float = 40.0
    # SIMD lanes per packed word (32 for int32 VPU words; 48 on the DSP48)
    simd_lanes: int = 32
    # per-step execute cycles for one unit's op (VPU: folded into the
    # word-throughput term; DSP48: 1 cycle, fully parallel across units)
    step_exe_cycles: float = 0.0

    @property
    def vpu_word_ops_per_cycle(self) -> int:
        """int32 bitwise ops per cycle (one vreg slab)."""
        return self.vpu_sublanes * self.vpu_lanes

    @property
    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_bw / self.clock_hz

    @property
    def vmem_bytes_per_cycle(self) -> float:
        return self.vmem_bw / self.clock_hz


@dataclass(frozen=True)
class FpgaFabric(TpuFabric):
    """Paper-faithful constants: Xilinx VU9P on AWS F1 (paper §8).

    250 MHz fabric clock; DSP48 executes a 48-lane bitwise op in 1 cycle
    with the step fully pipelined (the paper's dataflow engine: address
    fetch / execute / write-back overlap, eq. 20's terms ARE the pipeline
    stages, so no 40-cycle dependent-latency charge); BRAM moves lambda
    operands per cycle (dual-ported, eq. 8/16); 4 DDR4 banks ~17 GB/s each,
    3 dedicated to the address stream (eq. 6)."""

    clock_hz: float = 250e6
    simd_lanes: int = 48
    vpu_sublanes: int = 10 ** 7        # all DSPs execute in parallel
    step_overhead_cycles: float = 1.0
    step_exe_cycles: float = 1.0       # n_exe_logic_ops
    hbm_bw: float = 51e9               # 3 DDR banks for the dominant stream
    vmem_bw: float = 54e9              # BRAM: lambda*6B/cycle @ 250 MHz
    vmem_bytes: int = 8 * 2 ** 20      # ~345 x 36Kb BRAM usable
    peak_flops: float = 0.0            # n/a
    ici_bw: float = 0.0                # n/a
    dma_beat_bytes: int = 64           # 512-bit AXI beat


@dataclass(frozen=True)
class FfclStats:
    """Statistics of one compiled FFCL module the model needs (paper Table 1
    plus eq. 23 inputs).

    ``n_steps_scheduled``/``step_occupancy`` are only present when the stats
    come from a *compiled* program (:meth:`from_program`): with step fusion
    the scheduler emits fewer steps than eq. 23 predicts, and the model must
    charge the stream/loop terms for the steps that actually exist
    (DESIGN.md §3). Both are specific to the ``n_unit`` the program was
    compiled for — do not reuse such stats to probe other unit counts
    (the optimizer sweeps use :meth:`from_graph` stats, which stay on the
    closed-form eq. 23 path).
    """

    n_gates: int
    depth: int
    n_fanin: int                  # primary inputs
    n_outputs: int
    level_histogram: np.ndarray   # gates per level, shape (depth,)
    n_steps_scheduled: int | None = None   # actual (possibly fused) steps
    step_occupancy: np.ndarray | None = None  # (n_steps,) non-NOP units
    n_unit_scheduled: int | None = None    # the n_unit compiled for

    @staticmethod
    def from_program(prog) -> "FfclStats":
        occ = (prog.opcode != 0).sum(axis=1).astype(np.int64)
        if prog.n_steps:
            hist = np.bincount(prog.level_of_step - 1, weights=occ,
                               minlength=prog.depth)
        else:
            hist = np.zeros(prog.depth)
        return FfclStats(
            n_gates=prog.n_gates, depth=prog.depth, n_fanin=prog.n_inputs,
            n_outputs=prog.n_outputs,
            level_histogram=hist.astype(np.int64),
            n_steps_scheduled=prog.n_steps, step_occupancy=occ,
            n_unit_scheduled=prog.n_unit)

    @staticmethod
    def from_graph(graph, optimized=False) -> "FfclStats":
        """Closed-form (eq. 23-path) stats of a graph.

        ``optimized`` is the shared core/opt.py knob (``True`` /
        ``"default"`` for the default pass pipeline, a ``PassManager``
        for a custom one, a :class:`~repro.core.spec.CompileSpec` for
        its resolved pipeline, ``False`` / ``"none"`` for raw):
        design-space sweeps (``optimizer.sweep``/``binary_search``)
        should probe the post-optimization gate counts the scheduler
        will actually emit — probing raw synthesis output
        systematically overstates both the compute and address-stream
        terms of eq. 22.
        """
        from repro_torch.core.levelize import levelize
        from repro_torch.core.opt import resolve_pipeline
        pipeline = resolve_pipeline(optimized)
        if pipeline is not None:
            graph = pipeline.run(graph).graph
        lv = levelize(graph)
        return FfclStats(graph.n_gates, lv.depth, graph.n_inputs,
                         graph.n_outputs, lv.histogram())


@dataclass(frozen=True)
class LayerLoad:
    """One network layer's load for the whole-network cost equations.

    Replaces the untyped ``(stats, n_filters, n_input_vectors)`` tuples
    ``CostModel.network_cycles`` and the design-space searches
    (``optimizer.sweep``/``binary_search``) used to take:

      * ``stats``           — the representative FFCL module's
        :class:`FfclStats` (one filter / neuron of the layer);
      * ``n_copies``        — how many structurally-like modules run
        back-to-back with task pipelining (paper eq. 2's ``m``: the
        layer's filter count);
      * ``n_input_vectors`` — SIMD batch for the layer (conv patches x
        samples; sets the packed word width W).

    Iterable in that order, so legacy ``for stats, m, n_vec in layers``
    unpacking keeps working; the model-facing entry points also still
    accept raw tuples (:meth:`from_any`).
    """

    stats: FfclStats
    n_copies: int = 1
    n_input_vectors: int = 1

    def __post_init__(self):
        if self.n_copies < 1:
            raise ValueError(f"n_copies must be >= 1, got {self.n_copies}")
        if self.n_input_vectors < 1:
            raise ValueError(
                f"n_input_vectors must be >= 1, got {self.n_input_vectors}")

    def __iter__(self):
        yield self.stats
        yield self.n_copies
        yield self.n_input_vectors

    @staticmethod
    def from_any(obj) -> "LayerLoad":
        """Normalize a ``LayerLoad`` or a legacy 3-tuple."""
        if isinstance(obj, LayerLoad):
            return obj
        stats, n_copies, n_vec = obj
        return LayerLoad(stats=stats, n_copies=int(n_copies),
                         n_input_vectors=int(n_vec))


def normalize_layers(layers) -> list[LayerLoad]:
    """Tuple-accepting shim for every ``layers`` argument below."""
    return [LayerLoad.from_any(lw) for lw in layers]


def n_subkernels(stats: FfclStats, n_unit: int) -> int:
    """Sub-kernel step count: the actual scheduled count when the stats come
    from a compiled (possibly level-fused) program, else eq. 23's closed
    form — sum over levels of ceil(gates_l / n_unit).

    Program-derived stats are pinned to the unit count they were compiled
    for; probing a different ``n_unit`` with them is an error (use
    ``FfclStats.from_graph`` for design-space sweeps)."""
    if stats.n_steps_scheduled is not None:
        if stats.n_unit_scheduled is not None and \
                n_unit != stats.n_unit_scheduled:
            raise ValueError(
                f"stats were compiled for n_unit={stats.n_unit_scheduled}; "
                f"cannot probe n_unit={n_unit} with a scheduled step count")
        return int(stats.n_steps_scheduled)
    return int(np.ceil(stats.level_histogram / n_unit).sum())


@dataclass
class CostBreakdown:
    """Every term of eq. 22, in cycles."""

    n_read_inputs_opcode_mem: float
    n_read_addr_mem: float
    n_data_moves: float          # eq. 3/12: max of the two streams
    n_copy_mem_in: float         # eq. 18
    n_loop_subkernels: float     # eq. 20
    n_outputs_drain: float
    n_compute: float             # eq. 21
    n_total_pipelined: float     # eq. 2 with m modules
    m_modules: int
    n_unit: int
    bound: str = ""              # 'data_moves' | 'compute'

    def seconds(self, fabric: TpuFabric) -> float:
        return self.n_total_pipelined / fabric.clock_hz


class CostModel:
    """Paper §6.2 with TPU constants.

    Word width W = ceil(n_input_vectors / 32): the SIMD axis. A gate-op row
    is (1, W) int32 -> ceil(W / (8*128)) VPU cycles.
    """

    def __init__(self, fabric: TpuFabric | None = None):
        self.fabric = fabric or TpuFabric()
        f = self.fabric
        if isinstance(f, FpgaFabric):
            # paper Table 1: 512-bit AXI / 14-bit addr, 48-bit input word,
            # 6-bit opcode
            self.lambda_, self.delta, self.zeta = 36, 10, 85
        else:
            # re-derived for the TPU bus: addresses int32 (3 per unit),
            # opcodes int8, inputs int32 words.
            self.lambda_ = f.dma_beat_bytes // 4    # addresses per beat
            self.delta = f.dma_beat_bytes // 4      # input words per beat
            self.zeta = f.dma_beat_bytes            # opcodes per beat

    # -- helpers ---------------------------------------------------------
    def _w_words(self, n_input_vectors: int) -> int:
        return -(-n_input_vectors // self.fabric.simd_lanes)

    def _vpu_cycles_per_row(self, w_words: int) -> float:
        f = self.fabric
        return max(1.0, w_words / f.vpu_word_ops_per_cycle)

    # -- eq. 6/9: address-stream movement --------------------------------
    def n_read_addr_mem(self, stats: FfclStats, n_unit: int) -> float:
        nsk = n_subkernels(stats, n_unit)
        n_addresses = 3 * n_unit * nsk             # 2 reads + 1 write per unit
        hbm_cycles = (n_addresses * 4) / self.fabric.hbm_bytes_per_cycle
        # URAM->BRAM distribution halved by dual-porting (eq. 8) -> on TPU the
        # program stream is consumed straight from VMEM; charge VMEM copy:
        vmem_cycles = (n_addresses * 4) / self.fabric.vmem_bytes_per_cycle
        return hbm_cycles + 0.5 * vmem_cycles

    # -- eq. 11: inputs + opcodes ----------------------------------------
    def n_read_inputs_opcode_mem(self, stats: FfclStats, n_unit: int,
                                 n_input_vectors: int) -> float:
        w = self._w_words(n_input_vectors)
        nsk = n_subkernels(stats, n_unit)
        input_bytes = stats.n_fanin * w * 4
        opcode_bytes = nsk * n_unit * 1
        return (input_bytes + opcode_bytes) / self.fabric.hbm_bytes_per_cycle

    # -- eq. 12 ----------------------------------------------------------
    def n_data_moves(self, stats: FfclStats, n_unit: int,
                     n_input_vectors: int) -> float:
        return max(
            self.n_read_inputs_opcode_mem(stats, n_unit, n_input_vectors),
            self.n_read_addr_mem(stats, n_unit))

    # -- eqs. 14-20: compute loop ----------------------------------------
    def n_loop_subkernels(self, stats: FfclStats, n_unit: int,
                          n_input_vectors: int,
                          exact_occupancy: bool = False) -> float:
        """Gather operands, execute, scatter results, per sub-kernel step.

        ``exact_occupancy=False`` reproduces the paper's worst-case
        assumption (every step uses all n_unit units) -- the stated source
        of its <10% model error. ``True`` charges actual per-step occupancy:
        the scheduled ``step_occupancy`` profile when the stats come from a
        compiled program (what the simulator feeds in), else the per-level
        ceil/remainder approximation of the eq. 23 layout.
        """
        w = self._w_words(n_input_vectors)
        f = self.fabric

        def step_cost(units):
            # eq. 16 analogue: 2 operand-row gathers (VMEM->VREG) per unit,
            # eq. 19: 1 result-row scatter (half the gather traffic); the
            # opcode op runs at the fabric's word throughput (one (8,128)
            # slab/cycle on the VPU; 1 cycle across all DSP48s); plus the
            # fixed per-step overhead (see TpuFabric/FpgaFabric). Pure
            # arithmetic, so it vectorizes over an occupancy array.
            gather = 2 * units * w * 4 / f.vmem_bytes_per_cycle
            execute = f.step_exe_cycles + units * w / f.vpu_word_ops_per_cycle
            scatter = units * w * 4 / f.vmem_bytes_per_cycle
            return f.step_overhead_cycles + gather + execute + scatter

        if not exact_occupancy:
            nsk = n_subkernels(stats, n_unit)
            units = float(n_unit)
            if stats.n_steps_scheduled is not None and nsk:
                # fused-step extension: the scheduler packs steps densely,
                # so the mean scheduled occupancy (cost is linear in units)
                # replaces the paper's all-units worst case, which at low
                # occupancy overshoots the simulator far past the paper's
                # <10% bound. Closed form still — no occupancy profile.
                units = min(units, stats.n_gates / nsk)
            return nsk * step_cost(units)
        if stats.step_occupancy is not None:
            return float(np.sum(step_cost(
                stats.step_occupancy.astype(np.float64))))
        full = stats.level_histogram // n_unit
        rem = stats.level_histogram % n_unit
        return float((full * step_cost(n_unit)).sum()
                     + step_cost(rem[rem > 0].astype(np.float64)).sum())

    def n_compute(self, stats: FfclStats, n_unit: int, n_input_vectors: int,
                  exact_occupancy: bool = False) -> float:
        w = self._w_words(n_input_vectors)
        f = self.fabric
        # eq. 18: replicate the input rows into the VMEM buffer
        n_copy_mem_in = stats.n_fanin * w * 4 / f.vmem_bytes_per_cycle
        loop = self.n_loop_subkernels(stats, n_unit, n_input_vectors,
                                      exact_occupancy)
        n_outputs_drain = stats.n_outputs * w * 4 / f.hbm_bytes_per_cycle
        return n_copy_mem_in + loop + n_outputs_drain

    # -- eq. 2/22 ---------------------------------------------------------
    def breakdown(self, stats: FfclStats, n_unit: int, n_input_vectors: int,
                  m_modules: int = 1,
                  exact_occupancy: bool = False) -> CostBreakdown:
        w = self._w_words(n_input_vectors)
        f = self.fabric
        dm_in = self.n_read_inputs_opcode_mem(stats, n_unit, n_input_vectors)
        dm_addr = self.n_read_addr_mem(stats, n_unit)
        dm = max(dm_in, dm_addr)
        loop = self.n_loop_subkernels(stats, n_unit, n_input_vectors,
                                      exact_occupancy)
        copy_in = stats.n_fanin * w * 4 / f.vmem_bytes_per_cycle
        drain = stats.n_outputs * w * 4 / f.hbm_bytes_per_cycle
        comp = copy_in + loop + drain
        total = (m_modules + 1) * max(dm, comp)
        return CostBreakdown(
            n_read_inputs_opcode_mem=dm_in, n_read_addr_mem=dm_addr,
            n_data_moves=dm, n_copy_mem_in=copy_in, n_loop_subkernels=loop,
            n_outputs_drain=drain, n_compute=comp, n_total_pipelined=total,
            m_modules=m_modules, n_unit=n_unit,
            bound="data_moves" if dm >= comp else "compute")

    def total_cycles(self, stats: FfclStats, n_unit: int,
                     n_input_vectors: int, m_modules: int = 1) -> float:
        return self.breakdown(stats, n_unit, n_input_vectors,
                              m_modules).n_total_pipelined

    # -- paper §7.2 eq. 24: whole-network cost ---------------------------
    def network_cycles(self, layers: list[LayerLoad], n_unit: int,
                       parallel_factor: int = 1) -> float:
        """layers: :class:`LayerLoad` entries (legacy
        ``(stats, n_copies, n_input_vectors)`` tuples still accepted).

        Within a layer, the n_copies FFCL modules run back-to-back with
        task pipelining (§5.2.3): data movement of filter k+1 overlaps
        compute of filter k, so the layer costs
        (n_copies + 1) * max(dm, comp)  — eq. 2 with m = n_copies.
        Layers are sequential (§7.2); parallel compute kernels divide the
        total (eq. 25)."""
        tot = 0.0
        for lw in normalize_layers(layers):
            tot += self.total_cycles(lw.stats, n_unit, lw.n_input_vectors,
                                     m_modules=lw.n_copies)
        return tot / parallel_factor

    def network_cycles_parallel(self, layers, n_per: int, k: int) -> float:
        """Eq. 25 with bandwidth conservation: k concurrent compute kernels
        of n_per units each split every layer's filters, but their data-
        movement streams SHARE the fixed off-chip bandwidth, so each
        kernel's dm term stretches by k. Per layer (per kernel, all run
        in parallel):  (ceil(m/k) + 1) * max(k * dm, comp)."""
        tot = 0.0
        for lw in normalize_layers(layers):
            b = self.breakdown(lw.stats, n_per, lw.n_input_vectors,
                               m_modules=1)
            m_k = -(-lw.n_copies // k)
            tot += (m_k + 1) * max(k * b.n_data_moves, b.n_compute)
        return tot
