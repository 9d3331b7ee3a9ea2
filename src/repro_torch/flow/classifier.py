# Port of src/repro/flow/classifier.py.  input_bits and hard_forward are
# copied verbatim (numpy, on the host); build_classifier is too, but for
# one line that takes the parameters to the host (host_params, so tensors
# on the card convert as they are); the execution backends run the port's
# executors on an explicit device.
"""Multi-layer NullaNet classifier over chained compiled logic programs.

The paper's actual workload (§7-§8): a whole NN inferred through
fixed-function combinational logic. :class:`LogicClassifier` holds one
:class:`~repro_torch.flow.convert.CompiledLayer` per hidden layer plus the
full-precision output head, and executes the hidden stack through four
interchangeable paths that must agree bit-for-bit:

  * ``reference``  — the plain PyTorch program executor
    (kernels/logic_dsp/ref.py), layer by layer on the packed words;
  * ``cuda``       — the hand-written CUDA program executor, one K1 launch
    per layer (on a CPU device, the same chain through the plain version);
  * ``megakernel`` — the whole hidden stack fused into ONE
    :class:`~repro_torch.core.scheduler.MegaProgram` and executed in a
    single K2 launch (the layer loop runs *inside* the kernel, stage k's
    output words handed straight to stage k+1's input rows);
  * ``engine``     — batched :class:`~repro_torch.serve.LogicEngine`
    serving.  With no partition budget the engine serves the per-layer
    programs as a chain-mode megakernel entry (``submit_chain``); with
    ``spec.max_gates`` set it serves the *composed* hidden-stack graph
    (``gate_ir.compose_graphs``) so the budget splits the stack by output
    cones into a parallel-mode pipeline (core/partition.py) — either way
    one K2 launch per wave.

**Packed-word handoff contract**: for the reference/cuda paths the input
batch is bit-packed ONCE into the ``(n_bits, W)`` word layout; each
layer's packed output slab is fed directly as the next layer's packed
input slab, with no unpack/repack round-trip between layers. This works
because every program loads its inputs at contiguous buffer rows
2..2+n_inputs and the layer widths chain. Samples that don't fill the last
32-bit word enter as zero padding; inverting gates and the constant-1 row
flip those lanes, so inter-layer padding bits are garbage, not zeros —
correctness rests on every gate op being lane-wise plus the single final
unpack slicing the padding off.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.gate_ir import LogicGraph, compose_graphs
from repro_torch.core.nullanet import host_params
from repro_torch.core.scheduler import build_megaprogram
from repro_torch.core.simulator import SimResult, simulate_pipeline
from repro_torch.core.spec import CompileSpec, resolve_spec, _UNSET
from repro_torch.flow.convert import CompiledLayer, convert_layer
from repro_torch.kernels.logic_dsp.ops import (_bits_tensor, forward_words,
                                               mega_infer_bits, pack_bits,
                                               program_arrays,
                                               resolve_device, unpack_bits)

BACKENDS = ("reference", "cuda", "megakernel", "engine")


def input_bits(x: np.ndarray) -> np.ndarray:
    """Binarize features at the sign/half boundary -> (N, n_features) bool."""
    return (np.asarray(x, dtype=np.float64) >= 0.5)


def hard_forward(params: dict, bits: np.ndarray, n_layers: int
                 ) -> tuple[list[np.ndarray], np.ndarray]:
    """Bit-exact binarized inference: hard {0,1} activations in float64.

    This — not the STE float32 training forward — is the semantic spec the
    logic conversion implements: each hidden activation is
    ``(2a-1) @ W + b >= 0`` evaluated in float64, matching
    ``nullanet.neuron_enumerated``/``neuron_isf`` exactly (the float32
    weights are representable exactly in float64, so the comparison is the
    same one the spec extraction performed). Returns (per-layer {0,1}
    activations including the input, float64 logits).
    """
    acts = [np.asarray(bits, dtype=np.uint8)]
    h = 2.0 * acts[0].astype(np.float64) - 1.0
    for i in range(n_layers - 1):
        y = h @ np.asarray(params[f"w{i}"], np.float64) \
            + np.asarray(params[f"b{i}"], np.float64)
        acts.append((y >= 0).astype(np.uint8))
        h = 2.0 * acts[-1] - 1.0
    logits = h @ np.asarray(params[f"w{n_layers - 1}"], np.float64) \
        + np.asarray(params[f"b{n_layers - 1}"], np.float64)
    return acts, logits


@dataclass
class LogicClassifier:
    """Hidden layers as compiled FFCL programs + numeric argmax head.

    ``spec`` is the :class:`~repro_torch.core.spec.CompileSpec` the layers
    were converted against — the single compilation-target record the
    engine backend and reports read (``n_unit``/``alloc``/``optimize``
    remain as read-only views).  The execution methods take ``device``
    (CUDA unless told otherwise; ``"cpu"`` runs the plain executors).
    """

    layers: tuple[CompiledLayer, ...]
    w_out: np.ndarray
    b_out: np.ndarray
    spec: CompileSpec = field(default_factory=CompileSpec)
    _stacked: LogicGraph | None = field(default=None, repr=False)
    _mega: object = field(default=None, repr=False)
    _engines: dict = field(default_factory=dict, repr=False)

    @property
    def n_unit(self):
        return self.spec.n_unit

    @property
    def alloc(self) -> str:
        return self.spec.alloc

    @property
    def optimize(self):
        return self.spec.optimize

    @property
    def n_features(self) -> int:
        return self.layers[0].n_inputs

    @property
    def n_classes(self) -> int:
        return int(self.w_out.shape[1])

    @property
    def programs(self) -> list:
        return [layer.program for layer in self.layers]

    @property
    def stacked_graph(self) -> LogicGraph:
        """The hidden stack composed into one graph (engine serving path)."""
        if self._stacked is None:
            self._stacked = compose_graphs(
                [layer.graph for layer in self.layers], name="hidden-stack")
        return self._stacked

    @property
    def megaprogram(self):
        """The per-layer programs fused into one chain-mode
        :class:`~repro_torch.core.scheduler.MegaProgram` (the single-launch
        form of the packed-word chain below)."""
        if self._mega is None:
            self._mega = build_megaprogram(
                self.programs, mode="chain", name="hidden-stack")
        return self._mega

    # -- execution ----------------------------------------------------------

    def _chain(self, bits: np.ndarray, device, use_ref: bool) -> np.ndarray:
        """The packed-word chain: pack once -> layer programs back-to-back
        on the word slabs (one K1 launch each on a CUDA device, unless
        ``use_ref``) -> one final unpack."""
        x = _bits_tensor(bits, device)
        words = pack_bits(x)
        for layer in self.layers:
            a = program_arrays(layer.program, device)
            words = forward_words(
                a["src_a"], a["src_b"], a["dst"], a["opcode"],
                a["step_branch"], a["output_addrs"], words,
                n_addr=a["n_addr"], use_ref=use_ref, launch=a)
        return unpack_bits(words, x.shape[0]).cpu().numpy()

    def _serve_engine(self, device):
        """Default engine over the classifier's FULL spec — including
        ``max_gates``, which partitions the composed hidden stack into a
        pipelined program sequence — one per device.  Callers wanting a
        shared cache or a different serving config pass their own engine
        to :meth:`hidden_bits`."""
        key = str(device)
        if key not in self._engines:
            from repro_torch.serve import LogicEngine
            self._engines[key] = LogicEngine(self.spec, capacity=256,
                                             device=device)
        return self._engines[key]

    def hidden_bits(self, bits: np.ndarray, backend: str = "reference",
                    engine=None, device=None) -> np.ndarray:
        """(N, n_features) bool -> (N, n_hidden_out) bool through
        ``backend`` on ``device`` (a caller's ``engine`` runs on its own)."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"use one of {BACKENDS}")
        bits = np.asarray(bits, dtype=bool)
        if backend == "engine" and engine is not None:
            eng = engine
        else:
            dev = resolve_device(device)
            if backend in ("reference", "cuda"):
                return self._chain(bits, dev, use_ref=backend == "reference")
            if backend == "megakernel":
                return mega_infer_bits(self.megaprogram, bits, device=dev)
            eng = self._serve_engine(dev)
        # route on the ENGINE's compilation target (a caller-supplied
        # engine may carry its own budget/spec, not the classifier's)
        if eng.spec.max_gates is None and eng.spec.resolved:
            # No partition budget: serve the per-layer programs as a
            # chain-mode megakernel entry — no composed-graph recompile,
            # stage handoff fused in-kernel.
            return eng.serve_chain([layer.graph for layer in self.layers],
                                   bits)
        return eng.serve(self.stacked_graph, bits)

    def logits_from_hidden(self, h: np.ndarray) -> np.ndarray:
        """The numeric head on hidden bits: ``(2h-1) @ w_out + b_out``,
        float64 (the one place the head math lives)."""
        return (2.0 * np.asarray(h, np.float64) - 1.0) \
            @ np.asarray(self.w_out, np.float64) \
            + np.asarray(self.b_out, np.float64)

    def logits(self, x: np.ndarray, backend: str = "reference",
               engine=None, device=None) -> np.ndarray:
        """Binarize -> hidden stack -> numeric head, float64 logits."""
        h = self.hidden_bits(input_bits(x), backend=backend, engine=engine,
                             device=device)
        return self.logits_from_hidden(h)

    def predict(self, x: np.ndarray, backend: str = "reference",
                engine=None, device=None) -> np.ndarray:
        return np.argmax(self.logits(x, backend=backend, engine=engine,
                                     device=device), axis=-1)

    # -- analysis -----------------------------------------------------------

    def simulate(self, n_input_vectors: int) -> SimResult:
        """Cycle estimate: the per-layer programs pipelined on one fabric
        (core/simulator.py double-buffered multi-FFCL model)."""
        return simulate_pipeline(self.programs, n_input_vectors)

    def layer_stats(self) -> list[dict]:
        return [{**layer.program.stats(),
                 "n_inputs": layer.n_inputs, "n_outputs": layer.n_outputs}
                for layer in self.layers]


def build_classifier(params: dict, n_layers: int, calib_x: np.ndarray,
                     spec: CompileSpec | None = None, *, mode: str = "auto",
                     n_unit=_UNSET, alloc=_UNSET,
                     optimize=_UNSET) -> LogicClassifier:
    """Convert a trained binarized MLP's hidden stack (all layers).

    Calibration activations come from :func:`hard_forward` on the
    calibration set, so ISF care-sets are sampled from exactly the
    function the logic must reproduce.  ``spec`` is the one declarative
    compilation target every layer is converted against
    (``spec.optimize`` is semantics-preserving, so parity holds either
    way — ``"none"`` keeps raw synthesis output for A/B benchmarking;
    ``spec.max_gates`` rides along to the engine backend, which serves
    the composed stack as a pipelined program sequence).  Loose
    ``n_unit``/``alloc``/``optimize`` kwargs are the deprecated
    pre-spec convention.
    """
    spec = resolve_spec(spec, caller="build_classifier", n_unit=n_unit,
                        alloc=alloc, optimize=optimize)
    params = host_params(params)
    bits = input_bits(calib_x).astype(np.uint8)
    acts, _ = hard_forward(params, bits, n_layers)
    layers = tuple(
        convert_layer(params[f"w{i}"], params[f"b{i}"], acts[i],
                      spec, mode=mode, name=f"layer{i}")
        for i in range(n_layers - 1))
    return LogicClassifier(
        layers=layers,
        w_out=np.asarray(params[f"w{n_layers - 1}"]),
        b_out=np.asarray(params[f"b{n_layers - 1}"]),
        spec=spec)
