# Copied from src/repro/flow/convert.py; only the repro imports differ.
"""The single NN-layer -> FFCL conversion code path (paper §7 NullaNet flow).

Every consumer that turns one binarized layer into executable logic —
the end-to-end classifier (flow/classifier.py), the transformer FFN swap
(models/logic_mlp.py), examples, benchmarks — goes through
:func:`convert_layer`: Boolean-spec extraction (``nullanet.layer_to_graph``:
ISF or full enumeration per neuron) -> two-level minimization
(core/espresso.py) -> multi-level restructuring (core/synth.py) ->
sub-kernel scheduling (``scheduler.compile_graph``). Keeping one code path
means the degenerate-cover guarantees (constant-true/false neurons, empty
ISF care-sets — tests/test_conformance.py) hold everywhere.

Weights are cast to float64 *here*, before spec extraction, so the layer's
Boolean function is defined by exactly one numeric comparison —
``(2x-1) @ W + b >= 0`` in float64 — and the hard reference forward
(flow/classifier.py ``hard_forward``) reproduces it bit-for-bit. That is
what makes the accuracy-parity claim *exact* rather than approximate.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.compiler import LogicCompiler
from repro_torch.core.gate_ir import LogicGraph
from repro_torch.core.nullanet import layer_to_graph
from repro_torch.core.scheduler import LogicProgram, compile_graph
from repro_torch.core.spec import CompileSpec, resolve_spec, _UNSET


@dataclass(frozen=True)
class CompiledLayer:
    """One hidden layer as both its gate DAG and its compiled program.

    The graph is retained next to the program because the two serve
    different executors: direct reference / Pallas paths run the program's
    streams, while the serving engine keys its registry on the graph and
    compiles (or cache-hits) from it.
    """

    graph: LogicGraph
    program: LogicProgram

    @property
    def n_inputs(self) -> int:
        return self.graph.n_inputs

    @property
    def n_outputs(self) -> int:
        return self.graph.n_outputs


def layer_graph(W: np.ndarray, b: np.ndarray, calib_bits: np.ndarray,
                *, mode: str = "auto", name: str = "layer",
                optimize="default") -> LogicGraph:
    """Graph-only conversion of one binarized layer (no scheduling).

    Args:
      W / b: (fanin, n_neurons) weights and (n_neurons,) bias of the layer
        (any float dtype; cast to float64 for spec extraction — the parity
        rule of the module docstring lives here).
      calib_bits: (N, fanin) {0,1} calibration activations — the observed
        care-set for ISF mode; unused by full enumeration.
      mode: 'isf' | 'enum' | 'auto' (enumeration when fanin <= ENUM_LIMIT;
        enumeration makes the conversion *exact*, see module docstring).
      optimize: gate-level pass pipeline for the synthesized graph
        (core/opt.py): ``"default"`` | ``"none"`` | a ``PassManager``.
        Semantics-preserving, so the parity guarantees are unaffected.
    """
    W = np.asarray(W, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return layer_to_graph(np.asarray(calib_bits, dtype=np.uint8), W, b,
                          mode=mode, name=name, optimize=optimize)


def convert_layer(W: np.ndarray, b: np.ndarray, calib_bits: np.ndarray,
                  spec: CompileSpec | None = None, *, mode: str = "auto",
                  name: str = "layer", n_unit=_UNSET, alloc=_UNSET,
                  opcode_sort=_UNSET, fuse_levels=_UNSET,
                  optimize=_UNSET) -> CompiledLayer:
    """NullaNet-convert one binarized layer (:func:`layer_graph`) and
    compile it against ``spec`` (the one declarative target,
    core/spec.py; canonical defaults when omitted).

    ``spec.optimize`` is applied once, at the graph stage, so the
    retained ``graph`` and the compiled ``program`` describe the same
    optimized netlist; ``spec.n_unit="auto"`` resolves per layer via the
    design-space search (core/compiler.py); ``spec.max_gates`` is moot
    here (one layer compiles monolithically — budget-aware serving
    partitions the composed stack instead).  Loose ``n_unit``/``alloc``/
    ``opcode_sort``/``fuse_levels``/``optimize`` kwargs are the
    deprecated pre-spec convention.
    """
    spec = resolve_spec(spec, caller="convert_layer", n_unit=n_unit,
                        alloc=alloc, opcode_sort=opcode_sort,
                        fuse_levels=fuse_levels, optimize=optimize)
    graph = layer_graph(W, b, calib_bits, mode=mode, name=name,
                        optimize=spec.optimize)
    spec, _ = LogicCompiler().resolve(graph, spec, assume_optimized=True)
    program = compile_graph(graph, spec.with_(optimize="none",
                                              max_gates=None))
    return CompiledLayer(graph=graph, program=program)


def layer_to_program(W: np.ndarray, b: np.ndarray, calib_bits: np.ndarray,
                     spec: CompileSpec | None = None, *, mode: str = "auto",
                     name: str = "layer", n_unit=_UNSET, alloc=_UNSET,
                     optimize=_UNSET) -> LogicProgram:
    """Program-only convenience over :func:`convert_layer`."""
    spec = resolve_spec(spec, caller="layer_to_program", n_unit=n_unit,
                        alloc=alloc, optimize=optimize)
    return convert_layer(W, b, calib_bits, spec, mode=mode,
                         name=name).program
