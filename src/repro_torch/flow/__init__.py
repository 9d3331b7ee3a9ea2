# Port of src/repro/flow/__init__.py: the same exports.
"""End-to-end NullaNet classifier flow: train -> per-layer FFCL -> serve.

The paper loop as one artifact: ``run_flow`` trains a binarized MLP,
converts every hidden layer through the single conversion code path
(``convert_layer``: ISF/enumeration -> espresso -> synth -> schedule),
chains the compiled programs with packed-word handoff, and measures
accuracy parity across the reference, CUDA, megakernel and
serving-engine backends. See DESIGN.md §6.
"""
from repro_torch.flow.classifier import (BACKENDS, LogicClassifier,
                                         build_classifier, hard_forward,
                                         input_bits)
from repro_torch.flow.convert import (CompiledLayer, convert_layer,
                                      layer_graph, layer_to_program)
from repro_torch.flow.report import EndToEndReport, FlowConfig, run_flow

__all__ = [
    "BACKENDS", "CompiledLayer", "EndToEndReport", "FlowConfig",
    "LogicClassifier", "build_classifier", "convert_layer", "hard_forward",
    "input_bits", "layer_graph", "layer_to_program", "run_flow",
]
