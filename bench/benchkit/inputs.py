"""The layers a configuration deploys, made from its ``program_seed``.

A configuration is a stack of binarized neuron layers: neuron ``j`` of a
layer fires iff ``(2x - 1) @ W[:, j] + b[j] >= 0`` on its 0/1 inputs
``x``.  With no trained LeNet-5 in the repository, the weights are drawn
here in float32 (the precision a binarized network trains in), and so are
the ISF patterns of the first layer: the 0/1 input vectors that stand in
for the training set.  Each later layer's ISF patterns are the previous
layer's outputs on those patterns, as NullaNet synthesizes a hidden stack
(every layer sampled on the activations its own inputs take).

Both sides get the same arrays: the program synthesizes its gates from
them, the reference (``bench/reference``) recomputes the layer from them.
Plain NumPy; nothing of the program is imported.  (The later layers'
patterns are the reference's own outputs: the benchmark makes them and
hands them to both sides.)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from reference.binarized import binarize


@dataclass(frozen=True)
class Layer:
    name: str
    W: np.ndarray            # (fanin, neurons) float32
    b: np.ndarray            # (neurons,) float32
    patterns: np.ndarray     # (n_patterns, fanin) uint8: the ISF's samples


def make_layers(config: dict) -> list[Layer]:
    """The configuration's layers, deterministic in ``program_seed``.

    Each layer draws from a child seed of its own, so a layer added to a
    configuration leaves the others' weights as they were."""
    specs = config["layers"]
    seq = np.random.SeedSequence(int(config["program_seed"]))
    children = seq.spawn(len(specs) + 1)
    first = specs[0]
    patterns = np.random.default_rng(children[0]).integers(
        0, 2, (int(config["isf_patterns"]), int(first["fanin"])),
        dtype=np.uint8)
    layers = []
    for spec, child in zip(specs, children[1:]):
        rng = np.random.default_rng(child)
        fanin, neurons = int(spec["fanin"]), int(spec["neurons"])
        if patterns.shape[1] != fanin:
            raise ValueError(f"layer {spec['name']} takes {fanin} inputs, "
                             f"its predecessor gives {patterns.shape[1]}")
        W = rng.standard_normal((fanin, neurons), dtype=np.float32)
        b = (float(config["bias_scale"])
             * rng.standard_normal(neurons, dtype=np.float32))
        layers.append(Layer(spec["name"], W, b.astype(np.float32), patterns))
        patterns = binarize(patterns, W, b)
    return layers
