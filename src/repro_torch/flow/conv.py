"""A binarized convolution served as one NullaNet gate program.

Each output channel of a binarized conv layer is one Boolean function of
its receptive field: channel ``o`` at position ``(y, x)`` fires iff
``(2r - 1) @ W[o].ravel() + b[o] >= 0`` on the field's 0/1 bits ``r``.
So the layer is a dense layer over receptive-field rows, and it is
synthesized (``layer_to_graph``), compiled and served
(``LogicEngine``) as one: a map batch goes in as its rows, one sample a
row, and the outputs fold back into maps.

Row order: one row per output position, image-major, then row, then
column (``n * H * W + y * W + x``).  Column order within a row: input
channel, then kernel row, then kernel column (``c * k * k + i * k + j``),
the order of ``torch.nn.functional.unfold`` and of ``W.reshape(C_out,
-1)``.  Stride 1.  A padded position is a 0 bit, which is -1 in the
+-1 form the layer computes in (``conv_ref.binarized_conv``).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.gate_ir import LogicGraph
from repro_torch.core.nullanet import layer_to_graph


def unfold_bits(maps, k: int = 3, pad: int = 1) -> np.ndarray:
    """(N, C, H, W) 0/1 maps -> (N * H' * W', C * k * k) bool receptive
    fields, H' = H + 2 pad - k + 1 (the same for W')."""
    maps = np.asarray(maps).astype(bool, copy=False)
    if maps.ndim != 4:
        raise ValueError(f"maps must be (N, C, H, W), got {maps.shape}")
    n, c = maps.shape[:2]
    padded = np.pad(maps, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    win = np.lib.stride_tricks.sliding_window_view(padded, (k, k),
                                                   axis=(2, 3))
    # (N, C, H', W', k, k) -> (N, H', W', C, k, k)
    h, w = win.shape[2:4]
    return np.ascontiguousarray(win.transpose(0, 2, 3, 1, 4, 5)).reshape(
        n * h * w, c * k * k)


def fold_bits(rows, n: int, h: int, w: int) -> np.ndarray:
    """(N * H * W, C) output rows -> (N, C, H, W) maps."""
    rows = np.asarray(rows)
    if rows.ndim != 2 or rows.shape[0] != n * h * w:
        raise ValueError(f"{rows.shape} rows do not fold into {n} maps of "
                         f"{h} x {w}")
    return np.ascontiguousarray(
        rows.reshape(n, h, w, rows.shape[1]).transpose(0, 3, 1, 2))


def conv_to_graph(maps, weight, bias, *, pad: int = 1,
                  name: str = "conv") -> LogicGraph:
    """Synthesize a binarized conv layer (``weight`` (C_out, C, k, k),
    ``bias`` (C_out,)) as one graph, its ISF sampled on the receptive
    fields of ``maps``: exact on every field those maps hold."""
    weight = np.asarray(weight, dtype=np.float32)
    c_out, _, k, _ = weight.shape
    rows = unfold_bits(maps, k, pad).astype(np.uint8)
    return layer_to_graph(rows, weight.reshape(c_out, -1).T,
                          np.asarray(bias, dtype=np.float32), mode="isf",
                          name=name)


def serve_conv(engine, graph: LogicGraph, maps, pad: int = 1) -> np.ndarray:
    """Serve a map batch through ``engine``: its receptive fields as one
    request (``submit``), the engine's waves (``step`` until done), the
    rows folded back: (N, C_out, H', W') bool.  The field's size ``k``
    is the graph's: ``C * k * k`` inputs."""
    maps = np.asarray(maps)
    k = math.isqrt(graph.n_inputs // maps.shape[1])
    if maps.shape[1] * k * k != graph.n_inputs:
        raise ValueError(f"{graph.n_inputs} inputs are no square field "
                         f"over {maps.shape[1]} channels")
    rows = unfold_bits(maps, k, pad)
    n = maps.shape[0]
    h, w = (s + 2 * pad - k + 1 for s in maps.shape[2:])
    uid = engine.submit(graph, rows)
    engine.drain()
    return fold_bits(engine.result(uid), n, h, w)
