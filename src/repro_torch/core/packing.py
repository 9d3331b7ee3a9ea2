# Copied from src/repro/core/packing.py; only the repro imports differ.
"""Batch bit-packing (paper §5: 48-lane DSP SIMD -> 32-lane int32 words).

The DSP48 executes one opcode over 48 independent Boolean lanes; on TPU the
natural word is int32 on the VPU, so we pack 32 *samples* per word and keep a
word (lane) axis of width W = ceil(batch/32). A gate op on a (row, W) slab
processes 32*W samples in one VPU op row.

Layout (also DESIGN.md §5 — the serving slot table is sized to exactly the
``32*W`` samples of one slab)::

    bits (batch, n_wires) bool          packed (n_wires, W) int32
                                        W = ceil(batch / 32)

              sample axis ->                      word axis ->
            s0 s1 ... s31 | s32 ... s63            w=0     w=1
    wire 0 [ b  b  ...  b |  b  ...  b ]   wire 0 [0x….  0x…. ]
    wire 1 [ b  b  ...  b |  b  ...  b ]   wire 1 [0x….  0x…. ]
      ...                           pack->   ...
    wire n [ b  b  ...  b |  b  ...  b ]   wire n [0x….  0x…. ]

    packed[n, w] bit k (LSB-first) == bits[w*32 + k, n]

A batch that is not a multiple of 32 pads its final word with zeros;
``unpack_bits`` slices the padding back off.

>>> import numpy as np
>>> bits = np.zeros((33, 2), dtype=bool)   # 33 samples -> W = 2 words
>>> bits[0, 0] = bits[32, 1] = True
>>> packed_width(33)
2
>>> w = pack_bits(bits)
>>> w.shape                                # (n_wires, W)
(2, 2)
>>> int(w[0, 0]), int(w[1, 1])   # samples 0/32 -> bit 0 of words 0/1
(1, 1)
>>> bool((unpack_bits(w, 33) == bits).all())
True
"""
from __future__ import annotations

import numpy as np

WORD_BITS = 32


def packed_width(batch: int) -> int:
    return -(-batch // WORD_BITS)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """(batch, n_wires) bool -> (n_wires, W) int32, LSB-first within a word."""
    bits = np.asarray(bits).astype(np.uint8)
    batch, n = bits.shape
    w = packed_width(batch)
    pad = w * WORD_BITS - batch
    if pad:
        bits = np.concatenate(
            [bits, np.zeros((pad, n), dtype=np.uint8)], axis=0)
    # (W, 32, n) -> pack along the 32 axis
    chunks = bits.reshape(w, WORD_BITS, n)
    weights = (np.uint32(1) << np.arange(WORD_BITS, dtype=np.uint32))
    words = (chunks.astype(np.uint32) * weights[None, :, None]).sum(
        axis=1, dtype=np.uint32)
    return words.astype(np.int32).T.copy()  # (n, W)


def unpack_bits(words: np.ndarray, batch: int) -> np.ndarray:
    """(n_wires, W) int32 -> (batch, n_wires) bool."""
    words = np.asarray(words).astype(np.uint32)
    n, w = words.shape
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = (words[:, :, None] >> shifts[None, None, :]) & np.uint32(1)
    bits = bits.reshape(n, w * WORD_BITS).T  # (W*32, n)
    return bits[:batch].astype(bool)
