"""The card's peaks and the logic kernels' operation and byte counts.

Frozen from ``chip_smoke.py``'s ``bound`` (the K1/K2 bound arithmetic):
a launch of the mega kernel evaluates every gate of its program on every
32-sample word of the launch, one int32 operation a gate and word, and
reads its inputs and index records and writes its outputs once.  The
least time a launch can take is the larger of its operations at the
card's int32 rate and its bytes at the card's memory rate.

Peaks of one NVIDIA H100 SXM at its 700 W limit: 132 SMs, 64 int32 lanes
an SM and clock, 1.98 GHz boost clock (the int32 rate); 3.35 TB/s of HBM3
(NVIDIA's data sheet).
"""
from __future__ import annotations

SMS = 132
INT32_LANES_PER_SM = 64
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = SMS * INT32_LANES_PER_SM * SM_CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12
WORD_BITS = 32


def launch_ops(gates: int, words: int) -> int:
    """int32 word operations of one launch: every gate on every word."""
    return gates * words


def launch_bytes(in_bytes: int, out_bytes: int, record_bytes: int) -> int:
    """Bytes one launch must move: packed inputs read, packed outputs
    written and the program's index records read, each once."""
    return in_bytes + out_bytes + record_bytes


def launch_bound_s(shape: dict) -> tuple[float, str]:
    """The least time of one launch of a program of ``shape`` (the keys
    of ``program.served_shape``) and what bounds it."""
    t_ops = launch_ops(shape["gates"], shape["words"]) / INT32_OPS_PER_S
    t_bytes = launch_bytes(shape["in_bytes"], shape["out_bytes"],
                           shape["record_bytes"]) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def served_word_ops(samples: int, gates: int) -> float:
    """Gate word operations the served samples needed: every gate of the
    program on each sample, 32 samples a word."""
    return samples * gates / WORD_BITS
