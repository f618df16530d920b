"""Peaks of one NVIDIA H100 SXM (data sheet) and the work of the sketch
kernel, counted from its inputs: what any implementation must do.

The int32 rate is 132 SMs x 64 INT32 lanes x 1,980 MHz (the boost
clock); HBM3 moves 3.35 TB/s.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def murmur_int_ops(k: int) -> int:
    """32-bit integer instructions that murmur3 x64_128 (first lane) and
    the scaled filter need for one k-byte window, counting a 64-bit
    multiply as 3 (lo*lo wide + two cross terms) and a 64-bit add, xor,
    shift, rotate or compare as 2."""
    mul, other = 0, 0
    blocks, tail = divmod(k, 16)
    mul += blocks * 6  # k1, k2: 2 each; h1*5, h2*5
    other += blocks * 12  # 2 rotl + xor per lane, h rotl + 2 adds per lane
    if tail > 8:
        mul, other = mul + 2, other + 2
    if tail > 0:
        mul, other = mul + 2, other + 2
    other += 4  # length xors, h1 += h2, h2 += h1
    mul += 4  # two fmix64: 2 multiplies each
    other += 6 * 2 + 1 + 2  # fmix shift+xor pairs, final add, filter compare+select
    return 3 * mul + 2 * other


def sketch_bound_s(residues: int, windows: int, k: int) -> Tuple[float, str]:
    """Least time of the masked sketch over ``residues`` bytes read and
    ``windows`` 8-byte keys written, and which bound sets it."""
    t_bytes = (residues + 8 * windows) / HBM_BYTES_PER_S
    t_ops = windows * murmur_int_ops(k) / INT32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
