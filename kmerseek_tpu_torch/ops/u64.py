"""Unsigned 64-bit values carried in int64 tensors.

The JAX package carries every u64 as a (hi, lo) uint32 pair because the
TPU has no 64-bit integers (``kmerseek_tpu/ops/u64.py``). CUDA and
PyTorch have int64, so the port keeps one int64 holding the u64's bits.
Three operations differ from their signed meaning and live here:

* logical right shift (torch's ``>>`` on int64 is arithmetic);
* unsigned order: flipping the sign bit maps u64 order onto int64
  order (``sort_key``), so ``torch.sort`` / comparisons on the flipped
  value order hashes as unsigned — u64::MAX (the sentinel, -1 as int64)
  sorts last;
* conversion between Python ints ≥ 2^63 and int64 bits.

The numpy ``split_np`` / ``join_np`` helpers convert to and from the
(hi, lo) layout of the JAX package's persisted arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

SIGN_BIT = -(1 << 63)  # int64 with only bit 63 set


def to_i64(value: int) -> int:
    """Python int in [0, 2^64) → the int64 with the same bits."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >= (1 << 63) else value


def lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical shift right of int64 bits by a static ``0 < r < 64``."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate the 64 bits left by a static ``0 < r < 64``."""
    return (x << r) | lsr(x, 64 - r)


def sort_key(x: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the u64 order of ``x`` (an involution)."""
    return x ^ SIGN_BIT


def le_u64(x: torch.Tensor, bound: int) -> torch.Tensor:
    """Unsigned ``x <= bound`` for a Python int bound in [0, 2^64)."""
    return sort_key(x) <= (to_i64(bound) ^ SIGN_BIT)


def split_np(values) -> Tuple[np.ndarray, np.ndarray]:
    """Host numpy uint64 array → (hi, lo) numpy uint32 arrays (byte view)."""
    v = np.asarray(values, dtype=np.uint64)
    if v.ndim == 0 or not np.little_endian:
        return (
            (v >> np.uint64(32)).astype(np.uint32),
            (v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        )
    w = np.ascontiguousarray(v).view(np.uint32).reshape(v.shape + (2,))
    return np.ascontiguousarray(w[..., 1]), np.ascontiguousarray(w[..., 0])


def join_np(hi, lo) -> np.ndarray:
    """(hi, lo) numpy uint32 arrays → numpy uint64 (byte view)."""
    hi = np.asarray(hi)
    lo = np.asarray(lo)
    if hi.ndim == 0 or not np.little_endian:
        return (hi.astype(np.uint64) << np.uint64(32)) | np.asarray(
            lo, dtype=np.uint64
        )
    out = np.empty(hi.shape + (2,), np.uint32)
    out[..., 0] = lo
    out[..., 1] = hi
    return out.view(np.uint64).reshape(hi.shape)


def tensor_to_u64_np(x: torch.Tensor) -> np.ndarray:
    """int64 tensor (any device) → numpy uint64 with the same bits."""
    return x.detach().cpu().numpy().view(np.uint64)


def u64_np_to_tensor(values, device=None) -> torch.Tensor:
    """numpy uint64 array → int64 tensor with the same bits."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)
