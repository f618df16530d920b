"""The fused sketch kernel: encode + murmur64 + scaled filter per window.

Counterpart of ``kmerseek_tpu/ops/sketch_pallas.py``'s
``masked_window_keys_pallas`` (TPU kernel ``_masked_sketch_kernel``).
For a padded ``(B, L)`` residue batch it returns, per window
``j < W = L - k + 1``, the sentinel-masked key (the u64 hash as int64
bits, ``-1`` = u64::MAX where the window is past the row's length or
above ``max_hash``) and the per-row kept count.

* ``masked_window_keys`` — the wrapper. A CUDA tensor launches the
  hand-written kernel ``csrc/masked_sketch.cu`` (built at first use);
  a CPU tensor takes the plain version. Launches are counted in
  ``masked_window_keys.launches``.
* ``masked_window_keys_ref`` — the plain PyTorch version, built from
  ``ops.murmur3.murmur64_kmer_windows``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import cuda_build
from .encoding import get_encoding_lut, max_hash_for_scaled
from .murmur3 import MURMUR_SEED, murmur64_kmer_windows
from .u64 import le_u64

SOURCE = "masked_sketch.cu"


def _check_inputs(seqs: torch.Tensor, lengths: torch.Tensor, k: int) -> None:
    if seqs.dtype != torch.uint8 or seqs.dim() != 2:
        raise TypeError(f"seqs must be a (B, L) uint8 tensor, got {seqs.dtype} {tuple(seqs.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (seqs.shape[0],):
        raise TypeError(
            f"lengths must be a (B,) int32 tensor, got {lengths.dtype} {tuple(lengths.shape)}"
        )
    if lengths.device != seqs.device:
        raise ValueError("seqs and lengths must be on the same device")
    if seqs.shape[1] < k:
        raise ValueError(f"padded length {seqs.shape[1]} shorter than k={k}")


def masked_window_keys_ref(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k: int,
    scaled: int,
    moltype: str,
    seed: int = MURMUR_SEED,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(keys (B, W) int64, n_kept (B,) int32)``."""
    _check_inputs(seqs, lengths, k)
    lut = torch.from_numpy(get_encoding_lut(moltype)).to(seqs.device)
    h = murmur64_kmer_windows(lut[seqs.long()], k, seed)
    win = torch.arange(h.shape[-1], device=seqs.device)
    in_range = win[None, :] < (lengths.long() - (k - 1))[:, None]
    keep = in_range & le_u64(h, max_hash_for_scaled(scaled))
    keys = torch.where(keep, h, torch.full_like(h, -1))
    return keys, keep.sum(dim=1, dtype=torch.int32)


def _launch_fn():
    lib = cuda_build.load(SOURCE)
    fn = lib.masked_window_keys_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_ulonglong, ctypes.c_ulonglong,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib, fn


def masked_window_keys(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k: int,
    scaled: int,
    moltype: str,
    seed: int = MURMUR_SEED,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sentinel-masked window keys + per-row kept counts.

    Args:
      seqs: ``(B, L)`` uint8 validated residues, contiguous.
      lengths: ``(B,)`` int32 true lengths (0 for padding rows).

    Returns ``(keys (B, L - k + 1) int64, n_kept (B,) int32)``. A CUDA
    input launches the kernel (or raises); a CPU input runs
    ``masked_window_keys_ref``.
    """
    if seqs.device.type == "cpu":
        return masked_window_keys_ref(
            seqs, lengths, k=k, scaled=scaled, moltype=moltype, seed=seed
        )
    if seqs.device.type != "cuda":
        raise ValueError(f"unsupported device {seqs.device}")
    _check_inputs(seqs, lengths, k)
    if not (seqs.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("seqs and lengths must be contiguous")
    B, L = seqs.shape
    W = L - k + 1
    keys = torch.empty((B, W), dtype=torch.int64, device=seqs.device)
    n_kept = torch.zeros((B,), dtype=torch.int32, device=seqs.device)
    if B == 0:
        return keys, n_kept
    lut = np.ascontiguousarray(get_encoding_lut(moltype))
    lib, fn = _launch_fn()
    with torch.cuda.device(seqs.device):
        stream = torch.cuda.current_stream(seqs.device).cuda_stream
        code = fn(
            seqs.data_ptr(), lengths.data_ptr(), keys.data_ptr(), n_kept.data_ptr(),
            B, L, k, max_hash_for_scaled(scaled), seed & ((1 << 64) - 1),
            lut.ctypes.data, stream,
        )
    cuda_build.check(lib, code, "masked_window_keys")
    masked_window_keys.launches += 1
    return keys, n_kept


masked_window_keys.launches = 0
