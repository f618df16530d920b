"""The fused sketch kernels: encode + murmur64 + scaled filter per window.

Counterpart of ``kmerseek_tpu/ops/sketch_pallas.py``'s two hash
launchers. For a padded ``(B, L)`` residue batch and every window
``j < W = L - k + 1``:

* ``masked_window_keys`` (TPU kernel ``_masked_sketch_kernel``, CUDA
  ``csrc/masked_sketch.cu``) returns the sentinel-masked key (the u64
  hash as int64 bits, ``-1`` = u64::MAX where the window is past the
  row's length or above ``max_hash``) and the per-row kept count;
* ``window_hashes`` (TPU kernel ``_sketch_kernel``, CUDA
  ``csrc/window_hashes.cu``) returns every window's raw hash and a
  ``bool`` keep mask.

Each wrapper launches its hand-written kernel (built at first use) on a
CUDA tensor and takes its plain PyTorch version (``*_ref``, built from
``ops.murmur3.murmur64_kmer_windows``) on a CPU tensor. Launches are
counted in ``<wrapper>.launches``. Both kernels have k compiled in for
``COMPILED_KS`` and a run-time-k version for every other k up to 128;
both read the 256-byte LUT from a device table cached per moltype and
device (``encoding_lut``), and the masked kernel zeroes its own counts,
so a call costs the host two ``torch.empty`` and one ctypes call.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import cuda_build
from .encoding import get_encoding_lut, max_hash_for_scaled
from .murmur3 import MURMUR_SEED, murmur64_kmer_windows
from .u64 import le_u64

SOURCE = "masked_sketch.cu"
WINDOW_SOURCE = "window_hashes.cu"
# the k that both launch functions have a compiled version of
COMPILED_KS = (5, 10, 16, 24)

_lut_cache: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def encoding_lut(moltype: str, device: torch.device) -> torch.Tensor:
    """The moltype's 256-byte encoding LUT as a uint8 tensor on ``device``,
    made once per (moltype, device)."""
    key = (moltype, device)
    lut = _lut_cache.get(key)
    if lut is None:
        lut = _lut_cache[key] = torch.from_numpy(get_encoding_lut(moltype).copy()).to(device)
    return lut


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


def window_hashes_ref(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k: int,
    scaled: int,
    moltype: str,
    seed: int = MURMUR_SEED,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(hashes (B, W) int64, keep (B, W) bool)``."""
    _check_inputs(seqs, lengths, k)
    h = murmur64_kmer_windows(encoding_lut(moltype, seqs.device)[seqs.long()], k, seed)
    win = torch.arange(h.shape[-1], device=seqs.device)
    in_range = win[None, :] < (lengths.long() - (k - 1))[:, None]
    return h, in_range & le_u64(h, max_hash_for_scaled(scaled))


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
    h, keep = window_hashes_ref(seqs, lengths, k=k, scaled=scaled, moltype=moltype, seed=seed)
    keys = torch.where(keep, h, torch.full_like(h, -1))
    return keys, keep.sum(dim=1, dtype=torch.int32)


def _launch(source, symbol, what, seqs, lengths, out0, out1, k, scaled, moltype, seed):
    """Check a CUDA input pair and launch one hash kernel into out0/out1.
    Both take (seqs, lengths, out0, out1, B, L, k, max_hash, seed, lut,
    stream) and read ``lut`` from the cached device table."""
    _check_inputs(seqs, lengths, k)
    if not (seqs.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("seqs and lengths must be contiguous")
    B, L = seqs.shape
    if B == 0:
        return
    lut = encoding_lut(moltype, seqs.device)
    lib = cuda_build.load(source)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_ulonglong, ctypes.c_ulonglong,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    with torch.cuda.device(seqs.device):
        stream = torch.cuda.current_stream(seqs.device).cuda_stream
        code = fn(
            seqs.data_ptr(), lengths.data_ptr(), out0.data_ptr(), out1.data_ptr(),
            B, L, k, max_hash_for_scaled(scaled), seed & ((1 << 64) - 1),
            lut.data_ptr(), stream,
        )
    cuda_build.check(lib, code, what)


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
    B, L = seqs.shape
    keys = torch.empty((B, max(L - k + 1, 0)), dtype=torch.int64, device=seqs.device)
    n_kept = torch.empty((B,), dtype=torch.int32, device=seqs.device)  # the launch zeroes it
    _launch(SOURCE, "masked_window_keys_launch", "masked_window_keys",
            seqs, lengths, keys, n_kept, k, scaled, moltype, seed)
    if B:
        masked_window_keys.launches += 1
    return keys, n_kept


masked_window_keys.launches = 0


def window_hashes(
    seqs: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k: int,
    scaled: int,
    moltype: str,
    seed: int = MURMUR_SEED,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every window's raw hash + keep mask.

    Args:
      seqs: ``(B, L)`` uint8 validated residues, contiguous.
      lengths: ``(B,)`` int32 true lengths (0 for padding rows).

    Returns ``(hashes (B, L - k + 1) int64, keep (B, L - k + 1) bool)``:
    the hash of every window, also those past a row's length (they hash
    the padding), and ``keep`` = inside the row and ``hash <= max_hash``.
    A CUDA input launches the kernel (or raises); a CPU input runs
    ``window_hashes_ref``.
    """
    if seqs.device.type == "cpu":
        return window_hashes_ref(
            seqs, lengths, k=k, scaled=scaled, moltype=moltype, seed=seed
        )
    if seqs.device.type != "cuda":
        raise ValueError(f"unsupported device {seqs.device}")
    B, L = seqs.shape
    W = max(L - k + 1, 0)
    hashes = torch.empty((B, W), dtype=torch.int64, device=seqs.device)
    keep = torch.empty((B, W), dtype=torch.bool, device=seqs.device)
    _launch(WINDOW_SOURCE, "window_hashes_launch", "window_hashes",
            seqs, lengths, hashes, keep, k, scaled, moltype, seed)
    if B:
        window_hashes.launches += 1
    return hashes, keep


window_hashes.launches = 0
