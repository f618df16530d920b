"""MurmurHash3 x64_128 (first 64 bits) for k-mer windows, in PyTorch.

Counterpart of ``kmerseek_tpu/ops/murmur3.py``: sourmash's
``"0.murmur64"`` hash, seed 42, over the (alphabet-reduced) k-mer bytes,
keeping the first 64-bit lane.

* ``murmur64_kmer_windows`` — every length-k window of a ``(..., L)``
  byte tensor, hashed with elementwise int64 ops. int64 multiply and
  add wrap modulo 2^64 on both the CPU and CUDA, which is exactly the
  u64 arithmetic murmur needs; right shifts are made logical with a
  mask (``ops.u64.lsr``). This is the plain version the CUDA kernel is
  held against (``ops.sketch_cuda.masked_window_keys_ref``).
* ``murmur64_bytes_py`` — exact scalar Python oracle (copied).
"""

from __future__ import annotations

import torch

from .u64 import lsr, rotl, to_i64

_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F
MURMUR_SEED = 42  # sourmash seed

_C1_I = to_i64(_C1)
_C2_I = to_i64(_C2)
_F1_I = to_i64(0xFF51AFD7ED558CCD)
_F2_I = to_i64(0xC4CEB9FE1A85EC53)


def _fmix64(x: torch.Tensor) -> torch.Tensor:
    x = x ^ lsr(x, 33)
    x = x * _F1_I
    x = x ^ lsr(x, 33)
    x = x * _F2_I
    return x ^ lsr(x, 33)


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return rotl(k1 * _C1_I, 31) * _C2_I


def _mix_k2(k2: torch.Tensor) -> torch.Tensor:
    return rotl(k2 * _C2_I, 33) * _C1_I


def murmur64_kmer_windows(
    encoded: torch.Tensor, k: int, seed: int = MURMUR_SEED
) -> torch.Tensor:
    """Hash every length-k window of each row of a byte batch.

    Args:
      encoded: ``(..., L)`` uint8 tensor of already-encoded bytes.
      k: window length in bytes.

    Returns:
      int64 tensor of shape ``(..., L - k + 1)`` holding the u64 hash
      bits. The caller masks windows past each row's true length.
    """
    L = encoded.shape[-1]
    W = L - k + 1
    if W < 1:
        raise ValueError(f"padded length {L} shorter than k={k}")
    e = torch.nn.functional.pad(encoded.to(torch.int64), (0, 7))
    # little-endian u64 word starting at every byte position
    p8 = e[..., :L]
    for j in range(1, 8):
        p8 = p8 | (e[..., j : j + L] << (8 * j))

    def word(widx: int, nbytes: int = 8) -> torch.Tensor:
        """u64 word at byte offset 8*widx of every window, zero past k."""
        w = p8[..., 8 * widx : 8 * widx + W]
        if nbytes < 8:
            w = w & ((1 << (8 * nbytes)) - 1)
        return w

    h1 = torch.full(p8[..., :W].shape, seed, dtype=torch.int64, device=e.device)
    h2 = h1.clone()
    nblocks = k // 16
    for b in range(nblocks):
        h1 = h1 ^ _mix_k1(word(2 * b))
        h1 = rotl(h1, 27) + h2
        h1 = h1 * 5 + 0x52DCE729
        h2 = h2 ^ _mix_k2(word(2 * b + 1))
        h2 = rotl(h2, 31) + h1
        h2 = h2 * 5 + 0x38495AB5
    tail_len = k % 16
    if tail_len > 8:
        h2 = h2 ^ _mix_k2(word(2 * nblocks + 1, tail_len - 8))
    if tail_len > 0:
        h1 = h1 ^ _mix_k1(word(2 * nblocks, min(tail_len, 8)))
    h1 = h1 ^ k
    h2 = h2 ^ k
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    return h1 + h2


# ---------------------------------------------------------------------------
# Host-side scalar reference (oracle)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _rotl_py(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _fmix_py(x: int) -> int:
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & _M64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & _M64
    x ^= x >> 33
    return x


def murmur64_bytes_py(data: bytes, seed: int = MURMUR_SEED) -> int:
    """Scalar MurmurHash3 x64_128 first lane — host oracle."""
    h1 = h2 = seed & _M64
    n = len(data)
    nblocks = n // 16
    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16 : i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8 : i * 16 + 16], "little")
        k1 = (k1 * _C1) & _M64
        k1 = _rotl_py(k1, 31)
        k1 = (k1 * _C2) & _M64
        h1 ^= k1
        h1 = _rotl_py(h1, 27)
        h1 = (h1 + h2) & _M64
        h1 = (h1 * 5 + 0x52DCE729) & _M64
        k2 = (k2 * _C2) & _M64
        k2 = _rotl_py(k2, 33)
        k2 = (k2 * _C1) & _M64
        h2 ^= k2
        h2 = _rotl_py(h2, 31)
        h2 = (h2 + h1) & _M64
        h2 = (h2 * 5 + 0x38495AB5) & _M64
    tail = data[nblocks * 16 :]
    k1 = k2 = 0
    tl = len(tail)
    if tl > 8:
        for i in range(tl - 1, 7, -1):
            k2 ^= tail[i] << ((i - 8) * 8)
        k2 = (k2 * _C2) & _M64
        k2 = _rotl_py(k2, 33)
        k2 = (k2 * _C1) & _M64
        h2 ^= k2
    if tl > 0:
        for i in range(min(tl, 8) - 1, -1, -1):
            k1 ^= tail[i] << (i * 8)
        k1 = (k1 * _C1) & _M64
        k1 = _rotl_py(k1, 31)
        k1 = (k1 * _C2) & _M64
        h1 ^= k1
    h1 ^= n
    h2 ^= n
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    h1 = _fmix_py(h1)
    h2 = _fmix_py(h2)
    h1 = (h1 + h2) & _M64
    return h1
