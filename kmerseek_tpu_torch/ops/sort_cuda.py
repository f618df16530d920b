"""Row sort of u64 keys: the bitonic kernel and its plain version.

Counterpart of ``kmerseek_tpu/ops/sort_pallas.py`` (TPU kernel
``_bitonic_kernel``, launcher ``bitonic_sort_rows``), which sorts
``(B, S)`` u64 values carried as (hi, lo) u32 pairs. The port carries
them as int64 bits (``ops.u64``) and sorts each row ascending in
unsigned order, so the u64::MAX sentinel (``-1``) sorts last.

* ``bitonic_sort_rows`` — the wrapper. A CUDA tensor launches the
  hand-written network ``csrc/bitonic_sort.cu`` (built at first use);
  a CPU tensor takes the plain version. The kernel reads the input
  (rows may be strided) and writes a fresh output: no clone, no pad.
  Any S works (the JAX launcher requires a power of two): the kernel
  fills the tail up to the power of two with sentinels in registers.
  Calls that launch the kernel are counted in
  ``bitonic_sort_rows.launches``; one call is one grid up to
  ``BLOCK_KEYS * cluster_blocks`` keys a row (131,072 with clusters of
  16) and ``sort_grid_launches`` grids beyond.
* ``bitonic_sort_rows_ref`` — the plain PyTorch version: ``torch.sort``
  on the sign-flipped keys.
* ``sort_plan`` / ``sort_grid_launches`` and the ``LOG_*`` constants —
  the kernel's schedule in Python, equal to the ``constexpr`` values of
  the ``.cu`` (``tests/test_torch_kernel_models.py`` reads the source
  and emulates the schedule in numpy).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from . import cuda_build
from .u64 import sort_key

SOURCE = "bitonic_sort.cu"

# The .cu's constants (kLogKeys, kLogWarp, kMaxLogWarps, kMaxClusterBlocks,
# kMinClusterLogWarps, kWarpKernelThreads, kSwizzleShift, kSwizzleSrcBit,
# kSwizzleDstBit).
LOG_KEYS = 3  # 2^3 keys in each thread's registers
LOG_WARP = 5
MAX_LOG_WARPS = 5  # at most 2^5 warps (1,024 threads) a block
MAX_CLUSTER_BLOCKS = 16  # 8 is the portable cluster size; an H100 schedules 16
MIN_CLUSTER_LOG_WARPS = 3  # a cluster's blocks hold 2,048 keys or more
WARP_KERNEL_THREADS = 256
SWIZZLE_SHIFT = LOG_KEYS + 1  # shared-memory index: bits 4..6 xor into bits 0..2
SWIZZLE_SRC_BIT = 2 * LOG_KEYS + LOG_WARP  # and bit 11 ...
SWIZZLE_DST_BIT = LOG_WARP - 2  # ... into bit 3
WARP_KEYS = 1 << (LOG_KEYS + LOG_WARP)  # 256: widest row one warp sorts
BLOCK_KEYS = WARP_KEYS << MAX_LOG_WARPS  # 8,192: widest row one block sorts


def _check_keys(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 2:
        raise TypeError(f"keys must be a (B, S) int64 tensor, got {keys.dtype} {tuple(keys.shape)}")


def bitonic_sort_rows_ref(keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: each row sorted ascending as u64."""
    _check_keys(keys)
    return sort_key(torch.sort(sort_key(keys), dim=1).values)


def sort_plan(
    S: int,
    cluster_blocks: int = MAX_CLUSTER_BLOCKS,
    *,
    log_keys: int = LOG_KEYS,
    log_warp: int = LOG_WARP,
    max_log_warps: int = MAX_LOG_WARPS,
    min_cluster_log_warps: int = MIN_CLUSTER_LOG_WARPS,
) -> Tuple[int, int, List[tuple]]:
    """The grids one call over rows of width ``S`` launches, in order.

    Returns ``(N, tile, grids)``: the padded power-of-two width ``N``,
    the keys one block or cluster holds on chip (``tile``), and the
    grids as ``("warp", log2 threads a row)``, ``("tile", blocks a
    cluster, keys a block, size_lo, size_hi)`` — every stage ``size`` in
    the range, each with its strides below ``min(size, tile)`` — or
    ``("global", size, j)``, one stride ``j >= tile`` over device
    memory. A row up to a block's keys is one block; a wider one takes
    a cluster of as many blocks as allowed, of 2,048 to 8,192 keys
    each. A row of ``N <= tile`` keys is one grid; wider rows take one
    tile grid, then per wider stage one device-memory grid per stride
    down to the tile and one more tile grid.
    """
    N = max(1 << max(S - 1, 0).bit_length(), 1 << log_keys)
    warp_keys = 1 << (log_keys + log_warp)
    block_keys = warp_keys << max_log_warps
    if N <= warp_keys:
        return N, N, [("warp", N.bit_length() - 1 - log_keys)]
    if N <= block_keys:
        return N, N, [("tile", 1, N, 2, N)]
    cs = min(N // (warp_keys << min_cluster_log_warps), cluster_blocks)
    nb = min(N // cs, block_keys)
    tile = nb * cs
    grids: List[tuple] = [("tile", cs, nb, 2, tile)]
    size = 2 * tile
    while size <= N:
        j = size // 2
        while j >= tile:
            grids.append(("global", size, j))
            j //= 2
        grids.append(("tile", cs, nb, size, size))
        size *= 2
    return N, tile, grids


def sort_grid_launches(S: int, cluster_blocks: int = MAX_CLUSTER_BLOCKS) -> int:
    """Kernel grids (each one pass over the row in device memory) that
    one ``bitonic_sort_rows`` call over rows of width ``S`` launches."""
    return len(sort_plan(S, cluster_blocks)[2])


# device index -> blocks a cluster may have there. The checks on a GPU
# lower an entry to drive the device-memory merge at small widths.
_cluster_blocks: Dict[int, int] = {}


def _library():
    lib = cuda_build.load(SOURCE)
    fn = lib.bitonic_sort_rows_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.bitonic_sort_max_cluster_blocks.argtypes = []
        lib.bitonic_sort_max_cluster_blocks.restype = ctypes.c_int
    return lib, fn


def max_cluster_blocks(device: torch.device) -> int:
    """Blocks a cluster of the sort kernel may have on ``device`` (16, 8,
    4 or 2; 1 where no cluster of the kernel's blocks can be
    scheduled), asked of the CUDA runtime once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _cluster_blocks:
        lib, _ = _library()
        with torch.cuda.device(index):
            _cluster_blocks[index] = max(int(lib.bitonic_sort_max_cluster_blocks()), 1)
    return _cluster_blocks[index]


def bitonic_sort_rows(keys: torch.Tensor) -> torch.Tensor:
    """Each row of ``(B, S)`` int64 keys sorted ascending as u64; returns a
    new contiguous tensor. Rows of the input may be strided (elements of
    a row adjacent). A CUDA input launches the kernel (or raises); a CPU
    input runs ``bitonic_sort_rows_ref``. The thread-block cluster, and
    with it the row width that stays on chip, is as large as
    ``max_cluster_blocks`` says the device allows."""
    if keys.device.type == "cpu":
        return bitonic_sort_rows_ref(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    _check_keys(keys)
    B, S = keys.shape
    out = torch.empty((B, S), dtype=torch.int64, device=keys.device)
    if B == 0 or S == 0:
        return out
    if S > 1 and keys.stride(1) != 1:
        keys = keys.contiguous()
    lib, fn = _library()
    cs = max_cluster_blocks(keys.device)
    N, tile, _ = sort_plan(S, cs)
    # rows wider than a cluster holds are merged in a (B, N) scratch
    scratch = torch.empty((B, N), dtype=torch.int64, device=keys.device) if N > tile else None
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        code = fn(
            keys.data_ptr(), keys.stride(0), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B, S, cs, stream,
        )
    cuda_build.check(lib, code, "bitonic_sort_rows")
    bitonic_sort_rows.launches += 1
    return out


bitonic_sort_rows.launches = 0
