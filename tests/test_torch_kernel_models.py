"""CPU models of the two redesigned CUDA kernels' schedules.

The kernels themselves run only on a GPU. What can be held here is the
index arithmetic they are built on:

* the sort (``csrc/bitonic_sort.cu``): a numpy emulation of its schedule
  — which strides run between a thread's registers, by warp shuffle,
  through the shared-memory transposes, across the blocks of a cluster
  or as device-memory passes — with the layouts, the swizzle and the
  constants of the ``.cu`` (mirrored in ``ops/sort_cuda.py`` and
  asserted equal to the source text), equals ``np.sort``;
* the hash (``csrc/murmur64.cuh``): the rolling-word assembly — a
  thread's run of bytes held as 32-bit words, each window's 64-bit words
  cut out by funnel shifts — gives ``int.from_bytes(..., "little")`` for
  every word of every window, and through the scalar mixing steps the
  hash of ``ops.murmur3.murmur64_bytes_py``;
* the window-hash kernel's stores (``csrc/window_hashes.cu``): a thread's
  four keep flags packed into one 32-bit word are the bytes four ``bool``
  stores would write, and the choice between vector and scalar stores by
  the alignment of ``row * W + j0`` writes every element of the
  ``(B, W)`` outputs exactly once, vector stores only where aligned.
"""

import os
import re

import numpy as np
import pytest
import torch

from kmerseek_tpu_torch.ops import murmur3, sort_cuda
from kmerseek_tpu_torch.ops.sort_cuda import bitonic_sort_rows, sort_grid_launches, sort_plan

CSRC = os.path.join(os.path.dirname(sort_cuda.__file__), "..", "csrc")
U64_MAX = np.uint64(2**64 - 1)


def _constexprs(text: str, *names: str) -> dict:
    """``constexpr int`` values of a CUDA source, in the order given (a
    value may be an expression of the ones before it)."""
    env = {}
    for name in names:
        m = re.search(rf"constexpr\s+int\s+{name}\s*=\s*([^;]+);", text)
        assert m, f"{name} not found"
        env[name] = int(eval(m.group(1), {"__builtins__": {}}, dict(env)))  # noqa: S307
    return env


def _read(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# ---------------------------------------------------------------------------
# the sort
# ---------------------------------------------------------------------------


class SortModel:
    """The schedule of ``bitonic_sort.cu`` over one row, in numpy.

    A thread holds ``E = 2^e`` keys. Position bits of a key inside its
    block: layout A is ``thread | register`` (a thread owns ``E``
    adjacent keys, a warp ``E * 32``); layout B moves the position bits
    above a warp's span into the register index and, when they outnumber
    it, the high lane bits. Keys enter and leave through shared memory,
    lanes on adjacent keys on the global side. Every stage runs
    ascending on keys that are complemented where the network sorts
    descending.
    """

    def __init__(self, log_keys=sort_cuda.LOG_KEYS, log_warp=sort_cuda.LOG_WARP,
                 max_log_warps=sort_cuda.MAX_LOG_WARPS):
        self.e, self.lb, self.hmax = log_keys, log_warp, max_log_warps
        self.hmin = min(sort_cuda.MIN_CLUSTER_LOG_WARPS, max_log_warps)
        self.E = 1 << log_keys
        self.low = log_keys + log_warp  # position bits a warp spans
        self.swz_shift = log_keys + 1
        self.swz_src = 2 * log_keys + log_warp
        self.swz_dst = log_warp - 2
        self.steps = {"register": 0, "shuffle": 0, "transpose": 0, "cluster": 0, "global": 0}

    # -- index maps (the .cu's pos_a, pos_b, swizzle) -----------------------

    def pos_a(self, tid, r):
        return (tid << self.e) | r

    def split_b(self, H):
        hr = min(H, self.e)
        return hr, H - hr

    def pos_b(self, H, warp, lane, r):
        hr, hl = self.split_b(H)
        e, lb, low = self.e, self.lb, self.low
        return (
            (lane & ((1 << (lb - hl)) - 1))
            | ((r & ((1 << (e - hr)) - 1)) << (lb - hl))
            | (warp << (low - H))
            | ((r >> (e - hr)) << low)
            | ((lane >> (lb - hl)) << (low + hr))
        )

    def swizzle(self, p):
        return (
            p ^ ((p >> self.swz_shift) & (self.E - 1))
            ^ (((p >> self.swz_src) & 1) << self.swz_dst)
        )

    # -- compare-exchange steps, ascending ----------------------------------

    def reg_step(self, regs, m):
        self.steps["register"] += 1
        for r in range(self.E):
            if not r & m:
                a, b = regs[..., r].copy(), regs[..., r | m].copy()
                regs[..., r], regs[..., r | m] = np.minimum(a, b), np.maximum(a, b)

    def shfl_step(self, regs, mask):
        self.steps["shuffle"] += 1
        t = np.arange(regs.shape[-2])
        other = regs[..., t ^ mask, :]
        lower = ((t & mask) == 0)[:, None]
        regs[...] = np.where(lower, np.minimum(regs, other), np.maximum(regs, other))

    def low_phase(self, regs, size, lt):
        """Strides below a warp's span (``2^(lt + e)`` keys), layout A."""
        for b in range(lt + self.e - 1, -1, -1):
            if (1 << b) < size:
                if b < self.e:
                    self.reg_step(regs, 1 << b)
                else:
                    self.shfl_step(regs, 1 << (b - self.e))

    def high_phase(self, regs, size, H):
        """Strides from a warp's span up to the block's, layout B."""
        hr, hl = self.split_b(H)
        for hb in range(H - 1, -1, -1):
            if ((1 << self.low) << hb) < size:
                if hb < hr:
                    self.reg_step(regs, 1 << (self.e - hr + hb))
                else:
                    self.shfl_step(regs, 1 << (self.lb - hl + hb - hr))

    def transpose(self, regs, src, dst, staging=False):
        """Through shared memory: written at ``src`` positions, read at
        ``dst`` positions (both swizzled). ``staging``: the coalesced
        load or store of a kernel, not a step of the network."""
        self.steps["transpose"] += not staging
        smem = np.zeros(regs.shape[:-2] + (regs.shape[-2] * self.E,), np.uint64)
        q = self.swizzle(src).reshape(-1)
        assert len(np.unique(q)) == q.size == smem.shape[-1]  # a bijection
        smem[..., q] = regs.reshape(regs.shape[:-2] + (-1,))
        return smem[..., self.swizzle(dst).reshape(-1)].reshape(regs.shape)

    # -- kernels ------------------------------------------------------------

    def flip_between(self, regs, p, a, b):
        regs ^= np.where(((p & a) != 0) != ((p & b) != 0), U64_MAX, np.uint64(0))

    def warp_kernel(self, row, lt):
        """One row of ``E << lt`` keys in ``2^lt`` lanes: staged through the
        warp's slice of shared memory, no block barrier."""
        S, tpr = len(row), 1 << lt
        t, r = np.arange(tpr)[:, None], np.arange(self.E)[None, :]
        striped, pa = (r << lt) | t, self.pos_a(t, r)
        regs = np.where(striped < S, row[np.minimum(striped, S - 1)], U64_MAX)
        regs = self.transpose(regs, striped, pa, staging=True)
        size, prev = 2, 0
        while size <= self.E << lt:
            self.flip_between(regs, pa, prev, size)
            self.low_phase(regs, size, lt)
            size, prev = size * 2, size
        self.flip_between(regs, pa, prev, 0)
        regs = self.transpose(regs, pa, striped, staging=True)
        out = np.empty(S, np.uint64)
        out[striped[striped < S]] = regs[striped < S]
        return out

    def tile_kernel(self, mem, valid, n_out, N, cs, nb, size_lo, size_hi):
        """Every tile of ``cs`` blocks of ``nb`` keys of a row: stages
        ``size_lo`` .. ``size_hi``, strides below the tile. ``mem`` holds
        ``valid`` keys; returns ``n_out`` keys of the ``N`` positions."""
        H = nb.bit_length() - 1 - self.low
        T = nb // self.E
        n_blocks = N // nb
        tid = np.arange(T)[:, None]
        warp, lane, r = tid >> self.lb, tid & ((1 << self.lb) - 1), np.arange(self.E)[None, :]
        striped, pa, pb = r * T + tid, self.pos_a(tid, r), self.pos_b(H, warp, lane, r)
        block_off = (np.arange(n_blocks) * nb)[:, None, None]
        g_in = block_off + striped[None]
        regs = np.where(g_in < valid, mem[np.minimum(g_in, valid - 1)], U64_MAX)
        regs = self.transpose(regs, striped, pa, staging=True)
        g = block_off + pa[None]
        rank = np.arange(n_blocks) % cs
        size, prev = size_lo, 0
        while size <= size_hi:
            self.flip_between(regs, g, prev, size)
            j = min(size, nb * cs) // 2
            while j >= nb:  # the partner block's registers, through its shared memory
                self.steps["cluster"] += 1
                partner = np.arange(n_blocks) ^ (j // nb)
                other = regs[partner]
                lower = ((rank * nb) & j == 0)[:, None, None]
                regs = np.where(lower, np.minimum(regs, other), np.maximum(regs, other))
                j //= 2
            if size > (1 << self.low):
                regs = self.transpose(regs, pa, pb)
                self.high_phase(regs, size, H)
                regs = self.transpose(regs, pb, pa)
            self.low_phase(regs, size, self.lb)
            size, prev = size * 2, size
        self.flip_between(regs, g, prev, 0)
        regs = self.transpose(regs, pa, striped, staging=True)
        out = np.full(N, U64_MAX)
        out[g_in.reshape(-1)] = regs.reshape(-1)
        return out[:n_out]

    def global_kernel(self, mem, size, j):
        self.steps["global"] += 1
        i = np.arange(len(mem))
        i = i[(i & j) == 0]
        a, b = mem[i], mem[i + j]
        swap = np.where((i & size) == 0, a > b, a < b)
        mem[i], mem[i + j] = np.where(swap, b, a), np.where(swap, a, b)

    def sort_row(self, row, cluster_blocks):
        S = len(row)
        N, tile, grids = sort_plan(
            S, cluster_blocks, log_keys=self.e, log_warp=self.lb, max_log_warps=self.hmax,
            min_cluster_log_warps=self.hmin,
        )
        mem, valid = row, S
        for n, grid in enumerate(grids):
            last = n == len(grids) - 1
            if grid[0] == "warp":
                return self.warp_kernel(row, grid[1])
            if grid[0] == "tile":
                mem = self.tile_kernel(mem, valid, S if last else N, N, *grid[1:])
                valid = N
            else:
                self.global_kernel(mem, grid[1], grid[2])
        return mem


def _sort_rows(rng, B, S):
    vals = rng.integers(0, 2**64, size=(B, S), dtype=np.uint64)
    vals[:, ::7] = vals[:, :1]  # duplicates
    vals[:, -min(3, S):] = U64_MAX  # sentinels
    vals[0, : min(S, 2)] = 2**63  # the sign bit alone
    return vals


def test_sort_constants_equal_the_cuda_source():
    text = _read("bitonic_sort.cu")
    want = {
        "kLogKeys": sort_cuda.LOG_KEYS,
        "kLogWarp": sort_cuda.LOG_WARP,
        "kMaxLogWarps": sort_cuda.MAX_LOG_WARPS,
        "kMaxClusterBlocks": sort_cuda.MAX_CLUSTER_BLOCKS,
        "kMinClusterLogWarps": sort_cuda.MIN_CLUSTER_LOG_WARPS,
        "kWarpKernelThreads": sort_cuda.WARP_KERNEL_THREADS,
        "kSwizzleShift": sort_cuda.SWIZZLE_SHIFT,
        "kSwizzleSrcBit": sort_cuda.SWIZZLE_SRC_BIT,
        "kSwizzleDstBit": sort_cuda.SWIZZLE_DST_BIT,
    }
    assert _constexprs(text, *want) == want
    assert sort_cuda.WARP_KEYS == 256 and sort_cuda.BLOCK_KEYS == 8192
    # the index maps that SortModel re-types, as the source writes them
    flat = re.sub(r"\s+", " ", text)
    for line in (
        "int pos_a(int tid, int r) { return (tid << kLogKeys) | r; }",
        "return p ^ ((p >> kSwizzleShift) & (kKeys - 1)) ^ "
        "(((p >> kSwizzleSrcBit) & 1) << kSwizzleDstBit);",
        "static constexpr int kHr = H < kLogKeys ? H : kLogKeys; "
        "static constexpr int kHl = H - kHr;",
        "return (lane & ((1 << (kLogWarp - kHl)) - 1)) | "
        "((r & ((1 << (kLogKeys - kHr)) - 1)) << (kLogWarp - kHl)) | "
        "(warp << (kLow - H)) | ((r >> (kLogKeys - kHr)) << kLow) | "
        "((lane >> (kLogWarp - kHl)) << (kLow + kHr));",
    ):
        assert line in flat, line
    # no library sort and no fixed tile in the kernel source or the wrapper
    with open(sort_cuda.__file__) as f:
        wrapper = f.read().split("def bitonic_sort_rows(")[1]
    assert "torch.sort" not in wrapper and "clone" not in wrapper and "pad(" not in wrapper
    assert "cub" not in text.lower() and "thrust" not in text.lower()


@pytest.mark.parametrize(
    "S", [1, 2, 3, 8, 9, 100, 203, 256, 257, 357, 664, 1024, 1278, 2507, 4965, 8192]
)
def test_sort_model_one_grid_widths(S):
    """Real constants: one warp (S <= 256) or one block (S <= 8,192)."""
    vals = _sort_rows(np.random.default_rng(S), 2, S)
    model = SortModel()
    for row in vals:
        assert np.array_equal(model.sort_row(row, 16), np.sort(row))
    assert sort_grid_launches(S) == 1
    assert model.steps["cluster"] == model.steps["global"] == 0
    assert (model.steps["transpose"] == 0) == (S <= 256)


@pytest.mark.parametrize(
    "S,cluster_blocks,grids",
    [(9000, 8, 1), (16384, 16, 1), (39370, 8, 1), (65536, 8, 1), (65536, 16, 1), (100000, 16, 1),
     (65536, 1, 10), (39370, 2, 6), (70000, 8, 3)],
)
def test_sort_model_cluster_and_merge_widths(S, cluster_blocks, grids):
    """Real constants: rows a cluster holds in distributed shared memory
    (one grid), and rows beyond it merged through device memory."""
    row = _sort_rows(np.random.default_rng(S + cluster_blocks), 1, S)[0]
    model = SortModel()
    assert np.array_equal(model.sort_row(row, cluster_blocks), np.sort(row))
    assert sort_grid_launches(S, cluster_blocks) == grids
    assert (model.steps["global"] > 0) == (grids > 1)
    assert model.steps["cluster"] > 0 or cluster_blocks == 1


@pytest.mark.parametrize("log_keys,log_warp,max_log_warps", [(1, 2, 2), (2, 2, 1), (1, 3, 3), (3, 2, 4)])
@pytest.mark.parametrize("cluster_blocks", [1, 2, 4])
def test_sort_model_tiny_constants(log_keys, log_warp, max_log_warps, cluster_blocks):
    """Tiny tiles drive every class of stride at small S, for every S
    from 2 to 300 and a few larger."""
    model = SortModel(log_keys, log_warp, max_log_warps)
    rng = np.random.default_rng(log_keys * 100 + log_warp * 10 + cluster_blocks)
    for S in list(range(2, 301)) + [511, 1000, 2048, 5000]:
        row = _sort_rows(rng, 1, S)[0]
        assert np.array_equal(model.sort_row(row, cluster_blocks), np.sort(row)), S
    assert all(n for kind, n in model.steps.items() if kind != "cluster" or cluster_blocks > 1)


@pytest.mark.parametrize("H", [1, 2, 3, 4, 5])
def test_sort_shared_memory_accesses_do_not_collide(H):
    """8-byte shared-memory accesses are served a half-warp at a time
    over 32 four-byte banks: in the three layouts (A, B and the striped
    one of loads and stores), for every register index, the 16 lanes of
    a half-warp hit 16 different 8-byte slots."""
    m = SortModel()
    T = 32 << H
    tid = np.arange(T)
    warp, lane = tid >> 5, tid & 31
    for r in range(m.E):
        for p in (m.pos_a(tid, r), m.pos_b(H, warp, lane, r), r * T + tid):
            slots = (m.swizzle(p) % 16).reshape(-1, 16)  # half-warps of adjacent lanes
            assert all(len(set(s)) == 16 for s in slots), (H, r)
    # the layouts are bijections of (thread, register) onto the block's keys
    r = np.arange(m.E)[None, :]
    for p in (m.pos_a(tid[:, None], r), m.pos_b(H, warp[:, None], lane[:, None], r)):
        assert np.array_equal(np.sort(p.reshape(-1)), np.arange(T * m.E))


@pytest.mark.parametrize("B,S", [(1, 1), (3, 1), (2, 2), (3, 203), (0, 5), (0, 0)])
def test_sort_wrapper_contract_on_cpu(B, S):
    rng = np.random.default_rng(B * 1000 + S)
    vals = rng.integers(0, 2**64, size=(B, S), dtype=np.uint64)
    keys = torch.from_numpy(vals.view(np.int64).copy())
    before = bitonic_sort_rows.launches
    got = bitonic_sort_rows(keys)
    assert bitonic_sort_rows.launches == before  # the plain version on the CPU
    assert got.shape == (B, S) and got.dtype == torch.int64
    assert got.data_ptr() != keys.data_ptr() or keys.numel() == 0
    assert np.array_equal(got.numpy().view(np.uint64), np.sort(vals, axis=1))
    # a strided view (rows one slot apart) sorts like its contiguous copy
    wide = torch.from_numpy(np.concatenate([vals, vals[:, :1]], axis=1).view(np.int64).copy())
    assert torch.equal(bitonic_sort_rows(wide[:, :S]), got)


@pytest.mark.cuda
def test_sort_kernel_matches_np_sort_on_card():
    """Every width class on the GPU, also with the cluster capped so that
    rows are merged through device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kmerseek_tpu_torch.ops.sort_cuda import max_cluster_blocks

    allowed = max_cluster_blocks(torch.device("cuda"))
    rng = np.random.default_rng(0)
    for B, S, cs in [(5, 1, None), (9, 203, None), (4, 2507, None), (3, 39370, None),
                     (2, 65536, 1), (2, 39370, 2), (2, 150000, None)]:
        vals = _sort_rows(rng, B, S)
        keys = torch.from_numpy(vals.view(np.int64).copy()).cuda()
        index = torch.cuda.current_device()
        sort_cuda._cluster_blocks[index] = allowed if cs is None else min(cs, allowed)
        try:
            got = bitonic_sort_rows(keys)
        finally:
            sort_cuda._cluster_blocks[index] = allowed
        assert np.array_equal(got.cpu().numpy().view(np.uint64), np.sort(vals, axis=1)), (B, S, cs)


# ---------------------------------------------------------------------------
# the hash: rolling words
# ---------------------------------------------------------------------------


def funnelshift_r(lo: int, hi: int, shift: int) -> int:
    """CUDA's ``__funnelshift_r``: the low 32 bits of ``(hi:lo) >> shift``
    for ``shift`` < 32."""
    return (((hi << 32) | lo) >> (shift & 31)) & 0xFFFFFFFF


def word_at(w32, offset: int, nbytes: int) -> int:
    """The .cuh's ``word_at<O, N>``: the little-endian u64 of ``nbytes``
    (1..8) bytes at byte ``offset`` of a run held as 32-bit words."""
    q, s = divmod(offset, 4)
    s *= 8
    lo = funnelshift_r(w32[q], w32[q + 1], s) if s else w32[q]
    hi = 0
    if nbytes > 4:
        hi = funnelshift_r(w32[q + 1], w32[q + 2], s) if s else w32[q + 1]
    v = (hi << 32) | lo
    if nbytes < 8:
        v &= (1 << (8 * nbytes)) - 1
    return v


def run_words(k: int, windows: int) -> int:
    """The .cuh's ``kRunWords<K>``: 32-bit words a thread loads for
    ``windows`` adjacent windows of ``k`` bytes (two spare words keep
    every ``word_at`` index inside the array)."""
    return (windows + k - 1 + 3) // 4 + 2


def rolling_murmur(w32, i: int, k: int, seed: int = murmur3.MURMUR_SEED) -> int:
    """Window ``i`` of a run: the .cuh's ``murmur64_run<K>`` — the words
    by ``word_at``, mixed by the scalar oracle's own steps."""
    M = (1 << 64) - 1
    rotl = murmur3._rotl_py
    c1, c2 = murmur3._C1, murmur3._C2

    def mix1(x):
        return (rotl((x * c1) & M, 31) * c2) & M

    def mix2(x):
        return (rotl((x * c2) & M, 33) * c1) & M

    h1 = h2 = seed
    nblocks, tl = divmod(k, 16)
    for b in range(nblocks):
        h1 ^= mix1(word_at(w32, i + 16 * b, 8))
        h1 = ((rotl(h1, 27) + h2) * 5 + 0x52DCE729) & M
        h2 ^= mix2(word_at(w32, i + 16 * b + 8, 8))
        h2 = ((rotl(h2, 31) + h1) * 5 + 0x38495AB5) & M
    if tl > 8:
        h2 ^= mix2(word_at(w32, i + 16 * nblocks + 8, tl - 8))
    if tl > 0:
        h1 ^= mix1(word_at(w32, i + 16 * nblocks, min(tl, 8)))
    h1 ^= k
    h2 ^= k
    h1 = (h1 + h2) & M
    h2 = (h2 + h1) & M
    return (murmur3._fmix_py(h1) + murmur3._fmix_py(h2)) & M


@pytest.mark.parametrize("k", list(range(1, 33)) + [40, 57])
def test_rolling_words_equal_bytes_and_the_scalar_murmur(k):
    windows = _constexprs(_read("murmur64.cuh"), "kRun")["kRun"]
    rng = np.random.default_rng(k)
    for _ in range(3):
        nw = run_words(k, windows)
        data = bytes(rng.integers(0, 256, size=4 * nw, dtype=np.uint8))
        w32 = [int.from_bytes(data[4 * n : 4 * n + 4], "little") for n in range(nw)]
        for i in range(windows):
            window = data[i : i + k]
            for w in range((k + 7) // 8):
                n = min(8, k - 8 * w)
                want = int.from_bytes(window[8 * w : 8 * w + 8], "little")
                assert word_at(w32, i + 8 * w, n) == want, (k, i, w)
            assert rolling_murmur(w32, i, k) == murmur3.murmur64_bytes_py(window), (k, i)


@pytest.mark.parametrize("source", ["masked_sketch.cu", "window_hashes.cu"])
def test_hash_constants_equal_the_cuda_source(source):
    assert _constexprs(_read("murmur64.cuh"), "kRun", "kMaxK", "kMaxThreads") == {
        "kRun": 4, "kMaxK": 128, "kMaxThreads": 256,
    }
    text = _read(source)
    # k compiled in for the CLI default and the smoke run's widths, plus
    # the run-time version (K = 0), in both kernels' launch functions
    for k in (5, 10, 16, 24):
        assert re.search(rf"case {k}:", text), k
    assert "default:" in text
    from kmerseek_tpu_torch.ops import sketch_cuda

    assert sketch_cuda.COMPILED_KS == tuple(
        int(x) for x in re.findall(r"case (\d+):", text)
    )


# ---------------------------------------------------------------------------
# the window-hash kernel's stores
# ---------------------------------------------------------------------------

RUN = 4  # kRun


def run_threads(W: int) -> int:
    """The .cuh's ``run_threads``: threads of a block by the row's windows."""
    return 64 if W <= 64 * RUN else (128 if W <= 128 * RUN else 256)


def pack_keep(flags) -> int:
    """The kernel's ``flags`` word: byte i = keep of window j0 + i."""
    word = 0
    for i, f in enumerate(flags):
        word |= int(bool(f)) << (8 * i)
    return word


@pytest.mark.parametrize("bits", range(16))
def test_keep_word_equals_four_bool_stores(bits):
    flags = [bool(bits >> i & 1) for i in range(RUN)]
    as_bools = np.array(flags, np.bool_)  # what four one-byte stores leave
    assert np.array([pack_keep(flags)], "<u4").tobytes() == as_bools.tobytes()
    assert torch.frombuffer(bytearray(as_bools.tobytes()), dtype=torch.bool).tolist() == flags


def store_model(B: int, W: int, hash_base: int = 0, keep_base: int = 0):
    """The store stage of ``window_hashes_kernel`` over a (B, W) output:
    every thread's run, its path by the kernel's tests (``whole``, ``o & 1``,
    ``o & 3``, and the launch function's pointer tests), written into flat
    buffers. Returns (hash writes per element, keep writes per element,
    {path: runs}) and asserts that a vector store is aligned."""
    threads = run_threads(W)
    tile = threads * RUN
    tiles = (W + tile - 1) // tile
    vec_hash = hash_base % 16 == 0
    vec_keep = keep_base % 4 == 0
    n_hash = np.zeros(B * W, np.int64)
    n_keep = np.zeros(B * W, np.int64)
    paths = {"hash16": 0, "hash8": 0, "keep4": 0, "keep1": 0}
    for row in range(B):
        for t in range(tiles):
            for tid in range(threads):
                j0 = t * tile + tid * RUN
                if j0 >= W:
                    continue
                o = row * W + j0
                whole = j0 + RUN <= W
                if vec_hash and whole and (o & 1) == 0:
                    assert (hash_base + 8 * o) % 16 == 0
                    n_hash[o : o + RUN] += 1
                    paths["hash16"] += 1
                else:
                    n_hash[o : o + min(RUN, W - j0)] += 1
                    paths["hash8"] += 1
                if vec_keep and whole and (o & 3) == 0:
                    assert (keep_base + o) % 4 == 0
                    n_keep[o : o + RUN] += 1
                    paths["keep4"] += 1
                else:
                    n_keep[o : o + min(RUN, W - j0)] += 1
                    paths["keep1"] += 1
    return n_hash, n_keep, paths


@pytest.mark.parametrize(
    "B,W,bases,expect",
    [
        (8, 1001, (0, 0), "odd"),  # L = 1024, k = 24: the timed shape
        (8, 1000, (0, 0), "all_vector"),
        (6, 498, (0, 0), "even"),  # W = 2 mod 4: 128-thread tiles
        (5, 253, (0, 0), "odd"),  # one 64-thread tile a row
        (3, 3, (0, 0), "all_scalar"),  # shorter than a run
        (4, 1000, (8, 2), "all_scalar"),  # unaligned output pointers
    ],
)
def test_window_hash_store_paths_cover_every_element_once(B, W, bases, expect):
    n_hash, n_keep, paths = store_model(B, W, *bases)
    assert (n_hash == 1).all() and (n_keep == 1).all()
    runs = B * ((W + RUN - 1) // RUN)
    assert paths["hash16"] + paths["hash8"] == paths["keep4"] + paths["keep1"] == runs
    whole = B * (W // RUN)
    if expect == "all_vector":
        assert paths["hash16"] == paths["keep4"] == runs
    elif expect == "all_scalar":
        assert paths["hash16"] == paths["keep4"] == 0
    elif expect == "odd":  # rows 0, 4: keep words; rows 0, 2, 4, 6: 16-byte hashes
        assert paths["keep4"] == -(-B // 4) * (W // RUN)
        assert paths["hash16"] == -(-B // 2) * (W // RUN)
        assert 0 < paths["keep4"] < paths["hash16"] < whole
    else:  # W = 2 mod 4: every row's start is even, every other a multiple of 4
        assert paths["hash16"] == whole and paths["keep4"] == -(-B // 2) * (W // RUN)


def test_window_hash_store_tests_are_in_the_source():
    text = _read("window_hashes.cu")
    header = _read("murmur64.cuh")
    assert "vec_hash && whole && (o & 1) == 0" in text
    assert "vec_keep && whole && (o & 3) == 0" in text
    assert "(uintptr_t)hashes % 16 == 0" in text and "(uintptr_t)keep % 4 == 0" in text
    assert "<< (8 * i)" in text  # byte i of the flags word = window j0 + i
    assert "W <= 64 * kRun ? 64 : (W <= 128 * kRun ? 128 : kMaxThreads)" in header
    assert "atomic" not in text.split("#include", 1)[1] and "cudaMemset" not in text
