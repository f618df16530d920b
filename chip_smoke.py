"""Smoke run of the PyTorch/CUDA port on one GPU: build, kernel checks,
and the port's five paths at the scale of a human reference proteome.

    python3 chip_smoke.py [--seed N] [--kernels-only]

(``--kernels-only`` stops after phase 3 and prints no result line: the
quick check of a kernel edit. ``--path-d-worker RANK`` is how the script
starts itself as one rank of path D's process group.)

Phases (each prints its lines; any failure exits non-zero):

1. environment: torch version, the card's name and power limit; no CUDA
   device → exit 2;
2. build: compile every CUDA source of the port (one nvcc each, in
   parallel);
3. kernels vs their plain versions on the card, tolerance 0:
   ``masked_window_keys`` and ``window_hashes`` for 3 moltypes × 6
   (k, scaled) — the kernels' compiled k and two they run with k at run
   time — × 6 shapes (tiles of 64, 128 and 256 threads, odd and even
   window counts, rows starting at every alignment the vector stores
   test, rows of length 0, below k and L; ``hashes`` and ``keep`` on
   the whole arrays, windows past a row's length included; plus sampled
   windows against the scalar murmur oracle);
   ``bitonic_sort_rows`` over every width class of its design (one-warp
   rows, one-block rows, cluster rows up to 131,072 keys, rows merged
   through device memory), at widths that are not powers of two, B = 1
   and strided rows, on full-range u64 keys with sentinels and
   duplicates. Then timings: device time per call (events around the
   replay of a CUDA graph that captured ``GRAPH_CALLS`` wrapper calls
   over rotating inputs, so the host's enqueue cannot set it) for each
   kernel, its plain version and, for the sort, ``torch.sort``; the host
   clock per wrapper call beside it; and each kernel's bound;
4. main path (``index`` → ``search``) through ``python -m
   kmerseek_tpu_torch`` (run in this process, so launch counters are
   visible): a seeded synthetic proteome of 20,000 proteins (~11M
   residues, lognormal lengths, 4 titin-like giants) and 1,024 queries
   (half planted segments with ~5% point substitutions, half random).
   Checks: masked-kernel launches > 0, the sparse device cross-check
   ran, every planted query reports its source, and the first 500
   targets give the same ``.sig.zip`` and search CSV bytes with
   ``--device cpu`` as on the card;
5. path A, the k-mer sidecar and stitching: ``index --extract-kmers``
   at the defaults (hp/k24/scaled5) on all 20,000 targets, whose
   sidecar must hold one row per kept window; then ``index`` and
   ``search --extract-kmers --stitch-per-query`` at dayhoff/k24/scaled5
   (see ``PATH_A_MOLTYPE``), where every planted query that shares a
   kept hash with its source (scalar oracle) must be stitched to it with
   length >= 24; the first 500 targets give equal decoded ``kmers.pq``
   tables and the same stitched CSV and stderr report bytes on the card
   and with ``--device cpu``. Window-hash kernel launches > 0. At the
   defaults the stitched search of the first 3,000 targets stops on
   kmerseek's stitch-length assertion, on the same group on the card and
   with ``--device cpu`` (the JAX package stops on it too:
   ``tests/test_torch_cli.py``);
6. path B, the dense sketch route: ``sketch_batch`` (window-hash kernel
   → compaction → bitonic kernel → dedup) over all 20,000 targets in the
   index's fixed-grid buckets equals every signature the main path's
   index holds; ``pairwise_stats`` of the 1,024 queries against the
   first 2,048 targets equals the search CSV's ``intersect_hashes`` on
   every reported pair and is 0 on every other; ``entry()``'s forward
   gives the same outputs on the card and the CPU. All three kernels
   launched;
7. path C, multisearch and the dense inverted engine (plain PyTorch and
   numpy: no kernel of the port runs here, and the launch counts stay
   0), on the main path's ``.sig.zip`` files at full size:
   ``do_multisearch`` on the card and with ``device="cpu"`` writes the
   same 16-column CSV bytes; ``write_search_csv_columns`` on the
   manysearch columns equals ``write_search_csv`` and the main path's
   search CSV byte for byte; ``_device_pair_stats`` (1,024 x 20,000)
   equals the host join's counts and weighted sums scattered into
   matrices, in full; its first 2,048 columns equal path B's
   ``pairwise_stats`` counts;
8. path D, ``parallel/``, at full size. D1: the script starts itself
   twice as the two ranks of a Gloo process group on localhost, both on
   ``cuda:0``; each rank runs ``ProteomeIndex.build_distributed``,
   ``build_sharded_index``, ``save``, ``ShardedProteomeIndex.load`` and
   the sharded manysearch and multisearch of the 1,024 queries against
   its reloaded shard. Checks: both ranks' merged index arrays equal
   the main path's index; each shard's postings lie inside its hash
   range, the two counts add up to the index's postings and each is
   45-55% of them; both ranks' manysearch CSV bytes equal the main
   path's search CSV and their multisearch CSV bytes path C's; each
   rank launched the masked kernel and ran the sparse cross-check on
   its shard. A rank that fails or overruns its time limit fails the
   run, and the survivors are killed. D2: a mesh of four shards in this
   process (``make_mesh(4)``: on one card all on ``cuda:0``):
   ``sharded_inverted_search`` of the 1,024 x 20,000 block equals path
   C's matrices in full, ``sharded_sparse_search`` densified equals
   them too, ``distributed_manysearch_stats`` and
   ``make_dist_pipeline_step`` (1,024 query rows split four ways
   against the first 2,048 targets) equal path B's ``pairwise_stats``,
   the step's ``total_retained`` is the sum of the query sketch sizes,
   and ``dryrun_multichip(4)`` passes. All three kernels launched. Four
   logical shards on one card show the layout, not a scaling;
9. a JSON line with every kernel's numbers, the ``nvidia-smi`` line, and
   the result line ``{"ok": true, "device": {...}}`` last. A kernel's
   ``launches`` counts its wrapper's calls in the run of the path that
   introduced it (``launches_by_path`` has every path's count, path D's
   too); one sort call is one grid up to 131,072 keys a row
   (``ops.sort_cuda.sort_grid_launches``).
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import json
import math
import os
import runpy
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from kmerseek_tpu_torch.core.fasta import pack_fixed_grid
from kmerseek_tpu_torch.core.index import ProteomeIndex
from kmerseek_tpu_torch.core.search import _validate_with_device
from kmerseek_tpu_torch.core.signature import signatures_from_sketch_batch
from kmerseek_tpu_torch.entry import entry
from kmerseek_tpu_torch.ops import cuda_build
from kmerseek_tpu_torch.ops import sketch as sketch_mod
from kmerseek_tpu_torch.ops import sort_cuda
from kmerseek_tpu_torch.ops.encoding import encode_bytes_np, max_hash_for_scaled
from kmerseek_tpu_torch.ops.intersect import pairwise_stats
from kmerseek_tpu_torch.ops.murmur3 import murmur64_bytes_py
from kmerseek_tpu_torch.ops.sketch_cuda import (
    masked_window_keys,
    masked_window_keys_ref,
    window_hashes,
    window_hashes_ref,
)
from kmerseek_tpu_torch.ops.sort_cuda import (
    bitonic_sort_rows,
    bitonic_sort_rows_ref,
    max_cluster_blocks,
    sort_grid_launches,
)
from kmerseek_tpu_torch.ops.u64 import sort_key

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
MOLTYPES = ("protein", "dayhoff", "hp")
# both hash kernels have k = 5, 10, 16, 24 compiled in; 12 and 40 run their
# run-time-k version
K_SCALED = ((5, 1), (10, 1), (16, 5), (24, 5), (12, 1), (40, 5))
# tiles of 256 threads (W > 512), 128 ("mid") and 64 ("narrow"); over the six
# k each shape gives odd and even window counts W, so with four rows or more
# rows start at every alignment of row * W mod 4 that the vector stores test
HASH_SHAPES = {
    "1024x1024": (1024, 1024), "8x32768": (8, 32768), "ragged": (16, 1024),
    "mid": (6, 500), "narrow": (9, 256), "odd": (5, 1531),
}
RAGGED_SHAPES = ("ragged", "mid", "narrow", "odd")  # rows 0..3 get lengths 0, k-1, k, L
SOURCES = ("masked_sketch.cu", "window_hashes.cu", "bitonic_sort.cu")
# (B, S, cluster blocks or None for what the device allows): one-warp rows
# (S <= 256), one-block rows (<= 8,192), cluster rows (<= 131,072 with
# clusters of 16), rows merged through device memory (beyond the cluster,
# or the cluster capped)
SORT_SHAPES = (
    (5, 1, None), (7, 2, None), (3, 100, None), (1024, 128, None), (64, 203, None), (1, 256, None),
    (64, 357, None), (1024, 1024, None), (32, 2507, None), (16, 3000, None), (1, 4965, None),
    (64, 8192, None), (8, 9000, None), (8, 16384, None), (8, 32768, None), (3, 39370, None),
    (1, 65536, None), (2, 65536, None), (2, 100000, None), (2, 65536, 8), (2, 65536, 1),
    (3, 39370, 2), (2, 150000, None),
)
# wrapper calls captured into one CUDA graph for a device-time reading
GRAPH_CALLS = 20
# kmerseek's stitcher asserts that the three stitched strings of a group
# have one length. In the 2-letter hp alphabet nearly every 24-mer occurs
# in an 11M-residue proteome, so random multi-k-mer hits break that
# assertion, in the JAX package on the same group as in the port
# (tests/test_torch_cli.py); the stitched search that must succeed
# therefore runs in the 6-letter dayhoff alphabet, per (match, query) pair.
PATH_A_MOLTYPE = "dayhoff"
# integer instructions per key comparison in the sort's bound: a 64-bit
# unsigned compare is two 32-bit compares chained by the carry
SORT_OPS_PER_COMPARISON = 2

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 bandwidth,
# and the INT32 instruction rate = 132 SMs x 64 INT32 lanes x SM clock
HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES = 132, 64


def log(*a):
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def murmur_int_ops(k: int) -> int:
    """32-bit integer instructions murmur3 x64_128 (first lane) + the
    scaled filter need for one k-byte window, counting a 64-bit multiply
    as 3 (lo*lo wide + two cross terms) and a 64-bit add, xor, shift,
    rotate or compare as 2."""
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


def kernel_bound_ms(B: int, L: int, k: int, sm_clock_hz: float, out_bytes: int = 8):
    """Bound of one hash-kernel call: 1 B in per residue, ``out_bytes``
    out per window (8 masked: the key; 9 window hashes: hash + keep)."""
    W = L - k + 1
    nbytes = B * L + 4 * B + out_bytes * B * W + 4 * B
    ops = B * W * murmur_int_ops(k)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (SMS * INT32_LANES * sm_clock_hz)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sort_bound_ms(B: int, S: int, sm_clock_hz: float):
    """Bound of sorting each row of (B, S) u64 keys, whatever the
    algorithm: 8 B in and 8 B out per key, and B·S·log2S comparisons
    (about log2(S!) per row, what a comparison sort needs). Returns
    (bound ms, what bounds it, byte-term ms, operation-term ms)."""
    comparisons = B * S * math.log2(max(S, 2))
    t_bytes = 16 * B * S / HBM_BYTES_PER_S
    t_ops = comparisons * SORT_OPS_PER_COMPARISON / (SMS * INT32_LANES * sm_clock_hz)
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, t_bytes * 1e3, t_ops * 1e3


def sm_clock_hz() -> float:
    try:
        return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    except (ValueError, subprocess.CalledProcessError):
        return 1.98e9


def device_time_ms(call, inputs, replays: int = 7) -> float:
    """Device time of one ``call(*inputs[i])`` in ms, which the host's
    enqueue cannot set: ``GRAPH_CALLS`` calls, rotating over ``inputs``,
    are captured into one CUDA graph (the kernels' ctypes launches go to
    the current stream, so they are captured like PyTorch's own); the
    median over ``replays`` of the event span around one replay, over
    the number of calls. Every call's outputs stay alive, so each call
    writes buffers of its own; with the rotating inputs one replay
    touches more than the 50 MB L2 at every timed shape but the
    (2, 65536) sort (1 MB a call, 28 MB a replay: L2-warm)."""
    for args in inputs[:2]:
        call(*args)
    torch.cuda.synchronize()
    graph, keep = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(GRAPH_CALLS):
            keep.append(call(*inputs[i % len(inputs)]))
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / GRAPH_CALLS)
    del graph, keep
    return statistics.median(times)


def host_clock_ms(call, inputs, calls: int = 200) -> float:
    """Host clock per wrapper call in ms: ``calls`` calls back to back,
    one ``synchronize()``, wall over count. What a path pays per launch,
    allocation included; not what the bound is compared with."""
    for args in inputs[:2]:
        call(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        call(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def _mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest absolute difference of two integer tensors, as u64 bit
    patterns for int64 (0 when equal, at least 1 when not)."""
    if torch.equal(a, b):
        return 0.0
    if a.dtype == torch.int64:
        a, b = (x.cpu().numpy().view(np.uint64).astype(np.float64) for x in (a, b))
        return max(float(np.abs(a - b).max()), 1.0)
    return max((a.double() - b.double()).abs().max().item(), 1.0)


def hash_kernel_checks(rng, dev) -> dict:
    """Both hash kernels against their plain versions and the scalar
    oracle; returns {kernel name: largest abs error seen}, which is 0
    unless it raised."""
    n_checked = 0
    errs = {"masked_window_keys": 0.0, "window_hashes": 0.0}
    # (threads a block, row * W mod 4) of every checked row: which tile and
    # which store path (16-byte hash stores need an even start, the 4-byte
    # keep store a multiple of 4) the window-hash kernel took
    store_cases = set()
    for label, (B, L) in HASH_SHAPES.items():
        seqs_np = AA[rng.integers(0, 20, size=(B, L))]
        lens_np = rng.integers(0, L + 1, size=B).astype(np.int32)
        for moltype in MOLTYPES:
            enc = encode_bytes_np(seqs_np, moltype)
            for k, scaled in K_SCALED:
                lens = lens_np.copy()
                ragged = label in RAGGED_SHAPES
                if ragged:
                    lens[:4] = [0, k - 1, k, L]
                seqs = torch.from_numpy(seqs_np).to(dev)
                lt = torch.from_numpy(lens).to(dev)
                kw = dict(k=k, scaled=scaled, moltype=moltype)
                keys, cnt = masked_window_keys(seqs, lt, **kw)
                rkeys, rcnt = masked_window_keys_ref(seqs, lt, **kw)
                h, keep = window_hashes(seqs, lt, **kw)
                rh, rkeep = window_hashes_ref(seqs, lt, **kw)
                torch.cuda.synchronize()
                where = f"{label} {moltype} k={k} scaled={scaled}"
                W = L - k + 1
                threads = 64 if W <= 256 else (128 if W <= 512 else 256)
                store_cases.update((threads, (b * W) % 4) for b in range(min(B, 4)))
                e_masked = max(_mismatch(keys, rkeys), _mismatch(cnt, rcnt))
                e_window = max(_mismatch(h, rh), _mismatch(keep.to(torch.int8), rkeep.to(torch.int8)))
                errs["masked_window_keys"] = max(errs["masked_window_keys"], e_masked)
                errs["window_hashes"] = max(errs["window_hashes"], e_window)
                if e_masked:
                    raise SystemExit(f"masked_window_keys disagrees with its plain version: {where} (max abs err {e_masked})")
                if e_window:
                    raise SystemExit(f"window_hashes disagrees with its plain version: {where} (max abs err {e_window})")
                if ragged and not (cnt[0] == 0 and cnt[1] == 0 and not keep[:2].any()):
                    raise SystemExit(f"rows shorter than k kept windows (k={k})")
                # scalar oracle on sampled windows: every window's raw
                # hash, and the masked key where it is kept
                hk = keys.cpu().numpy().view(np.uint64)
                hw = h.cpu().numpy().view(np.uint64)
                kp = keep.cpu().numpy()
                mh = max_hash_for_scaled(scaled)
                for _ in range(24):
                    b = int(rng.integers(0, B))
                    j = int(rng.integers(0, L - k + 1))
                    ref = murmur64_bytes_py(bytes(enc[b, j : j + k]))
                    kept = j < lens[b] - k + 1 and ref <= mh
                    if int(hk[b, j]) != (ref if kept else 2**64 - 1) or int(hw[b, j]) != ref or kp[b, j] != kept:
                        raise SystemExit(f"a hash kernel disagrees with the murmur oracle at {where} ({b},{j})")
                    n_checked += 1
        log(
            f"hash kernel checks {label} (B={B}, L={L}): {len(MOLTYPES) * len(K_SCALED)} configs "
            f"bit-equal for both kernels"
        )
    log(
        f"hash kernel checks: {len(HASH_SHAPES) * len(MOLTYPES) * len(K_SCALED)} configs bit-equal "
        f"(k compiled into the masked kernel: 5, 10, 16, 24; at run time: 12, 40), "
        f"{n_checked} sampled windows match the scalar oracle; hashes and keep compared on the whole "
        f"(B, W) arrays, windows past a row's length included; (threads, row*W mod 4) seen: "
        f"{sorted(store_cases)}; max abs err {errs}"
    )
    if len(store_cases) != 12:
        raise SystemExit(f"the hash checks missed a tile size or a store alignment: {sorted(store_cases)}")
    return errs


def sort_keys(rng, B, S, dev) -> torch.Tensor:
    """Full-range u64 keys (int64 bits) with sentinels and duplicates."""
    vals = rng.integers(0, 2**64, size=(B, S), dtype=np.uint64)
    vals[:, ::7] = vals[:, :1]
    vals[:, -min(5, S):] = 2**64 - 1
    vals[0, : min(S, 4)] = 2**63
    return torch.from_numpy(vals.view(np.int64).copy()).to(dev)


def sort_kernel_checks(rng, dev) -> float:
    """The sort against its plain version; returns the largest abs error
    seen (as u64), which is 0 unless it raised."""
    allowed = max_cluster_blocks(dev)

    index = torch.cuda.current_device()

    def check(keys, cs) -> float:
        cs = allowed if cs is None else min(cs, allowed)
        # the wrapper takes its cluster size from this table; capped here
        # so that narrower rows take the device-memory merge too
        sort_cuda._cluster_blocks[index] = cs
        try:
            got = bitonic_sort_rows(keys)
        finally:
            sort_cuda._cluster_blocks[index] = allowed
        want = bitonic_sort_rows_ref(keys)
        torch.cuda.synchronize()
        where = f"B={keys.shape[0]}, S={keys.shape[1]}, row stride {keys.stride(0)}, clusters of {cs}"
        if got.shape != keys.shape or not got.is_contiguous() or got.data_ptr() == keys.data_ptr():
            raise SystemExit(f"bitonic_sort_rows returned no fresh {tuple(keys.shape)} tensor at {where}")
        e = _mismatch(got, want)
        if e:
            raise SystemExit(f"bitonic_sort_rows disagrees with its plain version at {where} (max abs err {e})")
        return e

    err, seen = 0.0, []
    for B, S, cs in SORT_SHAPES:
        err = max(err, check(sort_keys(rng, B, S, dev), cs))
        seen.append(f"{B}x{S}:{sort_grid_launches(S, allowed if cs is None else min(cs, allowed))}")
    # rows one slot apart, as `_compact_valid` hands them to the sort
    for B, S in ((64, 203), (4, 2507), (2, 39370)):
        err = max(err, check(sort_keys(rng, B, S + 1, dev)[:, :S], None))
    log(
        f"sort kernel checks: {len(SORT_SHAPES)} shapes and 3 with strided rows bit-equal "
        f"(BxS:grids, clusters of up to {allowed} blocks): {' '.join(seen)}; max abs err {err}"
    )
    return err


def kernel_phase(rng, dev) -> list:
    errs = hash_kernel_checks(rng, dev)
    errs["bitonic_sort_rows"] = sort_kernel_checks(rng, dev)
    clock = sm_clock_hz()
    entries = []

    # hash kernels at the main path's largest common shape, hp/k24/scaled5,
    # over 8 distinct batches. The published time is taken with every row
    # at full length: the bound charges all B*W windows, and the masked
    # kernel skips the windows past a row's length, so only there do time
    # and bound describe the same work. Lengths L/2..L are timed for the log.
    B, L, k, scaled = 1024, 1024, 24, 5
    kw = dict(k=k, scaled=scaled, moltype="hp")
    full, ragged = [], []
    for _ in range(8):
        seqs = torch.from_numpy(AA[rng.integers(0, 20, size=(B, L))]).to(dev)
        lt = torch.from_numpy(rng.integers(L // 2, L + 1, size=B).astype(np.int32)).to(dev)
        full.append((seqs, torch.full_like(lt, L)))
        ragged.append((seqs, lt))
    how = (
        f"device time per call: events around a replayed CUDA graph of {GRAPH_CALLS} calls over "
        f"{len(full)} rotating inputs, outputs kept apart, median of 7 replays"
    )
    for name, fn, ref, out_bytes, src, replaces in [
        ("masked_window_keys", masked_window_keys, masked_window_keys_ref, 8,
         "masked_sketch.cu", "kmerseek_tpu/ops/sketch_pallas.py:98"),
        ("window_hashes", window_hashes, window_hashes_ref, 9,
         "window_hashes.cu", "kmerseek_tpu/ops/sketch_pallas.py:66"),
    ]:
        ms = device_time_ms(lambda s, n: fn(s, n, **kw), full)
        plain_ms = device_time_ms(lambda s, n: ref(s, n, **kw), full)
        ragged_ms = device_time_ms(lambda s, n: fn(s, n, **kw), ragged)
        host_ms = host_clock_ms(lambda s, n: fn(s, n, **kw), full)
        bound_ms, bound_by = kernel_bound_ms(B, L, k, clock, out_bytes)
        log(
            f"{name} timing (B={B}, L={L}, hp/k{k}/scaled{scaled}, every row at full length; {how}): "
            f"{ms:.4f} ms kernel ({ragged_ms:.4f} ms with lengths L/2..L, not held against the bound), "
            f"{plain_ms:.4f} ms plain version; host clock per wrapper call {host_ms:.4f} ms; "
            f"bound {bound_ms:.4f} ms ({bound_by}; {murmur_int_ops(k)} int32 ops/window over all "
            f"B*W windows at {clock / 1e6:.0f} MHz, {out_bytes} B out/window) = "
            f"{100 * bound_ms / ms:.1f}% of the time; {B * (L - k + 1) / ms / 1e6:.2f} G windows/s"
        )
        entries.append({
            "name": name, "route": "cuda", "source": f"kmerseek_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": None, "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes this function
        })

    # the sort at a sketch-sized, a wide-and-tall and a titin-sized shape of
    # path B, each over inputs that together exceed the L2
    sort_entry = None
    allowed = max_cluster_blocks(dev)
    for B, S in ((1024, 1024), (128, 8192), (2, 65536)):
        inputs = [(sort_keys(rng, B, S, dev),) for _ in range(8)]
        flipped = [(sort_key(x),) for (x,) in inputs]
        ms = device_time_ms(bitonic_sort_rows, inputs)
        plain_ms = device_time_ms(bitonic_sort_rows_ref, inputs)
        lib_ms = device_time_ms(lambda x: torch.sort(x, dim=1), flipped)
        host_ms = host_clock_ms(bitonic_sort_rows, inputs)
        bound_ms, bound_by, bytes_ms, ops_ms = sort_bound_ms(B, S, clock)
        log(
            f"bitonic_sort_rows timing (B={B}, S={S}; one wrapper call = "
            f"{sort_grid_launches(S, allowed)} grid launches; {how}): "
            f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain version, {lib_ms:.4f} ms torch.sort; "
            f"host clock per wrapper call {host_ms:.4f} ms; "
            f"bound {bound_ms:.4f} ms ({bound_by}; bytes term {bytes_ms:.4f} ms at 16 B/key, "
            f"operations term {ops_ms:.4f} ms for B*S*log2(S) comparisons at "
            f"{SORT_OPS_PER_COMPARISON} int32 ops each, {clock / 1e6:.0f} MHz) = "
            f"{100 * bound_ms / ms:.1f}% of the time"
        )
        if sort_entry is None:
            sort_entry = {
                "name": "bitonic_sort_rows", "route": "cuda",
                "source": "kmerseek_tpu_torch/csrc/bitonic_sort.cu",
                "replaces": "kmerseek_tpu/ops/sort_pallas.py:31", "launches": None,
                "max_abs_err": errs["bitonic_sort_rows"], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            }
    entries.append(sort_entry)
    return entries


# ---------------------------------------------------------------------------
# main-path phase
# ---------------------------------------------------------------------------


def make_corpus(rng, n_targets=20000, n_queries=1024):
    """Targets: lognormal lengths (median ~415, mean ~560 aa) plus four
    titin-like giants; queries: half planted segments of 50-300 aa from
    known targets with ~5% point substitutions, half random."""
    lens = np.clip(rng.lognormal(np.log(415), 0.774, size=n_targets), 30, 15000).astype(int)
    giants = rng.choice(n_targets, size=4, replace=False)
    lens[giants] = rng.integers(20000, 34351, size=4)
    targets = [AA[rng.integers(0, 20, size=n)].tobytes() for n in lens]
    queries, planted = [], {}
    while len(planted) < n_queries // 2:
        t = int(rng.integers(0, n_targets))
        n = int(min(rng.integers(50, 301), len(targets[t])))
        a = int(rng.integers(0, len(targets[t]) - n + 1))
        seg = np.frombuffer(targets[t][a : a + n], np.uint8).copy()
        sub = rng.random(n) < 0.05
        seg[sub] = AA[rng.integers(0, 20, size=int(sub.sum()))]
        # keep only segments that still share a kept hash with their
        # source, by the scalar oracle (independent of the port)
        if _oracle_hashes(seg.tobytes()) & _oracle_hashes(targets[t][a : a + n]):
            planted[f"planted{len(planted)} src=t{t}"] = f"t{t}"
            queries.append(seg.tobytes())
    names = list(planted)
    for i in range(n_queries - len(queries)):
        queries.append(AA[rng.integers(0, 20, size=int(rng.integers(50, 301)))].tobytes())
        names.append(f"random{i}")
    return targets, lens, queries, names, planted


def _oracle_hashes(seq: bytes, k=24, scaled=5, moltype="hp") -> set:
    enc = encode_bytes_np(np.frombuffer(seq, np.uint8), moltype).tobytes()
    mh = max_hash_for_scaled(scaled)
    hs = (murmur64_bytes_py(enc[j : j + k]) for j in range(len(enc) - k + 1))
    return {h for h in hs if h <= mh}


def write_fasta(path, names, seqs):
    with open(path, "w") as f:
        for n, s in zip(names, seqs):
            f.write(f">{n}\n")
            for j in range(0, len(s), 60):
                f.write(s[j : j + 60].decode() + "\n")


def kmerseek(*args):
    """``python -m kmerseek_tpu_torch ARGS``, run in this process."""
    argv = sys.argv
    sys.argv = ["kmerseek_tpu_torch", *args]
    try:
        runpy.run_module("kmerseek_tpu_torch", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code not in (0, None):
            raise SystemExit(f"kmerseek {' '.join(args)} failed with exit {e.code}")
    finally:
        sys.argv = argv


class KernelTimer:
    """Times every sketch-kernel wrapper call of the main path with CUDA
    events around it: the span holds the kernel and the host's launch
    overhead (allocation, ctypes call). The wrapper's own launch count is
    untouched. ``profile_torch_main_path.py`` gives device-only time."""

    def __init__(self, sm_clock_hz: float):
        self.events = []
        self.bound_ms = 0.0  # summed bound of the timed calls' shapes
        self.clock = sm_clock_hz
        self.real = sketch_mod.masked_window_keys

    def __call__(self, seqs, lengths, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.real(seqs, lengths, **kw)
        end.record()
        self.events.append((start, end))
        self.bound_ms += kernel_bound_ms(*seqs.shape, kw["k"], self.clock)[0]
        return out

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


class Corpus:
    """chip_smoke's seeded proteome and queries, written as FASTA files
    in ``workdir``."""

    def __init__(self, rng, workdir):
        t0 = time.perf_counter()
        self.targets, self.lens, self.queries, self.qnames, self.planted = make_corpus(rng)
        self.tnames = [f"t{i}" for i in range(len(self.targets))]
        self.workdir = workdir
        self.tfa = os.path.join(workdir, "target.fa")
        self.qfa = os.path.join(workdir, "query.fa")
        write_fasta(self.tfa, self.tnames, self.targets)
        write_fasta(self.qfa, self.qnames, self.queries)
        self.search_csv = os.path.join(workdir, "search.csv")
        self.pair_counts = None  # path B: pairwise_stats' (Q, first targets) intersect counts
        self.pair_weighted = None  # path B: and its weighted sums
        self.dense_counts = self.dense_weights = None  # path C: the dense engine's (Q, T) matrices
        self.multisearch_csv = None  # path C: do_multisearch's CSV on the card
        lens = self.lens
        log(
            f"corpus: {len(self.targets)} targets, {int(lens.sum())} residues "
            f"(median {int(np.median(lens))}, mean {lens.mean():.0f}, max {lens.max()}); "
            f"{len(self.queries)} queries ({len(self.planted)} planted); "
            f"made in {time.perf_counter() - t0:.1f} s"
        )

    def subset_fasta(self, n: int) -> str:
        """The first ``n`` targets in a directory of their own."""
        sub = os.path.join(self.workdir, f"sub{n}", f"target{n}.fa")
        if not os.path.exists(sub):
            os.makedirs(os.path.dirname(sub))
            write_fasta(sub, self.tnames[:n], self.targets[:n])
        return sub


def reset_launches():
    for fn in (masked_window_keys, window_hashes, bitonic_sort_rows):
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in (masked_window_keys, window_hashes, bitonic_sort_rows)}


def main_path_phase(c: Corpus) -> dict:
    tfa, qfa, lens, planted = c.tfa, c.qfa, c.lens, c.planted

    timer = KernelTimer(sm_clock_hz())
    sketch_mod.masked_window_keys = timer
    reset_launches()
    _validate_with_device.runs = 0
    try:
        t0 = time.perf_counter()
        kmerseek("index", tfa)
        torch.cuda.synchronize()
        t_index = time.perf_counter() - t0
        out = c.search_csv
        t0 = time.perf_counter()
        kmerseek("search", qfa, tfa, "--output", out)
        torch.cuda.synchronize()
        t_search = time.perf_counter() - t0
    finally:
        sketch_mod.masked_window_keys = timer.real
    counts = launches()
    launched = counts["masked_window_keys"]
    validations = _validate_with_device.runs
    kernel_ms = timer.total_ms()

    idx = ProteomeIndex.load(f"{tfa}.hp.k24.scaled5.sig.zip.ksx", device="cuda")
    windows = int(np.maximum(lens - 24 + 1, 0).sum())
    with open(out) as f:
        rows = list(csv.DictReader(f))
    found = {(r["query_name"], r["match_name"]) for r in rows}
    missing = [q for q, t in planted.items() if (q, t) not in found]
    bad = [r for r in rows if not (0.0 < float(r["containment"]) <= 1.0)]
    log(
        f"main path: index {t_index:.2f} s, search {t_search:.2f} s (host clock, incl. file I/O); "
        f"{len(idx.mins)} kept hashes, {idx.inverted.n_postings} postings, "
        f"max_run {idx.inverted.max_run}; {windows / t_index / 1e6:.2f} M windows/s end to end"
    )
    log(
        f"main path: launches {counts}, summed masked-kernel wrapper span {kernel_ms:.3f} ms "
        f"(CUDA events around each wrapper call: kernel + host launch overhead), "
        f"summed bound {timer.bound_ms:.3f} ms over every window of the padded batches "
        f"(more than the rows' lengths need); sparse cross-check runs {validations}; "
        f"{len(rows)} result rows, planted found {len(planted) - len(missing)}/{len(planted)}"
    )
    if launched <= 0:
        raise SystemExit("the main path launched no sketch kernel")
    if validations <= 0:
        raise SystemExit("the sparse device cross-check never ran")
    if missing:
        raise SystemExit(f"{len(missing)} planted queries miss their source, e.g. {missing[:3]}")
    if bad:
        raise SystemExit(f"{len(bad)} rows with containment outside (0, 1]")

    # card vs CPU on the first 500 targets: same bytes
    sub = c.subset_fasta(500)
    results = {}
    for device in ("cuda", "cpu"):
        kmerseek("index", sub, "--device", device, "--force")
        with open(f"{sub}.hp.k24.scaled5.sig.zip", "rb") as f:
            sig = f.read()
        csv_out = os.path.join(os.path.dirname(sub), f"{device}.csv")
        kmerseek("search", qfa, sub, "--device", device, "--force", "--output", csv_out)
        with open(csv_out, "rb") as f:
            results[device] = (sig, f.read())
    if results["cuda"][0] != results["cpu"][0]:
        raise SystemExit("first-500 .sig.zip bytes differ between the card and the CPU")
    if results["cuda"][1] != results["cpu"][1]:
        raise SystemExit("first-500 search CSV bytes differ between the card and the CPU")
    n_rows = results["cpu"][1].count(b"\n") - 1
    log(
        f"first 500 targets: .sig.zip ({len(results['cpu'][0])} B) and search CSV "
        f"({n_rows} rows) identical on the card and the CPU"
    )
    return counts


# ---------------------------------------------------------------------------
# path A: k-mer sidecar + stitching
# ---------------------------------------------------------------------------


def kmerseek_quiet_stderr(*args) -> str:
    """``kmerseek(*args)`` with ``sys.stderr`` captured (the stitch report
    goes there); log lines keep going to the logger's own stream."""
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        kmerseek(*args)
    return buf.getvalue()


def _timed(*args) -> float:
    t0 = time.perf_counter()
    kmerseek(*args)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def path_a_phase(c: Corpus) -> dict:
    import pyarrow.parquet as pq

    m = ("--moltype", PATH_A_MOLTYPE)
    reset_launches()
    # the defaults, fresh: sketch + .sig.zip + .ksx (with sequences) + sidecar
    t_index_hp = _timed("index", "--extract-kmers", "--force", c.tfa)
    hp_pq = f"{c.tfa}.hp.k24.scaled5.sig.zip.kmers.pq"
    idx = ProteomeIndex.load(f"{c.tfa}.hp.k24.scaled5.sig.zip.ksx", device="cuda")
    n_rows = pq.ParquetFile(hp_pq).metadata.num_rows
    n_kept = int(idx.abundances.sum())
    counts_hp = launches()
    log(
        f"path A: index --extract-kmers (hp/k24/scaled5, {len(c.targets)} targets) {t_index_hp:.2f} s "
        f"(host clock, incl. file I/O); sidecar {n_rows} rows, kept windows {n_kept}; "
        f"launches {counts_hp}"
    )
    if n_rows != n_kept:
        raise SystemExit(f"hp sidecar holds {n_rows} rows for {n_kept} kept windows")
    if idx.sequences is None:
        raise SystemExit("index --extract-kmers stored no sequences in its .ksx")

    stitched = os.path.join(c.workdir, "stitched.csv")
    t_index = _timed("index", "--extract-kmers", *m, c.tfa)
    t0 = time.perf_counter()
    report = kmerseek_quiet_stderr(
        "search", "--extract-kmers", "--stitch-per-query", *m, c.qfa, c.tfa, "--output", stitched
    )
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    counts = launches()
    with open(stitched) as f:
        rows = list(csv.DictReader(f))
    short = [r for r in rows if int(r["length"]) < 24]
    got = {(r["query_name"], r["match_name"]) for r in rows if int(r["length"]) >= 24}
    # planted queries that share a kept hash with their source, by the
    # scalar oracle in this alphabet
    qseq = dict(zip(c.qnames, c.queries))
    expected = {
        q for q, t in c.planted.items()
        if _oracle_hashes(qseq[q], moltype=PATH_A_MOLTYPE)
        & _oracle_hashes(c.targets[int(t[1:])], moltype=PATH_A_MOLTYPE)
    }
    missing = [q for q in expected if (q, c.planted[q]) not in got]
    log(
        f"path A: index --extract-kmers ({PATH_A_MOLTYPE}/k24/scaled5) {t_index:.2f} s, "
        f"search --extract-kmers --stitch-per-query {t_search:.2f} s (host clock, incl. file I/O); "
        f"{len(rows)} stitched rows, {report.count('Query Name:')} report segments; "
        f"planted stitched to their source {len(expected) - len(missing)}/{len(expected)} "
        f"(of {len(c.planted)} planted, {len(expected)} share a kept {PATH_A_MOLTYPE} hash); "
        f"launches {counts}"
    )
    if counts["window_hashes"] <= 0:
        raise SystemExit("path A launched no window-hash kernel")
    if missing:
        raise SystemExit(f"{len(missing)} planted queries are not stitched to their source, e.g. {missing[:3]}")
    if short or report.count("Query Name:") != len(rows):
        raise SystemExit("stitched rows shorter than k, or report and CSV disagree")

    # card vs CPU on the first 500 targets: equal tables, CSV and report
    sub = c.subset_fasta(500)
    out = {}
    for device in ("cuda", "cpu"):
        d = ("--device", device, "--force")
        kmerseek("index", "--extract-kmers", *d, sub)
        csv_out = os.path.join(os.path.dirname(sub), f"stitched-{device}.csv")
        rep = kmerseek_quiet_stderr(
            "search", "--extract-kmers", "--stitch-per-query", *m, *d, c.qfa, sub, "--output", csv_out
        )
        tables = [
            pq.read_table(f"{fa}.{mt}.k24.scaled5.sig.zip.kmers.pq")
            for fa, mt in ((sub, "hp"), (sub, PATH_A_MOLTYPE), (c.qfa, PATH_A_MOLTYPE))
        ]
        with open(csv_out, "rb") as f:
            out[device] = (tables, f.read(), rep)
    for a, b, what in zip(out["cuda"][0], out["cpu"][0], ("hp target", "target", "query")):
        if not a.equals(b):
            raise SystemExit(f"first-500 {what} kmers.pq tables differ between the card and the CPU")
    if out["cuda"][1] != out["cpu"][1] or out["cuda"][2] != out["cpu"][2]:
        raise SystemExit("first-500 stitched CSV or report bytes differ between the card and the CPU")
    log(
        f"first 500 targets: kmers.pq tables ({', '.join(str(len(t)) for t in out['cpu'][0])} rows), "
        f"stitched CSV ({out['cpu'][1].count(b'\n') - 1} rows) and report identical on the card and the CPU"
    )

    # the defaults on the first 3,000 targets: the stitch-length assertion
    # trips on one group, the same on the card and the CPU
    cut = c.subset_fasta(3000)
    stops = {}
    for device in ("cuda", "cpu"):
        try:
            kmerseek_quiet_stderr(
                "search", "--extract-kmers", "--device", device, "--force", c.qfa, cut, "--output", os.devnull
            )
            stops[device] = None
        except AssertionError as e:
            stops[device] = str(e)
    log(f"first 3000 targets, hp/k24/scaled5 stitched search stops on: {stops}")
    if not (stops["cuda"] and "stitched length mismatch" in stops["cuda"] and stops["cuda"] == stops["cpu"]):
        raise SystemExit(f"hp stitched search on the first 3000 targets: card and CPU differ: {stops}")
    return counts


# ---------------------------------------------------------------------------
# path B: dense sketches + pairwise stats
# ---------------------------------------------------------------------------


def dense_sketches(seqs, k=24, scaled=5, moltype="hp"):
    """``sketch_batch`` over records in the index's fixed-grid buckets
    (1,000-record ingest batches), capacity from ``sketch_capacity``,
    doubled on overflow. Returns the per-record Signatures."""
    from kmerseek_tpu_torch.core.alphabet import validate_resolve_batch

    sigs = [None] * len(seqs)
    for lo in range(0, len(seqs), 1000):
        resolved = validate_resolve_batch(seqs[lo : lo + 1000])
        for arr, lens, idxs in pack_fixed_grid(resolved, min_len=max(k + 1, 256)):
            cap = sketch_mod.sketch_capacity(arr.shape[1], k, scaled)
            x, n = torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()
            while True:
                sb = sketch_mod.sketch_batch(x, n, k=k, scaled=scaled, moltype=moltype, capacity=cap)
                if int(sb.n_kept.max()) <= cap:
                    break
                cap *= 2
            batch = signatures_from_sketch_batch(
                sb, [str(i) for i in range(len(arr))], ksize=k, scaled=scaled, moltype=moltype
            )
            for r, i in enumerate(idxs):
                sigs[lo + i] = batch[r]
    return sigs


def _dense_block(sigs, device):
    """(keys, abund, counts) of Signatures as one zero-padded block."""
    counts = np.array([len(s) for s in sigs], np.int64)
    S = max(int(counts.max(initial=1)), 1)
    keys = np.zeros((len(sigs), S), np.uint64)
    ab = np.zeros((len(sigs), S), np.int32)
    for i, s in enumerate(sigs):
        keys[i, : len(s)] = s.mins
        ab[i, : len(s)] = s.abundances
    return (
        torch.from_numpy(keys.view(np.int64)).to(device),
        torch.from_numpy(ab).to(device),
        torch.from_numpy(counts.astype(np.int32)).to(device),
    )


def path_b_phase(c: Corpus, n_pair_targets: int = 2048) -> dict:
    idx = ProteomeIndex.load(f"{c.tfa}.hp.k24.scaled5.sig.zip.ksx", device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    sigs = dense_sketches(c.targets)
    torch.cuda.synchronize()
    t_sketch = time.perf_counter() - t0
    bad = [
        i for i, s in enumerate(sigs)
        if not (np.array_equal(s.mins, idx.signature(i).mins)
                and np.array_equal(s.abundances, idx.signature(i).abundances))
    ]
    if bad:
        raise SystemExit(f"{len(bad)} dense sketches differ from the index's signatures, e.g. t{bad[0]}")

    t0 = time.perf_counter()
    q_keys, _, q_counts = _dense_block(dense_sketches(c.queries), "cuda")
    t_keys, t_ab, t_counts = _dense_block(sigs[:n_pair_targets], "cuda")
    stats = pairwise_stats(q_keys, q_counts, t_keys, t_ab, t_counts)
    got = stats.intersect.cpu().numpy()
    torch.cuda.synchronize()
    t_pairs = time.perf_counter() - t0
    want = np.zeros_like(got)
    qpos = {q: i for i, q in enumerate(c.qnames)}
    with open(c.search_csv) as f:
        for r in csv.DictReader(f):
            t = int(r["match_name"][1:])
            if t < n_pair_targets:
                want[qpos[r["query_name"]], t] = int(r["intersect_hashes"])
    if not np.array_equal(got, want):
        n = int((got != want).sum())
        raise SystemExit(f"pairwise_stats disagrees with the search CSV on {n} pairs")
    c.pair_counts = got  # paths C and D hold their engines against it
    c.pair_weighted = stats.weighted.cpu().numpy()

    fc, ac = entry(device="cuda")
    fp, ap = entry(device="cpu")
    for x, y in zip(fc(*ac), fp(*ap)):
        if not torch.equal(x.cpu(), y):
            raise SystemExit("entry() forward differs between the card and the CPU")
    counts = launches()
    log(
        f"path B: sketch_batch over {len(sigs)} targets {t_sketch:.2f} s (host clock), all equal to "
        f"the index's signatures; pairwise_stats {len(c.queries)} x {n_pair_targets} in "
        f"{t_pairs:.2f} s ({int((want > 0).sum())} reported pairs, {int(want.sum())} shared hashes, "
        f"all equal, every other pair 0); entry() forward equal on card and CPU; launches {counts}"
    )
    if min(counts.values()) <= 0:
        raise SystemExit(f"path B left a kernel unlaunched: {counts}")
    return counts


# ---------------------------------------------------------------------------
# path C: multisearch + the dense inverted engine
# ---------------------------------------------------------------------------


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def path_c_phase(c: Corpus, smi: str) -> dict:
    from kmerseek_tpu_torch.core import search as search_mod
    from kmerseek_tpu_torch.ops.inverted import inverted_search

    qsig = f"{c.qfa}.hp.k24.scaled5.sig.zip"
    tsig = f"{c.tfa}.hp.k24.scaled5.sig.zip"
    reset_launches()

    # multisearch through the file-level API, card against CPU
    walls, outs = {}, {}
    for device in ("cuda", "cpu"):
        out = os.path.join(c.workdir, f"multisearch-{device}.csv")
        t0 = time.perf_counter()
        search_mod.do_multisearch(qsig, tsig, out, device=device)
        torch.cuda.synchronize()
        walls[device] = time.perf_counter() - t0
        outs[device] = _read_bytes(out)
        if device == "cuda":
            c.multisearch_csv = out  # path D's sharded multisearch must write these bytes
    if outs["cuda"] != outs["cpu"]:
        raise SystemExit("multisearch CSV bytes differ between the card and the CPU")
    header, _, body = outs["cuda"].partition(b"\n")
    n_rows = body.count(b"\n")
    if header.decode().split(",") != search_mod.MULTISEARCH_COLUMNS or len(search_mod.MULTISEARCH_COLUMNS) != 16:
        raise SystemExit(f"multisearch CSV header is not the 16 columns: {header!r}")
    with open(c.search_csv) as f:
        n_search_rows = sum(1 for _ in f) - 1
    if n_rows != n_search_rows or n_rows <= 0:
        raise SystemExit(f"multisearch wrote {n_rows} rows, the main path's search {n_search_rows}")

    # the column-native CSV writer against the row writer, on the
    # manysearch columns of the main path's pair of indexes
    query = search_mod._as_index(qsig, device="cuda")
    target = ProteomeIndex.load(f"{tsig}.ksx", device="cuda")
    cols = search_mod.manysearch_columns(query, target)
    by_cols, by_rows = (os.path.join(c.workdir, n) for n in ("cols.csv", "rows.csv"))
    t0 = time.perf_counter()
    search_mod.write_search_csv_columns(cols, by_cols)
    t_cols = time.perf_counter() - t0
    t0 = time.perf_counter()
    search_mod.write_search_csv(search_mod._rows_from_columns(cols), search_mod.MANYSEARCH_COLUMNS, by_rows)
    t_rows = time.perf_counter() - t0
    if not (_read_bytes(by_cols) == _read_bytes(by_rows) == _read_bytes(c.search_csv)):
        raise SystemExit("write_search_csv_columns, write_search_csv and the main path's search CSV differ")

    # the dense engine against the host join, every pair
    t0 = time.perf_counter()
    counts, weights = search_mod._device_pair_stats(query, target)
    t_dense = time.perf_counter() - t0
    js = search_mod._host_join(query, target, inner="ab")
    want_c = np.zeros((len(query), len(target)), np.int32)
    want_w = np.zeros((len(query), len(target)), np.int64)
    want_c[js.seg_q, js.seg_t] = js.seg_n
    want_w[js.seg_q, js.seg_t] = np.add.reduceat(js.pab, js.starts)
    if counts.shape != want_c.shape or counts.dtype != np.int32 or weights.dtype != np.int32:
        raise SystemExit(f"_device_pair_stats returned {counts.dtype}{counts.shape}, {weights.dtype}")
    if not np.array_equal(counts, want_c):
        raise SystemExit(f"dense engine counts differ from the host join on {int((counts != want_c).sum())} pairs")
    if not np.array_equal(weights, want_w.astype(np.int32)):
        raise SystemExit("dense engine weighted sums differ from the host join")
    c.dense_counts, c.dense_weights = counts, weights  # path D's sharded engines must give these
    n_sub = c.pair_counts.shape[1]
    row_of = {name: i for i, name in enumerate(query.names)}
    rows = [row_of[name] for name in c.qnames]  # path B's rows are in FASTA order
    if not np.array_equal(counts[rows, :n_sub], c.pair_counts):
        raise SystemExit(f"dense engine counts differ from pairwise_stats on the first {n_sub} targets")

    # the engine alone, results left on the card: one 1,024-query block
    q_keys, q_valid = query.dense_device_keys()
    inverted_search(target, q_keys, q_valid)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        inverted_search(target, q_keys, q_valid)
    torch.cuda.synchronize()
    t_block = (time.perf_counter() - t0) / reps
    counts_c = launches()
    log(
        f"path C ({smi}): do_multisearch {len(query)} x {len(target)} from .sig.zip to CSV "
        f"{walls['cuda']:.2f} s on the card, {walls['cpu']:.2f} s with device=cpu (host clock, incl. "
        f"reading both archives); {n_rows} rows x 16 columns, {len(outs['cuda'])} B, identical; "
        f"column CSV writer {t_cols:.2f} s against {t_rows:.2f} s for rows + row writer, both equal "
        f"to the main path's search CSV"
    )
    log(
        f"path C ({smi}): dense engine {len(query)} x {len(target)} (S = {q_keys.shape[1]} slots, "
        f"{target.inverted.n_postings} postings, max_run {target.inverted.max_run}): "
        f"{t_block * 1e3:.2f} ms a block with the matrices left on the card = "
        f"{len(query) / t_block:.0f} queries/s; {t_dense:.3f} s through _device_pair_stats "
        f"(query block upload and both matrices copied to the host); counts and weighted sums equal "
        f"the host join on all {counts.size} pairs ({int((want_c > 0).sum())} hit pairs, "
        f"{int(want_c.sum())} shared hashes) and pairwise_stats on the first {n_sub} targets; "
        f"launches {counts_c} (no kernel of the port is on this path)"
    )
    return counts_c


# ---------------------------------------------------------------------------
# path D: parallel/ — a 2-process group on one card, and a 4-shard mesh
# ---------------------------------------------------------------------------

D1_WORLD = 2
D1_GROUP_TIMEOUT_S = 180  # rendezvous and every collective, in each rank
D1_WAIT_TIMEOUT_S = 420  # this process's wait for the whole group


def _d1_paths(workdir: str, rank: int) -> dict:
    base = os.path.join(workdir, f"d1-rank{rank}")
    return {
        "index": f"{base}.index.npz", "many": f"{base}.many.csv", "multi": f"{base}.multi.csv",
        "result": f"{base}.json", "stdout": f"{base}.out", "stderr": f"{base}.err",
    }


def path_d_worker(rank: int, init_method: str, workdir: str) -> int:
    """One rank of path D1's group (``chip_smoke.py --path-d-worker RANK``),
    on ``cuda:0`` like the other rank. Writes its results into
    ``workdir`` for the process that started it."""
    from kmerseek_tpu_torch.core import search as search_mod
    from kmerseek_tpu_torch.parallel import multihost, sharded

    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke needs a GPU")
        return 2
    dev = "cuda:0"
    paths = _d1_paths(workdir, rank)
    tfa, qfa = os.path.join(workdir, "target.fa"), os.path.join(workdir, "query.fa")
    walls = {}

    stats = multihost.exchange_stats  # bytes and seconds of every all-gather so far

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    reset_launches()
    _validate_with_device.runs = 0
    got = timed("rendezvous", multihost.initialize_distributed, init_method, D1_WORLD, rank)
    if got != (rank, D1_WORLD):
        raise SystemExit(f"rank {rank}: the group reports {got}")
    idx = timed("build_distributed", ProteomeIndex.build_distributed, tfa, device=dev)
    replica = dict(stats)  # the full-replica build's share of the exchange
    np.savez(
        paths["index"], names=np.asarray(idx.names, dtype=np.str_), mins=idx.mins,
        abundances=idx.abundances, offsets=idx.offsets,
    )
    del idx
    built = timed("build_sharded", sharded.build_sharded_index, tfa, device=dev)
    save_dir = os.path.join(workdir, "d1-sharded.ksx")
    timed("save", built.save, save_dir)
    sh = timed("load", sharded.ShardedProteomeIndex.load, save_dir, device=dev)  # shard from the group
    same = (
        (sh.shard, sh.n_shards) == (rank, D1_WORLD) and sh.names == built.names and sh.md5s == built.md5s
        and all(np.array_equal(getattr(sh.local, m), getattr(built.local, m)) for m in ("g_hi", "g_lo", "tid", "ab"))
    )
    if not same:
        raise SystemExit(f"rank {rank}: the reloaded shard differs from the built one")
    del built
    query = search_mod._as_index(f"{qfa}.hp.k24.scaled5.sig.zip", device=dev)
    many = timed("manysearch", sharded.sharded_manysearch_columns, query, sh)
    multi = timed("multisearch", sharded.sharded_multisearch_columns, query, sh)
    search_mod.write_search_csv_columns(many, paths["many"])
    search_mod.write_search_csv_columns(multi, paths["multi"])
    g = sh.local.g64()
    result = {
        "rank": rank, "walls": walls, "exchange_replica": replica, "exchange": dict(stats),
        "n_local_postings": int(sh.n_local_postings), "hash_range": list(sh.hash_range),
        "g_min": int(g.min()), "g_max": int(g.max()), "n_targets": len(sh),
        "launches": launches(), "validations": _validate_with_device.runs,
        "device": str(sh.device),
    }
    with open(paths["result"], "w") as f:
        json.dump(result, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    s = socket.socket()
    try:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def path_d1_phase(c: Corpus, smi: str) -> dict:
    """Two ranks on one card. Returns rank 0's launch counts."""
    init_method = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", KMERSEEK_DIST_TIMEOUT=str(D1_GROUP_TIMEOUT_S))
    paths = [_d1_paths(c.workdir, r) for r in range(D1_WORLD)]
    t0 = time.perf_counter()
    procs, files = [], []
    try:
        for r in range(D1_WORLD):
            out, err = open(paths[r]["stdout"], "w"), open(paths[r]["stderr"], "w")
            files += [out, err]
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--path-d-worker", str(r),
                 "--init-method", init_method, "--workdir", c.workdir],
                stdout=out, stderr=err, env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
            ))
        deadline = time.monotonic() + D1_WAIT_TIMEOUT_S
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise SystemExit(f"path D1: rank {r} overran {D1_WAIT_TIMEOUT_S} s; the group is killed")
    finally:
        for p in procs:  # a failed or hung group leaves no process behind
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(paths[r]["stderr"]) as f:
                raise SystemExit(f"path D1: rank {r} exited with {p.returncode}:\n{f.read()[-3000:]}")

    idx = ProteomeIndex.load(f"{c.tfa}.hp.k24.scaled5.sig.zip.ksx", device="cuda")
    n_total = idx.inverted.n_postings
    results = []
    for r in range(D1_WORLD):
        with open(paths[r]["result"]) as f:
            res = json.load(f)
        results.append(res)
        got = np.load(paths[r]["index"])
        if not (
            got["names"].tolist() == idx.names and np.array_equal(got["mins"], idx.mins)
            and got["mins"].dtype == np.uint64 and np.array_equal(got["abundances"], idx.abundances)
            and np.array_equal(got["offsets"], idx.offsets)
        ):
            raise SystemExit(f"path D1: rank {r}'s merged index differs from the main path's index")
        lo, hi = res["hash_range"]
        if not (lo <= res["g_min"] and res["g_max"] < hi):
            raise SystemExit(f"path D1: rank {r}'s postings leave its hash range [{lo}, {hi})")
        share = res["n_local_postings"] / n_total
        if not 0.45 <= share <= 0.55:
            raise SystemExit(f"path D1: rank {r} holds {share:.3f} of the postings, not 45-55%")
        if _read_bytes(paths[r]["many"]) != _read_bytes(c.search_csv):
            raise SystemExit(f"path D1: rank {r}'s sharded manysearch CSV differs from the main path's search CSV")
        if _read_bytes(paths[r]["multi"]) != _read_bytes(c.multisearch_csv):
            raise SystemExit(f"path D1: rank {r}'s sharded multisearch CSV differs from path C's")
        if res["launches"]["masked_window_keys"] <= 0:
            raise SystemExit(f"path D1: rank {r} launched no sketch kernel")
        if res["validations"] <= 0:
            raise SystemExit(f"path D1: rank {r} never ran the sparse cross-check on its shard")
        if not res["device"].startswith("cuda"):
            raise SystemExit(f"path D1: rank {r} ran on {res['device']}")
        w, rep, ex = res["walls"], res["exchange_replica"], res["exchange"]
        log(
            f"path D1 rank {r} ({smi}; on {res['device']}, shared with the other rank): rendezvous "
            f"{w['rendezvous']:.2f} s, build_distributed {w['build_distributed']:.2f} s (of it exchange "
            f"{rep['seconds']:.2f} s, {rep['bytes_sent']} B sent / {rep['bytes_received']} B "
            f"received), build_sharded_index {w['build_sharded']:.2f} s, save {w['save']:.2f} s, load "
            f"{w['load']:.3f} s, sharded manysearch {w['manysearch']:.2f} s, sharded multisearch "
            f"{w['multisearch']:.2f} s; all exchanges {ex['seconds']:.2f} s, {ex['bytes_sent']} B sent / "
            f"{ex['bytes_received']} B received; shard holds {res['n_local_postings']} postings "
            f"({100 * share:.1f}% of {n_total}) in [{lo}, {hi}); launches {res['launches']}; "
            f"sparse cross-check runs {res['validations']}"
        )
    if sum(r["n_local_postings"] for r in results) != n_total:
        raise SystemExit("path D1: the shards' posting counts do not add up to the index's")
    log(
        f"path D1: {D1_WORLD} ranks on one card, Gloo group over localhost, {wall:.1f} s in all (host clock, "
        f"with both ranks' start-up); both merged indexes equal the main path's ({len(idx)} targets, "
        f"{len(idx.mins)} hashes); both manysearch CSVs equal the main path's search CSV and both "
        f"multisearch CSVs path C's, byte for byte"
    )
    return results[0]["launches"]


def path_d2_phase(c: Corpus, smi: str) -> dict:
    """A mesh of four shards in this process. Returns its launch counts."""
    from kmerseek_tpu_torch.core import search as search_mod
    from kmerseek_tpu_torch.core.alphabet import validate_resolve_batch
    from kmerseek_tpu_torch.core.fasta import pack_batch
    from kmerseek_tpu_torch.core.index import IndexConfig
    from kmerseek_tpu_torch.entry import dryrun_multichip
    from kmerseek_tpu_torch.parallel import dist as pdist

    mesh = pdist.make_mesh(4)
    reset_launches()
    target = ProteomeIndex.load(f"{c.tfa}.hp.k24.scaled5.sig.zip.ksx", device="cuda")
    query = search_mod._as_index(f"{c.qfa}.hp.k24.scaled5.sig.zip", device="cuda")
    inv = target.inverted
    q_keys, q_valid = query.dense_device_keys()

    def timed(fn, reps=1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / reps

    # dense, position-sharded: the first call uploads the four slices
    _, t_first = timed(lambda: pdist.sharded_inverted_search(mesh, inv, q_keys, q_valid))
    (counts, weights), t_block = timed(lambda: pdist.sharded_inverted_search(mesh, inv, q_keys, q_valid), reps=5)
    (counts_h, weights_h), t_copy = timed(
        lambda: tuple(x.cpu().numpy() for x in pdist.sharded_inverted_search(mesh, inv, q_keys, q_valid))
    )
    if not (np.array_equal(counts_h, c.dense_counts) and np.array_equal(weights_h, c.dense_weights)):
        raise SystemExit("path D2: sharded_inverted_search differs from path C's dense engine")
    slices, local_n = pdist._sharded_sparse_program(mesh, inv)
    shard_postings = [int(s.gk.shape[0]) for s in slices]

    # sparse, position-sharded, densified
    hits, t_sparse = timed(lambda: pdist.sharded_sparse_search(mesh, inv, q_keys, q_valid))
    ns = np.zeros_like(c.dense_counts)
    nw = np.zeros_like(c.dense_weights)
    ns[hits.q, hits.t] = hits.count
    nw[hits.q, hits.t] = hits.weight.astype(np.int32)
    if hits.n_hits != len(hits.q) or not (np.array_equal(ns, c.dense_counts) and np.array_equal(nw, c.dense_weights)):
        raise SystemExit("path D2: sharded_sparse_search densified differs from path C's dense engine")
    pdist.clear_sharded_sparse_cache(inv)
    del counts, weights, counts_h, weights_h, ns, nw

    # target-sharded pair statistics against path B's, rows in FASTA order
    n_sub = c.pair_counts.shape[1]
    sub = ProteomeIndex.from_arrays(
        IndexConfig(), target.names[:n_sub], target.mins[: target.offsets[n_sub]],
        target.abundances[: target.offsets[n_sub]], target.offsets[: n_sub + 1], device="cuda",
    )
    row_of = {name: i for i, name in enumerate(query.names)}
    rows = [row_of[name] for name in c.qnames]
    (d_n, d_w), t_stats = timed(lambda: pdist.distributed_manysearch_stats(query, sub, mesh))
    if not (np.array_equal(d_n[rows], c.pair_counts) and np.array_equal(d_w[rows], c.pair_weighted)):
        raise SystemExit("path D2: distributed_manysearch_stats differs from path B's pairwise_stats")

    # the sharded pipeline step: 1,024 query rows split four ways
    arr, lens = pack_batch(validate_resolve_batch(c.queries))
    cap = sketch_mod.sketch_capacity(arr.shape[1], 24, 5)
    cap = max((cap + 127) // 128 * 128, 128)
    step = pdist.make_dist_pipeline_step(mesh, k=24, scaled=5, moltype="hp", capacity=cap)
    t_sharded = pdist.shard_targets(mesh, *sub.dense_device_arrays())
    out, t_step = timed(lambda: step(arr, lens, *t_sharded))
    if not (
        np.array_equal(out.intersect.cpu().numpy()[:, :n_sub], c.pair_counts)
        and np.array_equal(out.weighted.cpu().numpy()[:, :n_sub], c.pair_weighted)
    ):
        raise SystemExit("path D2: make_dist_pipeline_step differs from path B's pairwise_stats")
    if int(out.total_retained) != len(query.mins):
        raise SystemExit(
            f"path D2: total_retained {int(out.total_retained)} is not the sum of the query sketch sizes {len(query.mins)}"
        )
    _, t_dry = timed(lambda: dryrun_multichip(4))
    counts_d = launches()
    log(
        f"path D2 ({smi}): mesh of {mesh.size} shards on {sorted({str(d) for d in mesh.devices})} (logical "
        f"shards of one card: the layout, not a scaling); postings per shard {shard_postings} of "
        f"{inv.n_postings} (max_run {inv.max_run}); sharded_inverted_search {len(query)} x {len(target)}: "
        f"{t_first * 1e3:.1f} ms the first call (uploads the slices), {t_block * 1e3:.2f} ms a block with the "
        f"matrices left on the card = {len(query) / t_block:.0f} queries/s, {t_copy * 1e3:.1f} ms with both "
        f"matrices copied to the host; equal to path C's dense engine on all {c.dense_counts.size} pairs"
    )
    log(
        f"path D2 ({smi}): sharded_sparse_search {t_sparse * 1e3:.1f} ms ({hits.n_hits} hit pairs, densified "
        f"equal to the dense counts and weighted sums); distributed_manysearch_stats {len(query)} x {n_sub} "
        f"{t_stats:.2f} s and make_dist_pipeline_step ({arr.shape[0]} x {arr.shape[1]} residues, capacity {cap}) "
        f"{t_step:.2f} s, both equal to path B's pairwise_stats; total_retained {int(out.total_retained)} = the "
        f"query sketch sizes; dryrun_multichip(4) {t_dry:.2f} s; launches {counts_d}"
    )
    if min(counts_d.values()) <= 0:
        raise SystemExit(f"path D2 left a kernel unlaunched: {counts_d}")
    return counts_d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true", help="stop after the kernel phase")
    ap.add_argument("--path-d-worker", type=int, default=None, metavar="RANK", help="run as one rank of path D's group")
    ap.add_argument("--init-method", help="the group's tcp:// address (with --path-d-worker)")
    ap.add_argument("--workdir", help="the starting process's work directory (with --path-d-worker)")
    args = ap.parse_args()
    if args.path_d_worker is not None:
        return path_d_worker(args.path_d_worker, args.init_method, args.workdir)

    log(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke needs a GPU")
        return 2
    smi = nvidia_smi("name,power.limit")
    log(f"card: {smi}")
    dev = torch.device("cuda")
    # the corpus has a generator of its own, so it is the same whatever
    # the kernel phase draws (tests/test_torch_cli.py cuts it at seed 0)
    kernel_rng = np.random.default_rng(args.seed + 1)

    t0 = time.perf_counter()
    secs = cuda_build.build_all(SOURCES)
    log(f"build: {secs} (wall {time.perf_counter() - t0:.1f} s)")
    for source in SOURCES:  # what ptxas reported (nvcc -Xptxas -v)
        for u in cuda_build.resource_usage(source):
            log(
                f"ptxas {source}: {u['kernel']}: {u['registers']} registers, {u['smem_bytes']} B static "
                f"shared memory, stack {u['stack_bytes']} B, spills {u['spill_store_bytes']} B stored / "
                f"{u['spill_load_bytes']} B loaded"
            )

    t0 = time.perf_counter()
    entries = {e["name"]: e for e in kernel_phase(kernel_rng, dev)}
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    if args.kernels_only:
        print(json.dumps({"kernels": list(entries.values())}))
        return 0

    with tempfile.TemporaryDirectory(prefix="kmerseek-smoke-") as workdir:
        c = Corpus(np.random.default_rng(args.seed), workdir)
        t0 = time.perf_counter()
        by_path = {}  # every kernel's launches in every path's run
        by_path["main"] = main_path_phase(c)
        entries["masked_window_keys"]["launches"] = by_path["main"]["masked_window_keys"]
        log(f"main-path phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        by_path["A"] = path_a_phase(c)
        entries["window_hashes"]["launches"] = by_path["A"]["window_hashes"]
        log(f"path A phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        by_path["B"] = path_b_phase(c)
        entries["bitonic_sort_rows"]["launches"] = by_path["B"]["bitonic_sort_rows"]
        log(f"path B phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        by_path["C"] = path_c_phase(c, smi)
        log(f"path C phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        by_path["D1 rank 0"] = path_d1_phase(c, smi)
        log(f"path D1 phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        by_path["D2"] = path_d2_phase(c, smi)
        log(f"path D2 phase: {time.perf_counter() - t0:.1f} s")
        for name, e in entries.items():
            e["launches_by_path"] = {path: counts[name] for path, counts in by_path.items()}

    print(json.dumps({"kernels": list(entries.values())}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
