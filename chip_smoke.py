"""Smoke run of the PyTorch/CUDA port on one GPU: build, kernel checks,
and the port's seven paths at the scale of a human reference proteome.

    python3 chip_smoke.py [--seed N] [--kernels-only]

(``--kernels-only`` stops after phase 3 and prints no result line: the
quick check of a kernel edit. ``--path-d-worker RANK`` is how the script
starts itself as one rank of path D's process group.)

Phases (each prints its lines; any failure exits non-zero):

1. environment: torch version, the card's name and power limit; no CUDA
   device → exit 2;
2. build: compile every CUDA source of the port (one nvcc each, in
   parallel) and, beside them, the C++ host library (``native``);
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
   and ``dryrun_multichip(4)`` passes, its 120,000-target stage included
   (its summary is printed). All three kernels launched. Four
   logical shards on one card show the layout, not a scaling;
9. path E, the host side, on the same corpus. E1: ``index --engine
   native`` (the C++ CPU sketcher) writes the main path's ``.sig.zip``
   bytes and ``.ksx`` members, launching no sketch kernel; a fresh
   process loads the built library without compiling it. E2: ``index
   --profile DIR --force`` writes the same products and one Chrome trace
   holding the masked kernel's CUDA events; its wall beside a plain
   run's. Then ``search --profile DIR --force`` writes the main path's
   search CSV and a trace in which every ``kmerseek/`` range lies inside
   its parent span's range and the sketch's and the cross-check's
   kernels were launched inside ``index.sketch_device`` and
   ``search.cross_check`` (``range_report``). E3: ``python -m kmerseek_tpu_torch.native_cli index`` at its
   defaults (protein/k10/scaled1: every window kept, rows as wide as
   their windows) on the card; the loaded ``.ksx`` equals
   ``ProteomeIndex.build(engine="native")`` bit for bit (mins,
   abundances, offsets, postings, ``max_run``, bucket table), and the
   postings equal the host build's with the native argsort too. E4: the
   main path's ``.ksx`` rewritten as format 1 gives the main path's
   search CSV byte for byte, and so does a ``.ksx`` with one damaged
   posting under ``KMERSEEK_LOAD_VERIFY=full`` (without it the damage
   loses a hit). Each step's products land in a directory of their own;
10. path F, the sparse and dense engines' serving surface (plain PyTorch:
   no kernel of the port runs, the launch counts stay 0). F1, cold
   serving of the main path's ``.ksx``: the 1,024 queries as 8 blocks of
   128 through ``sparse_search`` learn hints, a ``save`` keeps them and a
   fresh ``load`` seeds them back; block 1 is answered by
   ``sparse_search_host`` while ``device_postings`` uploads in a thread,
   ``warm_sparse_engine`` returns True without changing the hints, one
   ``_sparse_launch`` runs under ``torch.cuda.set_sync_debug_mode
   ("error")``, and ``sparse_search_stream`` serves the other 7 blocks;
   every block equals its per-block ``sparse_search`` and the host route,
   and their union, densified, equals path C's matrices. F2:
   ``build_inverted_dev`` equals the host build (columns, bucket table,
   scalars, ``max_ab``); ``inverted_pair_stats_packed`` (bucketed and
   full-range) and ``inverted_pair_stats_bucketed`` equal path C's
   matrices; ``autotune_dense_block`` records its winner, which
   ``inverted_search`` then dispatches in; a ``.ksx`` saved from the
   ``DeviceInvertedIndex`` holds the main path's members. F3, sparse
   serving at SwissProt scale (``bench_search.measure_search_sparse``'s
   synthetic index: 524,288 targets of 64-127 hashes from a 2^22 pool,
   ~50M postings; 2,048 queries, ``q_chunk`` 512): the device build
   equals the host build, ``sparse_search`` equals ``sparse_search_host``,
   a stream of 6 blocks equals per-block calls, the warm-up returns True;
11. a JSON line with every kernel's numbers, the ``nvidia-smi`` line, and
   the result line ``{"ok": true, "device": {...}}`` last. A kernel's
   ``launches`` counts its wrapper's calls in the run of the path that
   introduced it (``launches_by_path`` has every path's count, paths D
   to F too); one sort call is one grid up to 131,072 keys a row
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
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from kmerseek_tpu_torch.core.fasta import pack_fixed_grid
from kmerseek_tpu_torch.core.index import ProteomeIndex
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
from kmerseek_tpu_torch.utils import metrics

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
# the suffix of index's products at its defaults (hp/k24/scaled5)
SIG = ".hp.k24.scaled5.sig.zip"
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
        self.main_products = os.path.join(workdir, "main")  # the main path's .sig.zip and .ksx, kept
        self.t_index = None  # the main path's index wall
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


LAUNCHED = ("masked_window_keys", "window_hashes", "bitonic_sort_rows")
_tallied = {}


def _tallies() -> dict:
    """The registry's totals of the wrappers' launches and of the sparse
    cross-checks (``search.cross_check`` spans)."""
    c = metrics.counters()
    out = {n: c.get(f"launches.{n}", 0) for n in LAUNCHED}
    out["validations"] = metrics.span_totals().get("search.cross_check", (0, 0.0))[0]
    return out


def reset_launches():
    """Count launches and cross-checks from here on."""
    _tallied.clear()
    _tallied.update(_tallies())


def launches() -> dict:
    now = _tallies()
    return {n: int(now[n] - _tallied.get(n, 0)) for n in LAUNCHED}


def validations() -> int:
    return int(_tallies()["validations"] - _tallied.get("validations", 0))


def exchange_stats() -> dict:
    """Bytes and seconds of every all-gather of this process so far."""
    c = metrics.counters()
    return {"bytes_sent": int(c.get("exchange.bytes_sent", 0)),
            "bytes_received": int(c.get("exchange.bytes_received", 0)),
            "seconds": metrics.span_totals().get("dist.exchange", (0, 0.0))[1]}


def main_path_phase(c: Corpus) -> dict:
    tfa, qfa, lens, planted = c.tfa, c.qfa, c.lens, c.planted

    timer = KernelTimer(sm_clock_hz())
    sketch_mod.masked_window_keys = timer
    reset_launches()
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
    n_validations = validations()
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
        f"(more than the rows' lengths need); sparse cross-check runs {n_validations}; "
        f"{len(rows)} result rows, planted found {len(planted) - len(missing)}/{len(planted)}"
    )
    if launched <= 0:
        raise SystemExit("the main path launched no sketch kernel")
    if n_validations <= 0:
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
    # path A rewrites these products (with sequences); path E is held
    # against the main path's own
    os.makedirs(c.main_products)
    shutil.copy(f"{tfa}{SIG}", c.main_products)
    shutil.copytree(f"{tfa}{SIG}.ksx", os.path.join(c.main_products, os.path.basename(f"{tfa}{SIG}.ksx")))
    c.t_index = t_index
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

    # the column-native CSV writer against the writer over plain row
    # dicts, on the manysearch columns of the main path's pair of indexes
    query = search_mod._as_index(qsig, device="cuda")
    target = ProteomeIndex.load(f"{tsig}.ksx", device="cuda")
    cols = search_mod.manysearch_columns(query, target)
    by_cols, by_rows = (os.path.join(c.workdir, n) for n in ("cols.csv", "rows.csv"))
    t0 = time.perf_counter()
    search_mod.write_search_csv_columns(cols, by_cols)
    t_cols = time.perf_counter() - t0
    t0 = time.perf_counter()
    search_mod.write_search_csv(list(search_mod.SearchRows(cols)), search_mod.MANYSEARCH_COLUMNS, by_rows)
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

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    reset_launches()
    got = timed("rendezvous", multihost.initialize_distributed, init_method, D1_WORLD, rank)
    if got != (rank, D1_WORLD):
        raise SystemExit(f"rank {rank}: the group reports {got}")
    idx = timed("build_distributed", ProteomeIndex.build_distributed, tfa, device=dev)
    replica = exchange_stats()  # the full-replica build's share of the exchange
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
        "rank": rank, "walls": walls, "exchange_replica": replica, "exchange": exchange_stats(),
        "n_local_postings": int(sh.n_local_postings), "hash_range": list(sh.hash_range),
        "g_min": int(g.min()), "g_max": int(g.max()), "n_targets": len(sh),
        "launches": launches(), "validations": validations(),
        "device": str(sh.device),
    }
    with open(paths["result"], "w") as f:
        json.dump(result, f)
    multihost.shutdown_distributed()
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
    dry_line, t_dry = timed(lambda: dryrun_multichip(4))
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
    if "; scale run ok" not in dry_line:
        raise SystemExit(f"path D2: dryrun_multichip(4) ran no 120,000-target stage: {dry_line}")
    log(f"path D2 ({smi}): dryrun_multichip(4) 120,000-target stage{dry_line.partition('; scale run ok')[2]}")
    if min(counts_d.values()) <= 0:
        raise SystemExit(f"path D2 left a kernel unlaunched: {counts_d}")
    return counts_d


# ---------------------------------------------------------------------------
# path E: the host side — --engine native, --profile, native_cli, format 1
# ---------------------------------------------------------------------------

# the products `index` writes next to its FASTA at the defaults
PRODUCT_SUFFIXES = (SIG, f"{SIG}.ksx", f"{SIG}.siglist")


def _move_products(fasta: str, dst: str) -> None:
    """Move ``index``'s products of ``fasta`` into directory ``dst``."""
    os.makedirs(dst, exist_ok=True)
    for suffix in PRODUCT_SUFFIXES:
        if os.path.exists(fasta + suffix):
            os.replace(fasta + suffix, os.path.join(dst, os.path.basename(fasta + suffix)))


def _ksx_members(ksx: str) -> dict:
    """Every array member of a format-2 ``.ksx`` and its metadata."""
    with open(os.path.join(ksx, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(ksx, "metadata.json")) as f:
        out = {"metadata": json.load(f), "inverted_shape": manifest["inverted_shape"]}
    for name in manifest["files"]:
        out[name] = np.load(os.path.join(ksx, f"{name}.npy"))
    return out


def _same_members(a: dict, b: dict) -> list:
    """Names of the members that differ (dtype or content)."""
    return [
        k for k in sorted(set(a) | set(b))
        if not (k in a and k in b and (
            a[k] == b[k] if not isinstance(a[k], np.ndarray)
            else a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        ))
    ]


def _search_csv(query, target, out: str) -> bytes:
    from kmerseek_tpu_torch.core import search as search_mod

    search_mod.write_search_csv(search_mod.manysearch(query, target), search_mod.MANYSEARCH_COLUMNS, out)
    return _read_bytes(out)


def _write_format1(src: str, dst: str) -> None:
    """A format-2 ``.ksx`` rewritten as format 1 (``arrays.npz`` +
    ``inverted.npz``, no manifest and no ``.npy`` members)."""
    shutil.copytree(src, dst)
    m = _ksx_members(src)
    np.savez(os.path.join(dst, "arrays.npz"), mins=m["mins"], abundances=m["abundances"], offsets=m["offsets"])
    np.savez(
        os.path.join(dst, "inverted.npz"), g_hi=m["inv_g_hi"], g_lo=m["inv_g_lo"], tid=m["inv_tid"],
        ab=m["inv_ab"], bucket_starts=m["inv_bucket_starts"], shape=np.asarray(m["inverted_shape"], np.int64),
    )
    for name in os.listdir(dst):
        if name.endswith(".npy") or name == "manifest.json":
            os.remove(os.path.join(dst, name))
    meta = dict(m["metadata"], format_version=1)
    with open(os.path.join(dst, "metadata.json"), "w") as f:
        json.dump(meta, f)


def _damage_one_posting(ksx: str, query_mins: np.ndarray) -> int:
    """Raise by one the low word of a posting whose hash a query holds,
    keeping the postings sorted and ``inv_g_lo.npy``'s size: only the
    manifest's content checksums can tell. Returns the posting's index."""
    path = os.path.join(ksx, "inv_g_lo.npy")
    g_hi, g_lo = np.load(os.path.join(ksx, "inv_g_hi.npy")), np.load(path)
    g = (g_hi.astype(np.uint64) << np.uint64(32)) | g_lo.astype(np.uint64)
    for p in np.flatnonzero(np.isin(g, query_mins)):
        if g_lo[p] < 0xFFFFFFFF and (p == 0 or g[p - 1] < g[p]) and (p + 1 == len(g) or g[p] + 1 < g[p + 1]):
            size = os.path.getsize(path)
            g_lo[p] += 1
            np.save(path, g_lo)
            if os.path.getsize(path) != size:
                raise SystemExit("path E4: damaging a posting changed inv_g_lo.npy's size")
            return int(p)
    raise SystemExit("path E4: no posting that a query hits can be damaged in place")


def native_cli(*args) -> str:
    """``python -m kmerseek_tpu_torch.native_cli ARGS``, run in this
    process (launch counters stay visible); returns its stderr."""
    argv = sys.argv
    sys.argv = ["kmerseek_tpu_torch.native_cli", *args]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stderr(buf):
            runpy.run_module("kmerseek_tpu_torch.native_cli", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code not in (0, None):
            raise SystemExit(f"native_cli {' '.join(args)} failed with exit {e.code}:\n{buf.getvalue()[-3000:]}")
    finally:
        sys.argv = argv
    return buf.getvalue()


def _main_products(c: Corpus):
    """The main path's .sig.zip bytes and .ksx members."""
    base = os.path.join(c.main_products, os.path.basename(c.tfa) + SIG)
    return _read_bytes(base), _ksx_members(base + ".ksx")


def path_e1(c: Corpus, smi: str) -> None:
    """The native CPU sketcher through the CLI."""
    from kmerseek_tpu_torch import native

    main_sig, main_ksx = _main_products(c)
    e0 = launches()["masked_window_keys"]
    t_native = _timed("index", "--engine", "native", c.tfa)
    e1 = launches()["masked_window_keys"] - e0
    bad = _same_members(_ksx_members(c.tfa + SIG + ".ksx"), main_ksx)
    if _read_bytes(c.tfa + SIG) != main_sig or bad:
        raise SystemExit(f"path E1: index --engine native differs from the main path's products ({bad or '.sig.zip'})")
    if e1:
        raise SystemExit(f"path E1: index --engine native launched the sketch kernel {e1} times")
    _move_products(c.tfa, os.path.join(c.workdir, "e1"))
    probe = subprocess.run(
        [sys.executable, "-c",
         "import time; t0 = time.perf_counter(); from kmerseek_tpu_torch import native; "
         "assert native.available(); print(native.build_seconds, native.load_seconds, time.perf_counter() - t0)"],
        capture_output=True, text=True, cwd=os.path.dirname(os.path.abspath(__file__)), timeout=120,
    )
    if probe.returncode != 0:
        raise SystemExit(f"path E1: loading the built native library in a fresh process failed:\n{probe.stderr[-2000:]}")
    cached_build, cached_load, cached_wall = (float(x) for x in probe.stdout.split())
    if cached_build != 0.0:
        raise SystemExit(f"path E1: a fresh process compiled the native library again ({cached_build} s)")
    log(
        f"path E1 ({smi}): index --engine native (hp/k24/scaled5, {len(c.targets)} targets) {t_native:.2f} s "
        f"(host clock, incl. file I/O; the main path's device index took {c.t_index:.2f} s); .sig.zip "
        f"({len(main_sig)} B) and every .ksx member equal to the main path's; sketch-kernel launches "
        f"{e1}; native library {native.library_file()}: built in "
        f"{native.build_seconds:.2f} s in this process, a fresh process loads it in {cached_load * 1e3:.1f} ms "
        f"({cached_wall * 1e3:.0f} ms with the import)"
    )



def path_e2(c: Corpus, smi: str) -> None:
    """The device index under torch.profiler, beside a plain run."""
    main_sig, main_ksx = _main_products(c)
    t_plain = _timed("index", "--force", c.tfa)
    before = launches()["masked_window_keys"]
    trace_dir = os.path.join(c.workdir, "e2-trace")
    t_prof = _timed("index", "--profile", trace_dir, "--force", c.tfa)
    e2_launches = launches()["masked_window_keys"] - before
    bad = _same_members(_ksx_members(c.tfa + SIG + ".ksx"), main_ksx)
    if _read_bytes(c.tfa + SIG) != main_sig or bad:
        raise SystemExit(f"path E2: index --profile differs from the main path's products ({bad or '.sig.zip'})")
    search_ranges(c, smi)
    _move_products(c.tfa, os.path.join(c.workdir, "e2"))
    traces = [os.path.join(trace_dir, n) for n in os.listdir(trace_dir) if n.endswith(".json")]
    if len(traces) != 1:
        raise SystemExit(f"path E2: index --profile wrote {len(traces)} traces into {trace_dir}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    masked = [e for e in kernels if "masked_sketch_kernel" in e.get("name", "")]
    masked_us = sum(float(e.get("dur", 0)) for e in masked)
    log(
        f"path E2 ({smi}): index --profile {t_prof:.2f} s against {t_plain:.2f} s plain (host clock, same "
        f"command); trace {os.path.getsize(traces[0])} B, {len(events)} events, {len(kernels)} CUDA kernel "
        f"events, of them {len(masked)} of masked_sketch_kernel ({masked_us / 1e3:.3f} ms device time) for "
        f"{e2_launches} wrapper launches; products equal to the main path's"
    )
    if not masked:
        raise SystemExit(f"path E2: the trace holds no masked_sketch_kernel event ({len(kernels)} kernel events)")



def range_report(events: list, parent_of: dict) -> dict:
    """The program's ``kmerseek/`` ranges in a Chrome trace: the ranges
    that lie outside every range of their parent span's name on their
    thread (``parent_of``: span name → its parent's, from the registry),
    and by innermost range the kernels and copies whose launch (the CUDA
    runtime or driver call with the same correlation id) falls inside
    it."""
    # the host's ranges (the profiler also projects each range onto the
    # stream its kernels ran on, as ``gpu_user_annotation``)
    ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("kmerseek/")]
    by_tid = {}
    for e in ranges:
        by_tid.setdefault(e["tid"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][9:]))
    misplaced = []
    for e in ranges:
        name, t0, t1 = e["name"][9:], float(e["ts"]), float(e["ts"]) + float(e["dur"])
        parent = parent_of.get(name)
        if parent and not any(p == parent and a <= t0 and t1 <= b for a, b, p in by_tid[e["tid"]]):
            misplaced.append(name)
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["tid"], float(e["ts"]))
    found = {}
    for e in events:
        kind = {"kernel": "kernels", "gpu_memcpy": "copies", "gpu_memset": "memsets"}.get(e.get("cat"))
        if kind is None:
            continue
        where = "no launch event"
        tid, ts = launch.get(e.get("args", {}).get("correlation"), (None, None))
        if tid is not None:
            inner = [(b - a, n) for a, b, n in by_tid.get(tid, []) if a <= ts <= b]
            where = min(inner)[1] if inner else "outside every range"
        cell = found.setdefault(where, {"kernels": 0, "copies": 0, "memsets": 0})
        cell[kind] += 1
    return {"ranges": len(ranges), "misplaced": misplaced, "device_ops_by_range": found}


def search_ranges(c: Corpus, smi: str) -> None:
    """``search --profile`` (query and target sketched anew): every
    ``kmerseek/`` range inside its parent's, and the device work of the
    sketch and of the cross-check inside their ranges."""
    trace_dir = os.path.join(c.workdir, "e2-search-trace")
    out = os.path.join(c.workdir, "e2-search.csv")
    t0 = time.perf_counter()
    t_prof = _timed("search", "--profile", trace_dir, "--force", c.qfa, c.tfa, "--output", out)
    me = threading.get_ident()
    recs = [r for r in metrics.records(since=t0) if r.thread == me]
    names = {r.span_id: r.name for r in recs}
    parent_of = {r.name: names[r.parent_id] for r in recs if r.parent_id in names}
    if _read_bytes(out) != _read_bytes(c.search_csv):
        raise SystemExit("path E2: search --profile's CSV differs from the main path's")
    (trace,) = [os.path.join(trace_dir, n) for n in os.listdir(trace_dir) if n.endswith(".json")]
    with open(trace) as f:
        rep = range_report(json.load(f)["traceEvents"], parent_of)
    log(
        f"path E2 ({smi}): search --profile {t_prof:.2f} s, CSV equal to the main path's; {rep['ranges']} "
        f"kmerseek/ ranges, {len(rep['misplaced'])} outside their parent's; parents {parent_of}; device "
        f"operations by innermost range {json.dumps(rep['device_ops_by_range'], sort_keys=True)}"
    )
    ops = rep["device_ops_by_range"]
    if rep["misplaced"]:
        raise SystemExit(f"path E2: ranges outside their parent's: {sorted(set(rep['misplaced']))}")
    for name in ("index.sketch_device", "search.cross_check"):
        if not ops.get(name, {}).get("kernels"):
            raise SystemExit(f"path E2: no kernel launched inside the kmerseek/{name} range")


def path_e3(c: Corpus, smi: str) -> None:
    """kmerseek-rust's index at its defaults (protein/k10/scaled1) on the card."""
    from kmerseek_tpu_torch.core.index import IndexConfig
    from kmerseek_tpu_torch.ops.inverted import build_inverted_np

    before = launches()["masked_window_keys"]
    t0 = time.perf_counter()
    stderr = native_cli("index", "--input", c.tfa)
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t0
    e3_launches = launches()["masked_window_keys"] - before
    ksx = f"{c.tfa}.protein.k10.scaled1.kmerseek.ksx"
    got = ProteomeIndex.load(ksx, device="cuda")
    t0 = time.perf_counter()
    ref = ProteomeIndex.build(c.tfa, IndexConfig(10, 1, "protein"), engine="native", device="cuda")
    t_ref = time.perf_counter() - t0
    windows = int(np.maximum(c.lens - 10 + 1, 0).sum())
    for f in ("mins", "abundances", "offsets"):
        if not np.array_equal(getattr(got, f), getattr(ref, f)):
            raise SystemExit(f"path E3: native_cli's {f} differ from the native build's")
    if ref.names != got.names or int(got.abundances.sum()) != windows:
        raise SystemExit("path E3: names differ, or the scaled=1 index did not keep every window")
    t0 = time.perf_counter()
    host_inv = build_inverted_np(ref.mins, ref.abundances, ref.offsets)  # the native argsort
    t_host_inv = time.perf_counter() - t0
    for inv, what in ((ref.inverted, "the native build's device postings"), (host_inv, "the host build's")):
        same = all(np.array_equal(np.asarray(getattr(got.inverted, f)), np.asarray(getattr(inv, f)))
                   for f in ("g_hi", "g_lo", "tid", "ab", "bucket_starts"))
        shape = [getattr(x, f) for x in (got.inverted, inv) for f in ("n_targets", "max_run", "max_span", "bucket_shift")]
        if not same or shape[:4] != shape[4:]:
            raise SystemExit(f"path E3: native_cli's postings differ from {what}")
    log(
        f"path E3 ({smi}): native_cli index (protein/k10/scaled1, every window kept) {t_cli:.2f} s on the "
        f"card (host clock, in this process, incl. save); {windows} windows = {windows / t_cli / 1e6:.2f} M "
        f"windows/s, {got.inverted.n_postings} postings (max_run {got.inverted.max_run}), masked-kernel "
        f"launches {e3_launches}; .ksx equal bit for bit to ProteomeIndex.build(engine='native') "
        f"({t_ref:.2f} s): mins, abundances, offsets and the postings (g_hi, g_lo, tid, ab, max_run, bucket "
        f"table), also to the host build with the native argsort ({t_host_inv:.2f} s). native_cli says: "
        + " | ".join(stderr.strip().splitlines())
    )
    if e3_launches <= 0:
        raise SystemExit("path E3: native_cli launched no sketch kernel on the card")


def path_e4(c: Corpus, smi: str) -> None:
    """A format-1 .ksx, and a damaged one under the full load verify."""
    from kmerseek_tpu_torch.core import search as search_mod

    query = search_mod._as_index(f"{c.qfa}{SIG}", device="cuda")
    main_dir = os.path.join(c.main_products, os.path.basename(c.tfa) + SIG + ".ksx")
    want = _read_bytes(c.search_csv)
    f1 = os.path.join(c.workdir, "e4-format1.ksx")
    _write_format1(main_dir, f1)
    t0 = time.perf_counter()
    target = ProteomeIndex.load(f1, device="cuda")
    t_f1 = time.perf_counter() - t0
    if target._inverted is None or _search_csv(query, target, os.path.join(c.workdir, "e4-f1.csv")) != want:
        raise SystemExit("path E4: the format-1 .ksx does not give the main path's search CSV")
    dmg = os.path.join(c.workdir, "e4-damaged.ksx")
    shutil.copytree(main_dir, dmg)
    p = _damage_one_posting(dmg, query.mins)
    lossy = _search_csv(query, ProteomeIndex.load(dmg, device="cuda"), os.path.join(c.workdir, "e4-lossy.csv"))
    os.environ["KMERSEEK_LOAD_VERIFY"] = "full"
    try:
        t0 = time.perf_counter()
        verified = ProteomeIndex.load(dmg, device="cuda")
        t_verify = time.perf_counter() - t0
    finally:
        del os.environ["KMERSEEK_LOAD_VERIFY"]
    if verified._inverted is not None:
        raise SystemExit("path E4: the full verify kept the damaged postings")
    if _search_csv(query, verified, os.path.join(c.workdir, "e4-verified.csv")) != want:
        raise SystemExit("path E4: the damaged .ksx under KMERSEEK_LOAD_VERIFY=full does not give the main path's CSV")
    if lossy == want:
        raise SystemExit("path E4: the damaged posting did not change the search without the full verify")
    log(
        f"path E4 ({smi}): format-1 .ksx loaded in {t_f1:.2f} s (arrays.npz + inverted.npz read whole) and its "
        f"search CSV equals the main path's byte for byte; posting {p} damaged in inv_g_lo.npy (size kept): "
        f"without the verify the search loses a hit, with KMERSEEK_LOAD_VERIFY=full the load ({t_verify:.2f} s, "
        f"every member read) drops the postings, they are rebuilt on the card, and the CSV equals the main "
        f"path's again"
    )


def path_e_phase(c: Corpus, smi: str) -> dict:
    """E1 ``index --engine native``, E2 ``index --profile`` and ``search
    --profile``, E3
    ``native_cli index`` at protein/k10/scaled1, E4 format-1 and
    full-verify loads. Returns the launch counts of the whole path."""
    _move_products(c.tfa, os.path.join(c.workdir, "a"))  # path A's, out of the way
    reset_launches()
    for step in (path_e1, path_e2, path_e3, path_e4):
        t0 = time.perf_counter()
        step(c, smi)
        log(f"{step.__name__}: {time.perf_counter() - t0:.1f} s")
    counts = launches()
    log(f"path E launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# path F: the sparse and dense engines' serving surface
# ---------------------------------------------------------------------------

F_BLOCK = 128  # F1's serving block: the 1,024 queries as 8 blocks
# F3: the synthetic SwissProt-scale index of bench_search.measure_search_sparse
F3_TARGETS, F3_SLOTS, F3_POOL_BITS, F3_QUERIES, F3_Q_CHUNK = 524288, 128, 22, 2048, 512


def _same_hits(a, b, what: str) -> None:
    if a.n_hits != b.n_hits or not all(
        np.array_equal(getattr(a, f), getattr(b, f)) for f in ("q", "t", "count", "weight")
    ):
        raise SystemExit(f"{what}: hit lists differ ({a.n_hits} against {b.n_hits} pairs)")


def _clear_hint_caches() -> None:
    from kmerseek_tpu_torch.ops import inverted as inv_mod
    from kmerseek_tpu_torch.ops import sparse_search as sp

    sp._EXPAND_CACHE.clear()
    sp._HP_CACHE.clear()
    inv_mod._DENSE_BLOCK_CACHE.clear()
    inv_mod.clear_device_postings()


def _device_trace(fn, workdir: str, name: str):
    """``(kernel launches, device ms)`` of one call of ``fn`` under
    ``torch.profiler``: CUDA kernel events and the device time of kernels,
    copies and memsets, read from the exported Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.join(workdir, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy = kernels + [e for e in events if e.get("cat") in ("gpu_memcpy", "gpu_memset")]
    return len(kernels), sum(float(e.get("dur", 0)) for e in busy) / 1e3


def path_f1(c: Corpus, smi: str) -> None:
    """Cold serving of the human-proteome index: learn hints, save, load,
    answer block 1 on the host while the postings upload, warm up, stream
    the rest."""
    import threading

    from kmerseek_tpu_torch.core import search as search_mod
    from kmerseek_tpu_torch.ops import sparse_search as sp
    from kmerseek_tpu_torch.ops.inverted import device_postings

    query = search_mod._as_index(f"{c.qfa}{SIG}", device="cuda")
    q_keys, q_valid = query.dense_device_keys()
    Q, S = q_keys.shape
    blocks = [(q_keys[a : a + F_BLOCK], q_valid[a : a + F_BLOCK]) for a in range(0, Q, F_BLOCK)]
    host_blocks = [(k.cpu().numpy(), v.cpu().numpy()) for k, v in blocks]
    main_ksx = os.path.join(c.main_products, os.path.basename(c.tfa) + SIG + ".ksx")
    _clear_hint_caches()
    target = ProteomeIndex.load(main_ksx, device="cuda")
    serial = [sp.sparse_search(target, k, v) for k, v in blocks]  # learns E and the fetch lengths
    saved = os.path.join(c.workdir, "f1.ksx")
    target.save(saved)
    learned = sp.export_learned_hints(target.inverted)
    if not learned["expand"] or not learned["hp"]:
        raise SystemExit(f"path F1: the sparse searches learned no hints: {learned}")
    del target
    _clear_hint_caches()

    # a fresh server: load, answer block 1 on the host while the postings upload
    t0 = time.perf_counter()
    served = ProteomeIndex.load(saved, device="cuda")
    t_load = time.perf_counter() - t0
    if sp.export_learned_hints(served.inverted) != learned:
        raise SystemExit("path F1: the loaded .ksx did not seed the hints it was saved with")
    upload = {}

    def _upload():
        t = time.perf_counter()
        device_postings(served.inverted, "cuda")
        torch.cuda.synchronize()
        upload["s"] = time.perf_counter() - t

    thread = threading.Thread(target=_upload)
    thread.start()
    t1 = time.perf_counter()
    first = sp.sparse_search_host(served, *host_blocks[0])
    t_host = time.perf_counter() - t1
    t_first_answer = time.perf_counter() - t0
    thread.join()
    t1 = time.perf_counter()
    warm = sp.warm_sparse_engine(served, (F_BLOCK, S))
    t_warm = time.perf_counter() - t1
    if warm is not True:
        raise SystemExit("path F1: warm_sparse_engine did not return True")
    if sp.export_learned_hints(served.inverted) != learned:
        raise SystemExit("path F1: the warm-up changed the learned hints")

    # the launch makes no host sync: sync debug mode "error" around it
    inv = served.inverted
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = sp._sparse_launch(inv, *blocks[1], None, inv.max_run)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _same_hits(sp._sparse_finish(inv, st), serial[1], "path F1: the sync-free launch")

    # streamed and serial, alternating, three readings each
    t_stream, t_serial = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        streamed = list(sp.sparse_search_stream(served, blocks[1:]))
        t_stream.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        again = [sp.sparse_search(served, k, v) for k, v in blocks[1:]]
        t_serial.append(time.perf_counter() - t1)
        for got, want in zip(streamed + again, serial[1:] * 2):
            _same_hits(got, want, "path F1: a streamed or repeated block")
    n_kernels, dev_ms = _device_trace(lambda: sp.sparse_search(served, *blocks[1]), c.workdir, "f1-block")
    answers = [first] + streamed
    for b, (got, want, hk) in enumerate(zip(answers, serial, host_blocks)):
        _same_hits(got, want, f"path F1 block {b}: served against per-block sparse_search")
        _same_hits(sp.sparse_search_host(served, *hk), want, f"path F1 block {b}: the host route")
    dense_c = np.zeros_like(c.dense_counts)
    dense_w = np.zeros_like(c.dense_weights)
    for b, h in enumerate(answers):
        dense_c[h.q + b * F_BLOCK, h.t] = h.count
        dense_w[h.q + b * F_BLOCK, h.t] = h.weight.astype(np.int32)
    if not (np.array_equal(dense_c, c.dense_counts) and np.array_equal(dense_w, c.dense_weights)):
        raise SystemExit("path F1: the served hit lists, densified, differ from path C's dense engine")
    if sp.export_learned_hints(served.inverted) != learned:
        raise SystemExit("path F1: serving the same blocks again changed the learned hints")
    n_stream = len(blocks) - 1
    log(
        f"path F1 ({smi}): {len(blocks)} blocks of {F_BLOCK} queries x {S} slots against {inv.n_postings} "
        f"postings ({sum(h.n_hits for h in answers)} hit pairs, equal per block to sparse_search and the host "
        f"route, densified equal to path C's matrices); hints {len(learned['expand'])} expand + "
        f"{len(learned['hp'])} hp saved and seeded back; load {t_load * 1e3:.1f} ms, host block "
        f"{t_host * 1e3:.1f} ms, time to the first answer {t_first_answer * 1e3:.1f} ms; upload "
        f"{upload['s'] * 1e3:.1f} ms in a thread meanwhile; warm-up {t_warm * 1e3:.1f} ms (True, hints "
        f"unchanged); one launch under sync debug mode 'error' made no host sync; ms a block over "
        f"{n_stream} blocks, three alternating readings: stream "
        f"{', '.join(f'{t / n_stream * 1e3:.2f}' for t in t_stream)}, serial "
        f"{', '.join(f'{t / n_stream * 1e3:.2f}' for t in t_serial)} = best "
        f"{n_stream * F_BLOCK / min(t_stream):.0f} against {n_stream * F_BLOCK / min(t_serial):.0f} queries/s; "
        f"one block under torch.profiler: {n_kernels} CUDA kernel launches, {dev_ms:.3f} ms of device time "
        f"(kernels, copies, memsets) = {dev_ms / (min(t_serial) / n_stream * 1e3) * 100:.1f}% of the best serial "
        f"block's wall"
    )


def path_f2(c: Corpus, smi: str) -> None:
    """The dense engine's new surface on the same index."""
    from kmerseek_tpu_torch.core import search as search_mod
    from kmerseek_tpu_torch.ops import inverted as inv_mod

    query = search_mod._as_index(f"{c.qfa}{SIG}", device="cuda")
    q_keys, q_valid = query.dense_device_keys()
    main_ksx = os.path.join(c.main_products, os.path.basename(c.tfa) + SIG + ".ksx")
    _clear_hint_caches()
    target = ProteomeIndex.load(main_ksx, device="cuda")
    host = target.inverted
    t0 = time.perf_counter()
    dinv = inv_mod.build_inverted_dev(target.mins, target.abundances, target.offsets, "cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    same = all(np.array_equal(np.asarray(getattr(dinv, f)), np.asarray(getattr(host, f)))
               for f in ("g_hi", "g_lo", "tid", "ab", "bucket_starts"))
    scalars = [(getattr(dinv, f), getattr(host, f)) for f in ("n_targets", "max_run", "max_span", "bucket_shift")]
    if not same or any(a != b for a, b in scalars) or dinv.max_ab != inv_mod.max_abundance(host):
        raise SystemExit(f"path F2: build_inverted_dev differs from the host build ({scalars}, max_ab {dinv.max_ab})")

    T = int(host.n_targets)
    kw = dict(n_targets=T, max_run=host.max_run, bucket_shift=host.bucket_shift)
    bucketed_steps = max(int(host.max_span).bit_length(), 1)
    cols = [torch.from_numpy(np.asarray(getattr(host, f)).astype(np.int64)).cuda()
            for f in ("g_hi", "g_lo", "tid", "ab", "bucket_starts")]
    engines = {
        "packed bucketed": lambda: inv_mod.inverted_pair_stats_packed(
            dinv.g4_dev, dinv.bucket_starts_dev, q_keys, q_valid, span_steps=bucketed_steps, **kw),
        "packed full-range": lambda: inv_mod.inverted_pair_stats_packed(
            dinv.g4_dev, None, q_keys, q_valid, span_steps=max(int(dinv.n_postings).bit_length(), 1), **kw),
        "split bucketed": lambda: inv_mod.inverted_pair_stats_bucketed(
            *cols, q_keys, q_valid, span_steps=bucketed_steps, **kw),
    }
    block_ms = {}
    for name, fn in engines.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_c, got_w = fn()
        torch.cuda.synchronize()
        block_ms[name] = (time.perf_counter() - t0) * 1e3
        if not (np.array_equal(got_c.cpu().numpy(), c.dense_counts) and np.array_equal(got_w.cpu().numpy(), c.dense_weights)):
            raise SystemExit(f"path F2: inverted_pair_stats ({name}) differs from path C's matrices")
    del got_c, got_w

    results = inv_mod.autotune_dense_block(target)
    winner = max(results, key=lambda b: results[b]["queries_per_second"])
    if inv_mod.dense_block_hint(host) != winner:
        raise SystemExit(f"path F2: autotune did not record its winner {winner}")
    # five copies of the block: the learned block sets the dispatches
    reps = 5
    rows = []
    real = inv_mod.inverted_pair_stats
    inv_mod.inverted_pair_stats = lambda dp, qk, *a, **k: rows.append(qk.shape[0]) or real(dp, qk, *a, **k)
    try:
        big_c, big_w = inv_mod.inverted_search(target, q_keys.repeat(reps, 1), q_valid.repeat(reps, 1))
    finally:
        inv_mod.inverted_pair_stats = real
    Q = q_keys.shape[0]
    want_rows = [min(winner, reps * Q - a) for a in range(0, reps * Q, winner)]
    if rows != want_rows:
        raise SystemExit(f"path F2: inverted_search dispatched {rows}, not blocks of the learned {winner}")
    big_c, big_w = big_c.cpu().numpy(), big_w.cpu().numpy()
    for r in range(reps):
        if not (np.array_equal(big_c[r * Q : (r + 1) * Q], c.dense_counts)
                and np.array_equal(big_w[r * Q : (r + 1) * Q], c.dense_weights)):
            raise SystemExit("path F2: inverted_search in the learned block differs from path C's matrices")
    del big_c, big_w

    # a .ksx saved from a device-built index (host columns from the CSR
    # arrays, no download) holds the main path's members
    fresh = inv_mod.build_inverted_dev(target.mins, target.abundances, target.offsets, "cuda")
    target._inverted = fresh
    out = os.path.join(c.workdir, "f2.ksx")
    t0 = time.perf_counter()
    target.save(out)
    t_save = time.perf_counter() - t0
    bad = _same_members(_ksx_members(out), _ksx_members(main_ksx))
    if bad:
        raise SystemExit(f"path F2: the .ksx saved from a DeviceInvertedIndex differs in {bad}")
    log(
        f"path F2 ({smi}): build_inverted_dev {t_build * 1e3:.1f} ms, equal to the host build (4 columns, bucket "
        f"table, max_run {dinv.max_run}, max_span {dinv.max_span}, bucket_shift {dinv.bucket_shift}, max_ab "
        f"{dinv.max_ab}); a {Q} x {T} block, equal to path C's matrices: "
        + ", ".join(f"{n} {ms:.2f} ms" for n, ms in block_ms.items())
        + "; autotune_dense_block "
        + ", ".join(f"{b}: {r['queries_per_second']:.0f} queries/s (first call {r['compile_s'] * 1e3:.1f} ms)"
                    for b, r in results.items())
        + f" -> {winner}, used by inverted_search ({reps * Q} rows in {rows}); .ksx saved from the "
        f"DeviceInvertedIndex in {t_save:.2f} s = the main path's members"
    )


def _f3_corpus():
    """bench_search.measure_search_sparse's synthetic index and query
    block (rng seed 1), here with 2,048 queries."""
    rng = np.random.default_rng(1)
    pool = np.unique(rng.integers(0, 2**62, size=1 << F3_POOL_BITS, dtype=np.uint64))
    t_c = rng.integers(F3_SLOTS // 2, F3_SLOTS, size=F3_TARGETS).astype(np.int64)
    vals = np.sort(pool[rng.integers(0, len(pool), size=(F3_TARGETS, F3_SLOTS))], axis=1)
    keep = np.ones_like(vals, bool)
    keep[:, 1:] = vals[:, 1:] != vals[:, :-1]
    keep &= np.arange(F3_SLOTS)[None, :] < t_c[:, None]
    mins = vals[keep]
    offsets = np.concatenate([[0], np.cumsum(keep.sum(axis=1))]).astype(np.int64)
    del vals, keep
    q64 = np.where(
        np.arange(F3_SLOTS)[None, :] % 2 == 0,
        pool[rng.integers(0, len(pool), size=(F3_QUERIES, F3_SLOTS))],
        rng.integers(0, 2**62, size=(F3_QUERIES, F3_SLOTS), dtype=np.uint64),
    )
    q64 = np.sort(q64, axis=1)
    qv = np.ones(q64.shape, bool)
    qv[:, 1:] = q64[:, 1:] != q64[:, :-1]
    return mins, offsets, q64, qv


def path_f3(c: Corpus, smi: str) -> None:
    """Sparse serving at SwissProt scale: 524,288 targets, ~50M postings."""
    from kmerseek_tpu_torch.ops import inverted as inv_mod
    from kmerseek_tpu_torch.ops import sparse_search as sp
    from kmerseek_tpu_torch.ops.u64 import u64_np_to_tensor

    _clear_hint_caches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mins, offsets, q64, qv = _f3_corpus()
    t_prep = time.perf_counter() - t0
    ab = np.ones(len(mins), np.int64)
    t0 = time.perf_counter()
    dinv = inv_mod.build_inverted_dev(mins, ab, offsets, "cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = inv_mod.build_inverted_np(mins, ab, offsets)  # the native argsort
    t_host_build = time.perf_counter() - t0
    scalars = [(getattr(dinv, f), getattr(host, f)) for f in ("n_targets", "max_run", "max_span", "bucket_shift")]
    for f in ("g_hi", "g_lo", "tid", "ab", "bucket_starts"):
        if not np.array_equal(np.asarray(getattr(dinv, f)), np.asarray(getattr(host, f))):
            raise SystemExit(f"path F3: build_inverted_dev's {f} differs from the host build")
    if any(a != b for a, b in scalars):
        raise SystemExit(f"path F3: build_inverted_dev's scalars differ from the host build: {scalars}")
    t0 = time.perf_counter()
    inv_mod.device_postings(host, "cuda")  # what a host-built index uploads
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    inv_mod.clear_device_postings(host)

    class _Index:
        inverted = dinv
        device = torch.device("cuda")

    idx = _Index()
    q_keys = u64_np_to_tensor(q64, "cuda")
    q_valid = torch.from_numpy(qv).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = sp.sparse_search(idx, q_keys, q_valid, q_chunk=F3_Q_CHUNK)
    t_first = time.perf_counter() - t0
    warm_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        hits = sp.sparse_search(idx, q_keys, q_valid, q_chunk=F3_Q_CHUNK)
        warm_s.append(time.perf_counter() - t0)
    _same_hits(hits, first, "path F3: a repeated sparse_search")
    n_kernels, dev_ms = _device_trace(
        lambda: sp.sparse_search(idx, q_keys, q_valid, q_chunk=F3_Q_CHUNK), c.workdir, "f3-call"
    )
    t0 = time.perf_counter()
    host_hits = sp.sparse_search_host(idx, q64.view(np.int64), qv)
    t_host = time.perf_counter() - t0
    _same_hits(first, host_hits, "path F3: sparse_search against sparse_search_host")
    # a stream of six 512-query blocks (each <= q_chunk: one in flight)
    rows = [(a % F3_QUERIES, a % F3_QUERIES + F3_Q_CHUNK) for a in range(0, 6 * F3_Q_CHUNK, F3_Q_CHUNK)]
    per_block = {r: sp.sparse_search(idx, q_keys[r[0] : r[1]], q_valid[r[0] : r[1]]) for r in set(rows)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamed = list(sp.sparse_search_stream(idx, [(q_keys[a:b], q_valid[a:b]) for a, b in rows]))
    t_stream = time.perf_counter() - t0
    for r, got in zip(rows, streamed):
        _same_hits(got, per_block[r], f"path F3: stream block {r}")
    t0 = time.perf_counter()
    warm = sp.warm_sparse_engine(idx, (F3_Q_CHUNK, F3_SLOTS))
    t_warm = time.perf_counter() - t0
    if warm is not True:
        raise SystemExit("path F3: warm_sparse_engine did not return True")
    peak = torch.cuda.max_memory_allocated()
    best = min(warm_s)
    log(
        f"path F3 ({smi}): {F3_TARGETS} targets, {dinv.n_postings} postings (max_run {dinv.max_run}, max_span "
        f"{dinv.max_span}), corpus made in {t_prep:.1f} s; build_inverted_dev {t_build:.2f} s, equal to the host "
        f"build with the native argsort ({t_host_build:.2f} s); a host-built index's upload {t_upload:.2f} s; "
        f"{F3_QUERIES} queries x {F3_SLOTS} slots, q_chunk {F3_Q_CHUNK} (C = {F3_QUERIES // F3_Q_CHUNK}): "
        f"{first.n_hits} hit pairs, first call {t_first * 1e3:.1f} ms, warm "
        f"{', '.join(f'{s * 1e3:.1f}' for s in warm_s)} ms = {F3_QUERIES / best:.0f} queries/s (one call under "
        f"torch.profiler: {n_kernels} CUDA kernel launches, {dev_ms:.2f} ms of device time = "
        f"{dev_ms / (best * 1e3) * 100:.1f}% of the best warm wall); sparse_search_host {t_host:.2f} s, equal; "
        f"stream of 6 blocks of {F3_Q_CHUNK} {t_stream / 6 * 1e3:.1f} ms a block = {6 * F3_Q_CHUNK / t_stream:.0f} queries/s, equal "
        f"to per-block calls; warm_sparse_engine {t_warm * 1e3:.1f} ms (True); device memory peak "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)"
    )
    del dinv, host, idx, q_keys, q_valid
    _clear_hint_caches()
    torch.cuda.empty_cache()


def path_f_phase(c: Corpus, smi: str) -> dict:
    """F1 cold serving, F2 the dense engine's new surface, F3 sparse
    serving at SwissProt scale. No kernel of the port runs here. Returns
    the launch counts of the whole path."""
    reset_launches()
    for step in (path_f1, path_f2, path_f3):
        t0 = time.perf_counter()
        step(c, smi)
        log(f"{step.__name__}: {time.perf_counter() - t0:.1f} s")
    counts = launches()
    log(f"path F launches {counts} (no kernel of the port is on this path)")
    return counts


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

    from concurrent.futures import ThreadPoolExecutor

    from kmerseek_tpu_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:  # the C++ host library beside the nvcc builds
        host_lib = pool.submit(native.available)
        secs = cuda_build.build_all(SOURCES)
        if not host_lib.result():
            raise SystemExit("no C++ compiler: the native host library cannot be built")
    log(
        f"build: {secs}, native host library {native.build_seconds:.1f} s ({native.library_file()}) "
        f"(wall {time.perf_counter() - t0:.1f} s)"
    )
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
        t0 = time.perf_counter()
        by_path["E"] = path_e_phase(c, smi)
        log(f"path E phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        by_path["F"] = path_f_phase(c, smi)
        log(f"path F phase: {time.perf_counter() - t0:.1f} s")
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
