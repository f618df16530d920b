"""One forward step of the port's device path, and a dry run of the
sharded paths over a mesh (counterparts of the repo's
``__graft_entry__.py::entry`` and ``dryrun_multichip``).

The step sketches a batch of protein sequences and scores every sketch
against a small target set — the full device compute path of
``kmerseek search`` with dense sketches. It is the one place where all
three kernels run in one call: the masked sketch kernel (queries,
``sorted_window_hashes``), and the window-hash and bitonic row-sort
kernels (targets, ``sketch_batch``).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.intersect import pairwise_stats
from .ops.sketch import sketch_batch, sorted_window_hashes
from .utils.device import resolve_device

K, SCALED, MOLTYPE, CAP = 16, 5, "hp", 128


def _toy_batch(n_rows: int, L: int = 256, seed: int = 0):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    seqs = letters[rng.integers(0, 20, size=(n_rows, L))]
    lens = np.full(n_rows, L, np.int32)
    return seqs, lens


def forward(seqs, lengths, t_keys, t_ab, t_counts):
    """Queries → scatter-free sentinel-sort sketch (duplicate slots
    masked to the -1 sentinel) → all-pairs intersection against the
    targets. Returns ``(intersect, weighted)``, each (Q, T) int32."""
    s_keys, first, n_kept = sorted_window_hashes(
        seqs, lengths, k=K, scaled=SCALED, moltype=MOLTYPE, capacity=CAP
    )
    stats = pairwise_stats(
        torch.where(first, s_keys, torch.full_like(s_keys, -1)),
        torch.clamp(n_kept, max=CAP),
        t_keys,
        t_ab,
        t_counts,
    )
    return stats.intersect, stats.weighted


def entry(device=None):
    """``(forward, example_args)`` on ``device`` (default: the CUDA
    device; without one this raises unless ``device="cpu"``). The
    example targets are sketched by ``sketch_batch`` on that device."""
    dev = resolve_device(device)
    seqs, lens = _toy_batch(8)
    t_seqs, t_lens = _toy_batch(4, seed=1)
    tb = sketch_batch(
        torch.from_numpy(t_seqs).to(dev),
        torch.from_numpy(t_lens).to(dev),
        k=K, scaled=SCALED, moltype=MOLTYPE, capacity=CAP,
    )
    example_args = (
        torch.from_numpy(seqs).to(dev),
        torch.from_numpy(lens).to(dev),
        tb.mins,
        tb.abund,
        tb.counts,
    )
    return forward, example_args


def dryrun_multichip(n_shards: int, device=None) -> str:
    """Run ONE full sharded pipeline step, the sharded dense inverted
    search, the sharded sparse search and the 120,000-target stage
    (``_dryrun_sparse_scale``) over an ``n_shards`` mesh
    (``parallel.dist.make_mesh(n_shards, device)``: round-robin over the
    visible cards, or CPU shards with ``device="cpu"``), and check them:
    the step's block shape, the self-search diagonal (every sketch
    against itself gives its size), and the sparse hit list densified
    equal to the dense counts. Returns (and prints) the summary line;
    a failed check raises."""
    from .ops.inverted import build_inverted_np
    from .parallel.dist import (
        make_dist_pipeline_step,
        make_mesh,
        shard_targets,
        sharded_inverted_search,
        sharded_sparse_search,
    )

    mesh = make_mesh(n_shards, device)
    dev0 = mesh.devices[0]
    B, L = n_shards * 2, 256
    seqs, lens = _toy_batch(B, L)

    # tiny target set, rows padded and sharded over the mesh
    t_seqs, t_lens = _toy_batch(n_shards * 2, seed=1)
    tb = sketch_batch(
        torch.from_numpy(t_seqs).to(dev0),
        torch.from_numpy(t_lens).to(dev0),
        k=K, scaled=SCALED, moltype=MOLTYPE, capacity=CAP,
    )
    step = make_dist_pipeline_step(mesh, k=K, scaled=SCALED, moltype=MOLTYPE, capacity=CAP)
    out = step(seqs, lens, *shard_targets(mesh, tb.mins, tb.abund, tb.counts))
    assert out.intersect.shape == out.weighted.shape == (B, n_shards * 2), out.intersect.shape
    total = int(out.total_retained)
    assert total >= 0

    # hash-range-sharded inverted search: postings sharded by position
    # (= hash range), queries copied to every shard, partial matrices summed
    counts = tb.counts.cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    mask = np.arange(tb.mins.shape[1])[None, :] < counts[:, None]
    inv = build_inverted_np(
        tb.mins.cpu().numpy().view(np.uint64)[mask],
        tb.abund.cpu().numpy()[mask].astype(np.int64),
        offsets,
    )
    q_valid = torch.from_numpy(mask).to(dev0)
    c, _w = sharded_inverted_search(mesh, inv, tb.mins, q_valid)
    c = c.cpu().numpy()
    # self-search: the diagonal must equal each sketch's size
    assert (np.diag(c) == counts).all(), (np.diag(c), counts)

    # hash-range-sharded sparse hit lists: the additively merged
    # per-shard lists must densify to the same matrix
    hits = sharded_sparse_search(mesh, inv, tb.mins, q_valid)
    ns = np.zeros_like(c)
    ns[hits.q, hits.t] = hits.count
    assert np.array_equal(ns, c), "sharded sparse != dense"

    scale = _dryrun_sparse_scale(mesh)
    line = (
        f"dryrun_multichip ok: mesh={n_shards} shards on "
        f"{sorted({str(d) for d in mesh.devices})}, stats block {tuple(out.intersect.shape)}, "
        f"total retained hashes {total}, sharded inverted self-search diagonal verified, "
        f"sharded sparse hit list verified{scale}"
    )
    print(line)
    return line


def _dryrun_sparse_scale(mesh) -> str:
    """The dry run's non-toy stage (counterpart of
    ``__graft_entry__._dryrun_sparse_scale``, same seed and sizes):
    120,000 synthetic targets of 24 hashes drawn from a 2^20 pool at
    hp/k16/scaled5, and 64 queries whose even slots come from the pool.

    (a) the hash-range-sharded sparse engine equals the dense engine
    (``inverted_pair_stats_packed`` on one device) in counts and weights,
    and with ``capacity=256`` keeps the true ``n_hits`` and the exact
    merged prefix; (b) a 4-process ``manysearch_columns_from_payloads``
    merge equals single-process ``manysearch_columns``, and no shard
    holds 1.3x the mean of the postings. Returns the summary suffix."""
    from .core.index import IndexConfig, ProteomeIndex
    from .core.search import manysearch_columns
    from .ops.inverted import build_inverted_np, inverted_pair_stats_packed
    from .ops.u64 import u64_np_to_tensor
    from .parallel.dist import sharded_sparse_search
    from .parallel.multihost import shard_of_hash
    from .parallel.sharded import (
        ShardedProteomeIndex,
        build_local_inverted,
        local_manysearch_payload,
        manysearch_columns_from_payloads,
        occupied_span,
    )

    dev0 = mesh.devices[0]
    T, S, Q = 120_000, 24, 64
    cfg = IndexConfig(16, 5, "hp")
    span = occupied_span(cfg.scaled)
    rng = np.random.default_rng(3)
    pool = np.unique(rng.integers(0, span, size=1 << 20, dtype=np.uint64))
    vals = np.sort(pool[rng.integers(0, len(pool), size=(T, S))], axis=1)
    keep = np.ones_like(vals, bool)
    keep[:, 1:] = vals[:, 1:] != vals[:, :-1]
    t_counts = keep.sum(axis=1).astype(np.int64)
    mins = vals[keep]
    offsets = np.concatenate([[0], np.cumsum(t_counts)]).astype(np.int64)
    ab = rng.integers(1, 9, size=len(mins)).astype(np.int64)
    q64 = np.where(
        np.arange(S)[None, :] % 2 == 0,
        pool[rng.integers(0, len(pool), size=(Q, S))],
        rng.integers(0, span, size=(Q, S), dtype=np.uint64),
    )
    q64 = np.sort(q64, axis=1)
    qv = np.ones((Q, S), bool)
    qv[:, 1:] = q64[:, 1:] != q64[:, :-1]
    q_keys = u64_np_to_tensor(q64, dev0)
    q_valid = torch.from_numpy(qv).to(dev0)

    # (a) the sharded sparse engine against the dense one, at scale
    inv = build_inverted_np(mins, ab, offsets)
    c, w = inverted_pair_stats_packed(
        torch.from_numpy(inv.packed().view(np.int32)).to(dev0),
        torch.from_numpy(inv.bucket_starts.astype(np.int64)).to(dev0),
        q_keys, q_valid, n_targets=T, max_run=inv.max_run,
        span_steps=max(int(inv.max_span).bit_length(), 1), bucket_shift=inv.bucket_shift,
    )
    c, w = c.cpu().numpy(), w.cpu().numpy()
    hits = sharded_sparse_search(mesh, inv, q_keys, q_valid)
    dense_c = np.zeros_like(c)
    dense_w = np.zeros(w.shape, np.int64)
    dense_c[hits.q, hits.t] = hits.count
    dense_w[hits.q, hits.t] = hits.weight
    assert np.array_equal(dense_c, c), "sharded sparse counts != dense @scale"
    assert np.array_equal(dense_w, w.astype(np.int64)), "sharded sparse weights != dense @scale"
    assert hits.n_hits == int((c > 0).sum())
    # a forced overflow: the true n_hits survives the merge, and the list
    # is the exact merged prefix
    small = 256
    assert hits.n_hits > small
    trimmed = sharded_sparse_search(mesh, inv, q_keys, q_valid, capacity=small)
    assert trimmed.n_hits == hits.n_hits, "true n_hits lost in overflow"
    assert len(trimmed.q) == small
    for f in ("q", "t", "count"):
        assert np.array_equal(getattr(trimmed, f), getattr(hits, f)[:small]), f"trimmed {f}"

    # (b) the process-level sharded manysearch merge, at scale
    target = ProteomeIndex(cfg, [f"t{i}" for i in range(T)], mins, ab, offsets, device=dev0)
    q_offsets = np.concatenate([[0], np.cumsum(qv.sum(axis=1))]).astype(np.int64)
    query = ProteomeIndex(
        cfg, [f"q{i}" for i in range(Q)], q64[qv], np.ones(int(qv.sum()), np.int64), q_offsets,
        device=dev0,
    )
    P = 4
    dest = shard_of_hash(mins, P, span)
    tid_all = np.repeat(np.arange(T, dtype=np.int64), np.diff(offsets))
    md5s = list(target.md5_array)
    shards = []
    for d in range(P):
        m = dest == d
        local = build_local_inverted([{"mins": mins[m], "tid": tid_all[m], "ab": ab[m]}], T)
        shards.append(
            ShardedProteomeIndex(
                cfg, target.names, target.t_sizes, target.t_weight, md5s, local, d, P, device=dev0
            )
        )
    expected = manysearch_columns(query, target)
    payloads = [local_manysearch_payload(query, sh) for sh in shards]
    got = manysearch_columns_from_payloads(query, shards[0], payloads)
    assert len(expected["query_name"]) == hits.n_hits
    for k, e in expected.items():
        g = got[k]
        if isinstance(e, np.ndarray):
            assert np.array_equal(np.asarray(g), e), f"sharded many.{k}"
        else:
            assert g == e, f"sharded many.{k}"
    local_counts = [sh.n_local_postings for sh in shards]
    assert sum(local_counts) == len(mins)
    assert max(local_counts) < 1.3 * len(mins) / P
    return (
        f"; scale run ok: {T} targets / {len(mins)} postings, "
        f"{hits.n_hits} hit pairs bit-equal (sharded sparse + overflow "
        f"retry + {P}-process merge, shard residency {local_counts})"
    )
