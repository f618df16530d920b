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
    search and the sharded sparse search over an ``n_shards`` mesh
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

    line = (
        f"dryrun_multichip ok: mesh={n_shards} shards on "
        f"{sorted({str(d) for d in mesh.devices})}, stats block {tuple(out.intersect.shape)}, "
        f"total retained hashes {total}, sharded inverted self-search diagonal verified, "
        f"sharded sparse hit list verified"
    )
    print(line)
    return line
