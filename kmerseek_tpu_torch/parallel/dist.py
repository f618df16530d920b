"""One process, several devices: data-parallel sketching and sharded
search over a mesh (counterpart of ``kmerseek_tpu/parallel/dist.py``).

* **Sketch — data parallel**: the batch axis of the sequence rows is
  split over the mesh; every shard runs the sketch stage on its rows.
* **Target sharding**: the target axis (T) of the padded ``(T, S)``
  sketch arrays is split over the mesh; each shard's device holds its
  rows.
* **Search — broadcast + concat**: the query sketches are gathered onto
  every shard's device (they are small), every shard intersects them
  with its local target rows, and the ``(Q, T/D)`` blocks concatenate —
  each target lives on exactly one shard, so nothing is reduced.
* **Posting sharding**: the globally sorted posting array is cut into
  contiguous position slices (= hash ranges), one per shard; the dense
  engine's per-shard ``(Q, T)`` matrices add up, the sparse engine's
  per-shard hit lists merge additively.

``shard_map`` over a ``jax.sharding.Mesh`` has no PyTorch twin. The
idiom here is one process that places each shard's tensors on an
explicit device: a ``Mesh`` is a tuple of ``torch.device``, one per
shard, and a shard's step is the plain function called on that device's
tensors. Plain tensor adds, copies and ``torch.cat`` stand for ``psum``
and ``all_gather``, which the JAX package computes outside any kernel
too. Several shards may share one device (``make_mesh(4)`` on one card,
``make_mesh(8, device="cpu")`` in the tests): such logical shards check
the layout, not the scaling.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.inverted import DevicePostings
from ..ops.u64 import join_np, sort_key, u64_np_to_tensor
from ..utils.device import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """The devices of a 1-D mesh, one per shard, in shard order."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` shards.

    By default one shard per visible CUDA device; a larger ``n_devices``
    places the shards round-robin over the cards. ``device="cpu"`` gives
    ``n_devices`` CPU shards, and a device with an index (``"cuda:1"``)
    puts every shard there. Without a CUDA device and without
    ``device="cpu"`` this raises."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return Mesh((dev,) * int(n_devices or 1))
    cards = torch.cuda.device_count()
    n = int(n_devices or cards)
    return Mesh(tuple(torch.device("cuda", i % cards) for i in range(n)))


def pad_to_multiple(arr: np.ndarray, mult: int, axis: int = 0, fill=0) -> np.ndarray:
    pad = (-arr.shape[axis]) % mult
    if not pad:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _split_rows(mesh: Mesh, arr: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """Equal row blocks of ``arr``, block i on ``mesh.devices[i]``."""
    rows = arr.shape[0] // mesh.size
    return tuple(
        torch.from_numpy(np.ascontiguousarray(arr[i * rows : (i + 1) * rows])).to(dev)
        for i, dev in enumerate(mesh.devices)
    )


def shard_targets(mesh: Mesh, t_keys, t_ab, t_counts):
    """Place padded target arrays with the T axis sharded over the mesh.

    Rows are padded to a multiple of the mesh size with empty sketches
    (count 0, all-ones keys: the u64::MAX sentinel), which can never
    match a query. Returns ``(keys, ab, counts)``, each a tuple with one
    tensor per shard on that shard's device. (The JAX signature takes
    the keys as a (hi, lo) pair.)"""
    n = mesh.size
    keys = pad_to_multiple(_host(t_keys), n, fill=-1)
    ab = pad_to_multiple(_host(t_ab), n, fill=0)
    counts = pad_to_multiple(_host(t_counts), n, fill=0)
    return _split_rows(mesh, keys), _split_rows(mesh, ab), _split_rows(mesh, counts)


def sharded_pairwise_stats(mesh: Mesh, q_keys, q_counts, t_keys, t_ab, t_counts):
    """(Q, T) pair stats with T sharded (``shard_targets``' tuples);
    the queries are copied to every shard's device.

    Each shard scores the queries against its rows; the blocks are
    concatenated over T on ``mesh.devices[0]`` (they are Q×T int32 —
    small next to the index itself)."""
    from ..ops.intersect import PairStats, pairwise_stats

    parts = []
    for i, dev in enumerate(mesh.devices):
        parts.append(
            pairwise_stats(
                q_keys.to(dev), q_counts.to(dev), t_keys[i], t_ab[i], t_counts[i]
            )
        )
    dev0 = mesh.devices[0]
    return PairStats(
        torch.cat([p.intersect.to(dev0) for p in parts], dim=1),
        torch.cat([p.weighted.to(dev0) for p in parts], dim=1),
    )


class DistPipelineOut(NamedTuple):
    intersect: torch.Tensor  # (B_global, T_padded) int32, on mesh.devices[0]
    weighted: torch.Tensor
    total_retained: torch.Tensor  # () int64 — summed over shards


def make_dist_pipeline_step(
    mesh: Mesh, *, k: int, scaled: int, moltype: str, capacity: int
):
    """The full device step, sharded: sketch (data parallel) → gather
    the query sketches onto every shard → intersect with the local
    target shard.

    Returns a function of
      (seqs (B, L) uint8 and lengths (B,), numpy or tensors, B a
       multiple of the mesh size: split over the shards here;
       t_keys / t_ab / t_counts: ``shard_targets``' tuples)
    that gives a ``DistPipelineOut``. On CUDA shards the sketch stage
    launches the masked sketch kernel, on CPU shards its plain version.
    """
    from ..ops.intersect import pairwise_stats
    from ..ops.sketch import sorted_window_hashes

    def step(seqs, lengths, t_keys, t_ab, t_counts) -> DistPipelineOut:
        seqs, lengths = _host(seqs), _host(lengths)
        if seqs.shape[0] % mesh.size:
            raise ValueError(
                f"{seqs.shape[0]} sequence rows do not split over {mesh.size} shards"
            )
        q_parts, n_parts, firsts = [], [], []
        for s, n in zip(_split_rows(mesh, seqs), _split_rows(mesh, lengths)):
            # data-parallel sketch of this shard's rows
            s_keys, first, n_kept = sorted_window_hashes(
                s, n, k=k, scaled=scaled, moltype=moltype, capacity=capacity
            )
            # duplicate slots → the sentinel, so the intersection counts
            # each distinct query hash exactly once
            q_parts.append(torch.where(first, s_keys, torch.full_like(s_keys, -1)))
            n_parts.append(torch.clamp(n_kept, max=capacity))
            firsts.append(first.sum())
        dev0 = mesh.devices[0]
        inter, weighted = [], []
        for i, dev in enumerate(mesh.devices):
            # all-gather: every shard's device gets every query sketch
            g_keys = torch.cat([q.to(dev) for q in q_parts])
            g_n = torch.cat([n.to(dev) for n in n_parts])
            stats = pairwise_stats(g_keys, g_n, t_keys[i], t_ab[i], t_counts[i])
            inter.append(stats.intersect.to(dev0))
            weighted.append(stats.weighted.to(dev0))
        total = torch.stack([f.to(dev0) for f in firsts]).sum()
        return DistPipelineOut(torch.cat(inter, dim=1), torch.cat(weighted, dim=1), total)

    return step


# (index, mesh) → (position slices of the postings, one DevicePostings
# per shard on that shard's device; slice length). The pattern is many
# query blocks against one loaded index, so the slices are uploaded
# once. They are copies of their own, never views of
# ``ops.inverted.device_postings``' upload: that cache holds two whole
# indexes a device and may drop one at any search, and four slices of
# one index on one card must neither evict each other there nor alias.
# Entries hold strong references to the host array and the mesh, so the
# ids stay valid; ``clear_sharded_sparse_cache`` and
# ``ops.inverted.clear_device_postings`` release them. The cache is per
# (index, mesh): reuse ONE Mesh object across calls.
_SHARDED_SPARSE_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_SHARDED_SPARSE_SLOTS = 2


def clear_sharded_sparse_cache(inv=None) -> None:
    """Release cached sharded posting uploads: with ``inv`` given only
    that index's entries (any mesh), with no argument all of them.
    ``ops.inverted.clear_device_postings`` calls this too."""
    if inv is None:
        _SHARDED_SPARSE_CACHE.clear()
        return
    for key in [k for k, v in _SHARDED_SPARSE_CACHE.items() if v[0] is inv.g_hi]:
        _SHARDED_SPARSE_CACHE.pop(key, None)


def _sharded_sparse_program(mesh: Mesh, inv):
    """→ ``(slices, local_n)``: shard c holds postings
    ``[c * local_n, (c + 1) * local_n)`` of the sorted array (the last
    slices may be shorter or empty), uploaded to ``mesh.devices[c]``."""
    key = (id(inv.g_hi), id(mesh))
    ent = _SHARDED_SPARSE_CACHE.get(key)
    if ent is not None and ent[0] is inv.g_hi and ent[1] is mesh:
        _SHARDED_SPARSE_CACHE.move_to_end(key)
        return ent[2]
    n, N = mesh.size, inv.n_postings
    local_n = -(-N // n)
    slices = []
    for c, dev in enumerate(mesh.devices):
        a, b = min(c * local_n, N), min((c + 1) * local_n, N)
        # the hashes are joined into a fresh array and the int32 members
        # widen to int64: read-only mmap'd members are copied here
        g = u64_np_to_tensor(join_np(inv.g_hi[a:b], inv.g_lo[a:b]), dev)
        slices.append(
            DevicePostings(
                sort_key(g),
                torch.from_numpy(np.asarray(inv.tid[a:b], np.int64)).to(dev),
                torch.from_numpy(np.asarray(inv.ab[a:b], np.int64)).to(dev),
                None,
            )
        )
    entry = (tuple(slices), local_n)
    _SHARDED_SPARSE_CACHE[key] = (inv.g_hi, mesh, entry)
    while len(_SHARDED_SPARSE_CACHE) > _SHARDED_SPARSE_SLOTS:
        _SHARDED_SPARSE_CACHE.popitem(last=False)
    return entry


def _local_bounds(inv, local_n: int) -> Tuple[int, int]:
    """(max_run, span_steps) of a slice of ``local_n`` postings: a run
    inside a slice is no longer than the slice, and the full-range
    bisect must cover log2 of its length."""
    return min(int(inv.max_run), local_n) or 1, max(int(local_n).bit_length(), 1)


def sharded_inverted_search(mesh: Mesh, inv, q_keys: torch.Tensor, q_valid: torch.Tensor):
    """Hash-range-sharded dense inverted search.

    The globally sorted posting array is cut into equal contiguous
    slices (= hash ranges; murmur's uniformity balances them), one per
    shard. The queries are copied to every shard's device; every shard
    runs the dense engine (``ops.inverted.inverted_pair_stats`` in its
    full-range mode) against its slice, and the per-shard ``(Q, T)``
    count and weight matrices are summed on ``mesh.devices[0]``. A
    target's postings may span shards, but each posting lives on exactly
    one, so the sum is exact: a run that straddles a slice boundary is
    found in part by each neighbour's local bounds.

    The weights are summed in int64 over the shards' int32 partials and
    cast once: the 32 bits of the unsharded engine, and of the JAX
    engine's wrapping int32 ``psum``."""
    from ..ops.inverted import inverted_pair_stats

    dev0 = mesh.devices[0]
    Q, T = q_keys.shape[0], int(inv.n_targets)
    counts = torch.zeros((Q, T), dtype=torch.int32, device=dev0)
    weights = torch.zeros((Q, T), dtype=torch.int64, device=dev0)
    if inv.n_postings == 0:
        return counts, weights.to(torch.int32)
    slices, local_n = _sharded_sparse_program(mesh, inv)
    max_run, span_steps = _local_bounds(inv, local_n)
    for dp, dev in zip(slices, mesh.devices):
        if dp.gk.shape[0] == 0:
            continue
        c, w = inverted_pair_stats(
            dp, q_keys.to(dev), q_valid.to(dev),
            n_targets=T, max_run=max_run, span_steps=span_steps,
        )
        counts += c.to(dev0)
        weights += w.to(dev0)
    return counts, weights.to(torch.int32)


def sharded_sparse_search(
    mesh: Mesh,
    inv,
    q_keys: torch.Tensor,
    q_valid: torch.Tensor,
    capacity: Optional[int] = None,
    run_chunk: Optional[int] = None,
):
    """Hash-range-sharded SPARSE hit-list search: large indexes across
    devices without a dense (Q, T) matrix anywhere.

    The same position slices as ``sharded_inverted_search``; every shard
    gives its own (q, t, count, weight) hit list from its slice
    (``ops.sparse_search.inverted_sparse_hits`` in full-range mode — a
    slice has no bucket table). A (q, t) pair whose shared hashes span
    several hash ranges surfaces on each of those shards, so the
    per-shard lists merge ADDITIVELY on the host
    (``_merge_partial_hits``, the merge of run-offset tiling).

    Long posting runs are probed in windows of ``run_chunk`` (default
    ``_RUN_TILE``) offsets, and the per-(shard, tile) partial lists
    merge the same way. ``capacity`` trims the MERGED list (``n_hits``
    keeps the true pair count). Returns a host ``SparseHits``, t
    ascending per q. (The JAX function's ``expand_e`` is a buffer budget
    of its TPU kernel; its result is this one for any value of it.)"""
    from ..ops.sparse_search import _dp_hits, _empty_hits, _merge_partial_hits, _tile, _wide_weights_needed

    Q, S = q_keys.shape
    if inv.n_postings == 0:
        return _empty_hits()
    slices, local_n = _sharded_sparse_program(mesh, inv)
    max_run, steps = _local_bounds(inv, local_n)
    tile = min(_tile(run_chunk, Q, S), max_run)
    wide = _wide_weights_needed(inv, S)
    q_valid = q_valid.to(torch.bool)
    queries = [(q_keys.to(dev), q_valid.to(dev)) for dev in mesh.devices]
    parts = []
    for off in range(0, max_run, tile):
        for dp, (qk, qv) in zip(slices, queries):
            if dp.gk.shape[0]:
                parts.append(
                    _dp_hits(
                        dp, qk, qv, wide=wide, max_run=tile, n_targets=int(inv.n_targets),
                        span_steps=steps, run_offset=off, true_max_run=max_run,
                    )
                )
    if not parts:
        return _empty_hits()
    return _merge_partial_hits(parts, capacity)


def distributed_manysearch_stats(query_index, target_index, mesh: Optional[Mesh] = None):
    """Sharded version of the manysearch device stage.

    Returns host numpy (intersect, weighted) equal to
    ``core.search._device_pair_stats`` — the target padding columns are
    stripped before returning. The default mesh is ``make_mesh()``: one
    shard per visible CUDA device."""
    mesh = mesh or make_mesh()
    q_keys, _q_ab, q_counts = query_index.dense_device_arrays()
    T = len(target_index)
    t_keys, t_ab, t_counts = shard_targets(mesh, *target_index.dense_device_arrays())
    stats = sharded_pairwise_stats(mesh, q_keys, q_counts, t_keys, t_ab, t_counts)
    return stats.intersect.cpu().numpy()[:, :T], stats.weighted.cpu().numpy()[:, :T]
