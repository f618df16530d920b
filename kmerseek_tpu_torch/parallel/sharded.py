"""Hash-range-sharded index across processes — each process holds N/P
(counterpart of ``kmerseek_tpu/parallel/sharded.py``; nearly all numpy
on the host, as there).

``parallel.multihost.build_distributed_index`` gives every process a
full replica (cheap searches, O(corpus) memory per process); this module
is the layout that removes that ceiling:

* **Build**: each process sketches its round-robin record shard
  (``sketch_local_shard`` — data-parallel ingest, on its device), then
  postings are exchanged BY HASH RANGE: process p keeps only postings
  whose hash falls in ``hash_range_for_shard(p, P, span)``. Resident
  index memory per process is ~N/P postings plus O(T) global metadata
  (names, sketch sizes, abundance totals, md5s). The exchange runs as P
  rounds of range-restricted all-gathers, so the transient buffer is
  O(N/P) too.
* **Search**: queries are replicated. Every process joins the query
  block against its LOCAL posting slice (``core.search._join_tuples`` —
  the join of the single-process engine, cross-checked per shard by the
  sparse device engine on the shard's device), and the per-shard
  co-occurrence tuples are all-gathered and merged. Every posting of a
  hash lives on exactly ONE shard, so the union of the per-shard tuple
  lists IS the global tuple list and the merge is a sort: the
  manysearch and multisearch columns equal the single-process engine's
  bit for bit (``tests/test_torch_multihost_real.py`` under a real
  2-process group). Communication is result-sized, never index-sized.

A ``shard_<p>_of_<P>/`` directory is interchangeable with the JAX
package's: same member names, dtypes and manifest keys.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from .multihost import (
    _allgather_payloads,
    _name_blob,
    hash_range_for_shard,
    initialize_distributed,
    rank_device,
    shard_of_hash,
    sketch_local_shard,
)


def occupied_span(scaled: int) -> int:
    """Extent of the occupied hash space: the FracMinHash filter keeps
    only hashes <= max_hash(scaled), so ranges must split [0, max_hash]
    — splitting the raw u64 line would leave every shard above
    2^64/scaled empty."""
    from ..ops.encoding import max_hash_for_scaled

    return max_hash_for_scaled(scaled) + 1


# ----------------------------------------------------------------------
# pure exchange functions (testable by simulating several processes'
# payloads, like multihost.pack_local_shard/merge_shards)
# ----------------------------------------------------------------------


def pack_target_meta(ordinals: List[int], signatures) -> dict:
    """One process's per-record GLOBAL metadata (small; replicated on
    every process after the exchange): ordinal, name, md5, sketch size,
    total abundance. md5s are computed here, where the mins still live —
    after the hash-range exchange no single process holds a whole
    signature to hash."""
    names, name_off = _name_blob(signatures)
    md5_blob = "".join(s.md5sum for s in signatures).encode("ascii")
    return {
        "ordinals": np.asarray(ordinals, np.int64),
        "names": names,
        "name_offsets": name_off,
        "md5s": np.frombuffer(md5_blob, np.uint8).copy(),
        "sizes": np.asarray([len(s.mins) for s in signatures], np.int64),
        "weights": np.asarray(
            [int(s.abundances.sum()) for s in signatures], np.int64
        ),
    }


def merge_target_meta(payloads: List[dict]):
    """→ (names, sizes, weights, md5s) in global record order."""
    entries = []
    for p in payloads:
        blob = p["names"].tobytes()
        m5 = p["md5s"].tobytes().decode("ascii")
        no = p["name_offsets"]
        for i, o in enumerate(p["ordinals"].tolist()):
            entries.append(
                (
                    o,
                    blob[no[i] : no[i + 1]].decode("utf-8"),
                    int(p["sizes"][i]),
                    int(p["weights"][i]),
                    m5[32 * i : 32 * (i + 1)],
                )
            )
    entries.sort(key=lambda e: e[0])
    if [e[0] for e in entries] != list(range(len(entries))):
        raise RuntimeError(
            "sharded build: record ordinals are not a dense 0..N-1 range "
            "— a host shard is missing or duplicated"
        )
    return (
        [e[1] for e in entries],
        np.asarray([e[2] for e in entries], np.int64),
        np.asarray([e[3] for e in entries], np.int64),
        [e[4] for e in entries],
    )


def pack_range_postings(
    ordinals: List[int], signatures, dest: int, n_shards: int, span: int
) -> dict:
    """THIS process's postings whose hash falls in shard ``dest``'s
    range — one round of the P-round posting exchange."""
    if signatures:
        mins = np.concatenate([s.mins for s in signatures])
        ab = np.concatenate([s.abundances for s in signatures]).astype(np.int64)
        tid = np.repeat(
            np.asarray(ordinals, np.int64),
            [len(s.mins) for s in signatures],
        )
    else:
        mins = np.zeros(0, np.uint64)
        ab = np.zeros(0, np.int64)
        tid = np.zeros(0, np.int64)
    keep = shard_of_hash(mins, n_shards, span) == dest
    return {"mins": mins[keep], "tid": tid[keep], "ab": ab[keep]}


def build_local_inverted(payloads: List[dict], n_targets: int):
    """Merge every process's range-d payload into shard d's local
    ``InvertedIndex``.

    The posting order equals the global single-process build restricted
    to the range: that build stable-sorts the tid-ascending
    concatenation by hash, i.e. hash-ascending with tid-ascending ties —
    and (hash, tid) pairs are unique, so a (hash, tid) lexsort gives
    that order whatever order the payloads arrive in. The sort key is
    uint64, so the order is unsigned."""
    from ..ops.inverted import InvertedIndex, longest_run
    from ..ops.u64 import split_np

    mins = np.concatenate([np.asarray(p["mins"], np.uint64) for p in payloads])
    tid = np.concatenate([p["tid"] for p in payloads])
    ab = np.concatenate([p["ab"] for p in payloads])
    order = np.lexsort((tid, mins))
    g = mins[order]
    tid = tid[order].astype(np.int32)
    ab = ab[order].astype(np.int32)
    g_hi, g_lo = split_np(g)
    return InvertedIndex(g_hi, g_lo, tid, ab, n_targets, longest_run(g)).with_buckets()


# ----------------------------------------------------------------------
# the sharded index object + build entry point
# ----------------------------------------------------------------------


class ShardedProteomeIndex:
    """Per-process view of a hash-range-sharded proteome index.

    Holds the GLOBAL target metadata (names, sketch sizes, abundance
    totals, md5s — O(T), replicated) and the LOCAL posting slice (an
    ``InvertedIndex`` whose hashes fall in this process's range, with
    GLOBAL target ids). Implements the metadata surface the column
    assembly reads (``__len__``, ``names_array``, ``md5_array``,
    ``name_ranks``), so ``core.search._assemble_manysearch_columns``
    works unchanged. ``device`` is where the local join's device
    cross-check runs (default: the CUDA device)."""

    def __init__(
        self,
        config,
        names: List[str],
        t_sizes: np.ndarray,
        t_weight: np.ndarray,
        md5s: List[str],
        local,
        shard: int,
        n_shards: int,
        source_fasta: str = "",
        device=None,
    ):
        from ..utils.device import resolve_device

        self.config = config
        self.names = list(names)
        self.t_sizes = np.asarray(t_sizes, np.int64)
        self.t_weight = np.asarray(t_weight, np.int64)
        self.md5s = list(md5s)
        self.local = local  # InvertedIndex over this shard's hash range
        self.shard = int(shard)
        self.n_shards = int(n_shards)
        self.source_fasta = source_fasta
        self.device = resolve_device(device)
        self._names_array = None
        self._md5_array = None
        self._name_ranks = None

    def __len__(self) -> int:
        return len(self.names)

    def save(self, path: str) -> str:
        """Persist this process's shard (see ``save_sharded_index``)."""
        return save_sharded_index(self, path)

    @staticmethod
    def load(
        path: str,
        shard: Optional[int] = None,
        n_shards: Optional[int] = None,
        device=None,
    ) -> "ShardedProteomeIndex":
        """Load this process's shard (see ``load_sharded_index``)."""
        return load_sharded_index(path, shard, n_shards, device=device)

    @property
    def hash_range(self) -> Tuple[int, int]:
        return hash_range_for_shard(
            self.shard, self.n_shards, occupied_span(self.config.scaled)
        )

    @property
    def n_local_postings(self) -> int:
        return self.local.n_postings

    @property
    def names_array(self) -> np.ndarray:
        if self._names_array is None:
            self._names_array = np.array(self.names, object)
        return self._names_array

    @property
    def md5_array(self) -> np.ndarray:
        if self._md5_array is None:
            self._md5_array = np.array(self.md5s, object)
        return self._md5_array

    @property
    def name_ranks(self) -> np.ndarray:
        """Dense lexicographic name ranks (same contract as
        ``ProteomeIndex.name_ranks`` — see there)."""
        if self._name_ranks is None:
            from ..core.index import dense_name_ranks

            self._name_ranks = dense_name_ranks(self.names)
        return self._name_ranks


SHARDED_FORMAT_VERSION = 1


def _shard_dir(path: str, shard: int, n_shards: int) -> str:
    return os.path.join(path, f"shard_{shard}_of_{n_shards}")


def save_sharded_index(sharded: ShardedProteomeIndex, path: str) -> str:
    """Persist THIS process's shard of a hash-range-sharded index.

    Each process writes a self-contained ``shard_<p>_of_<P>/`` directory
    under ``path``: its local posting slice + bucket table as raw
    ``.npy`` members (mmap'd on load — the format-2 design of the
    single-process ``.ksx``, ``core/index.py``) plus the replicated O(T)
    global metadata. A loading process touches only its own directory.
    Each member goes to a temp file and is renamed into place, and the
    manifest lands last the same way, so a crashed half-save is never
    loadable."""
    from ..core.index import write_npy_member

    d = _shard_dir(path, sharded.shard, sharded.n_shards)
    os.makedirs(d, exist_ok=True)
    inv = sharded.local.with_buckets()
    members = {
        "g_hi": inv.g_hi,
        "g_lo": inv.g_lo,
        "tid": inv.tid,
        "ab": inv.ab,
        "bucket_starts": inv.bucket_starts,
        "t_sizes": sharded.t_sizes,
        "t_weight": sharded.t_weight,
    }
    manifest = {
        "format_version": SHARDED_FORMAT_VERSION,
        "shard": sharded.shard,
        "n_shards": sharded.n_shards,
        "ksize": sharded.config.ksize,
        "scaled": sharded.config.scaled,
        "moltype": sharded.config.moltype,
        "source_fasta": sharded.source_fasta,
        "names": sharded.names,
        "md5s": sharded.md5s,
        "inverted_shape": [
            int(inv.n_targets),
            int(inv.max_run),
            int(inv.max_span),
            int(inv.bucket_shift),
        ],
        "files": {},
        "sums": {
            "g64": int(inv.g64().sum(dtype=np.uint64)),
            "ab": int(inv.ab.sum(dtype=np.int64)),
        },
    }
    manifest["files"] = dict(write_npy_member(d, name, arr) for name, arr in members.items())
    mtmp = os.path.join(d, "manifest.json.tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(d, "manifest.json"))
    return d


def load_sharded_index(
    path: str,
    shard: Optional[int] = None,
    n_shards: Optional[int] = None,
    device=None,
) -> ShardedProteomeIndex:
    """Load THIS process's shard — no sketching, no exchange.

    ``shard``/``n_shards`` default to the live process group
    (``initialize_distributed``), so a fresh group restarts with one
    call per process; ``device`` defaults to the rank's device
    (``rank_device``). Posting members are mmap'd read-only (O(1) open;
    they are copied where they are uploaded, not here), and the loaded
    shard equals the built one bit for bit. Member sizes and lengths are
    always checked against the manifest; content checksums with
    ``KMERSEEK_LOAD_VERIFY=full``."""
    from ..core.index import IndexConfig, load_npy_members
    from ..ops.inverted import InvertedIndex

    if shard is None or n_shards is None:
        shard, n_shards = initialize_distributed()
    d = _shard_dir(path, shard, n_shards)
    mpath = os.path.join(d, "manifest.json")
    if not os.path.exists(mpath):
        from ..utils.errors import NoSavedState

        raise NoSavedState(
            f"no saved shard {shard}/{n_shards} at {path} "
            f"(expected {d}/manifest.json)"
        )
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest["format_version"] > SHARDED_FORMAT_VERSION:
        raise ValueError(
            f"sharded index format {manifest['format_version']} too new"
        )
    if (manifest["shard"], manifest["n_shards"]) != (shard, n_shards):
        raise ValueError(
            f"shard directory {d} holds shard "
            f"{manifest['shard']}/{manifest['n_shards']}, "
            f"process expected {shard}/{n_shards}"
        )
    arrs = load_npy_members(d, manifest["files"], "shard")
    shape = manifest["inverted_shape"]
    inv = InvertedIndex(
        arrs["g_hi"],
        arrs["g_lo"],
        arrs["tid"],
        arrs["ab"],
        shape[0],
        shape[1],
        bucket_starts=arrs["bucket_starts"],
        max_span=shape[2],
        bucket_shift=shape[3],
    )
    if os.environ.get("KMERSEEK_LOAD_VERIFY") == "full":
        sums = manifest.get("sums", {})
        if (
            int(inv.g64().sum(dtype=np.uint64)) != sums.get("g64")
            or int(inv.ab.sum(dtype=np.int64)) != sums.get("ab")
        ):
            raise ValueError(f"corrupt shard: content checksum mismatch at {d}")
    return ShardedProteomeIndex(
        IndexConfig(manifest["ksize"], manifest["scaled"], manifest["moltype"]),
        manifest["names"],
        arrs["t_sizes"],
        arrs["t_weight"],
        manifest["md5s"],
        inv,
        shard,
        n_shards,
        source_fasta=manifest.get("source_fasta", ""),
        device=rank_device(device, shard),
    )


def build_sharded_index(
    fasta: str,
    config=None,
    *,
    batch_size: int = 1000,
    ambiguity_policy: str = "first",
    device=None,
) -> ShardedProteomeIndex:
    """Multi-process hash-range-sharded index build — the scale-out
    entry point (resident index per process ≈ N/P postings).

    Round-robin data-parallel sketch ingest on the rank's device, one
    small metadata all-gather, then P rounds of range-restricted posting
    all-gathers (round d moves only shard d's range; only process d
    keeps it, so transient buffers stay O(N/P)). On one process this is
    a full local index with no communication."""
    from ..core.index import IndexConfig

    config = config or IndexConfig()
    rank, world = initialize_distributed()
    dev = rank_device(device, rank)
    ordinals, signatures = sketch_local_shard(
        fasta, config, rank, world,
        batch_size=batch_size, ambiguity_policy=ambiguity_policy, device=dev,
    )
    names, sizes, weights, md5s = merge_target_meta(
        _allgather_payloads(pack_target_meta(ordinals, signatures))
    )
    span = occupied_span(config.scaled)
    local = None
    for d in range(world):
        payloads = _allgather_payloads(
            pack_range_postings(ordinals, signatures, d, world, span)
        )
        if d == rank:
            local = build_local_inverted(payloads, len(names))
    return ShardedProteomeIndex(
        config, names, sizes, weights, md5s, local, rank, world,
        source_fasta=os.path.abspath(fasta), device=dev,
    )


# ----------------------------------------------------------------------
# sharded search: local join per shard, result-sized tuple exchange
# ----------------------------------------------------------------------


class _LocalShardView:
    """Duck-typed target of the device cross-check: ``sparse_search``
    reads ``.inverted``, the check runs on ``.device``, and the
    validation bookkeeping weak-keys on ``.mins`` (any stable per-index
    array works — the local posting hashes are exactly that)."""

    def __init__(self, sharded: ShardedProteomeIndex):
        self.inverted = sharded.local
        self.mins = sharded.local.g_hi
        self.device = sharded.device


def _check_params(query, sharded: ShardedProteomeIndex) -> None:
    qc, tc = query.config, sharded.config
    if (qc.ksize, qc.scaled, qc.moltype) != (tc.ksize, tc.scaled, tc.moltype):
        raise ValueError("query/target sketch parameters differ")


def _local_tuples(query, sharded: ShardedProteomeIndex):
    """This shard's co-occurrence tuples + the local join's device
    cross-check (each process validates its own hash range against the
    sparse device engine, on every call)."""
    from ..core.search import (
        _join_tuples,
        _segments_from_tuples,
        _validate_with_device,
    )

    inv = sharded.local
    if inv.n_postings == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, np.zeros(len(query.mins), np.int64)
    pq, pt, pab, qhash, qpos = _join_tuples(query, inv)
    if len(pq):
        local_js = _segments_from_tuples(
            pq, pt, pab, qhash, query.mins, len(query), len(sharded), "ab", qpos
        )
        weighted = np.add.reduceat(local_js.pab, local_js.starts)
        _validate_with_device(query, _LocalShardView(sharded), local_js, weighted)
    return pq, pt, pab, qhash, qpos


def local_manysearch_payload(query, sharded: ShardedProteomeIndex) -> dict:
    """This shard's contribution to a manysearch: the flat
    co-occurrence tuples of the local join, as an exchangeable dict."""
    _check_params(query, sharded)
    pq, pt, pab, _qhash, _qpos = _local_tuples(query, sharded)
    return {"pq": pq, "pt": pt, "pab": pab}


def manysearch_columns_from_payloads(
    query, sharded: ShardedProteomeIndex, payloads: List[dict],
    threshold: float = 0.0,
):
    """Merge every shard's tuple payload into the 22 manysearch columns
    (pure — testable by simulating several shards' payloads)."""
    from ..core.search import (
        MANYSEARCH_COLUMNS,
        _assemble_manysearch_columns,
        _segments_from_tuples,
    )

    pq = np.concatenate([p["pq"] for p in payloads])
    pt = np.concatenate([p["pt"] for p in payloads])
    pab = np.concatenate([p["pab"] for p in payloads])
    if len(pq) == 0:
        return {c: [] for c in MANYSEARCH_COLUMNS}
    js = _segments_from_tuples(
        pq, pt, pab, np.zeros(len(pq), np.int64),
        query.mins, len(query), len(sharded), "ab",
        np.zeros(0, np.int64),
    )
    return _assemble_manysearch_columns(
        query, sharded, js, threshold, sharded.t_sizes, sharded.t_weight
    )


def sharded_manysearch_columns(
    query, sharded: ShardedProteomeIndex, threshold: float = 0.0
):
    """Process-level hash-range-sharded manysearch.

    Every process joins the (replicated) query block against its local
    posting slice; the per-shard tuples all-gather (result-sized
    traffic) and merge by sort — each co-occurrence lives on exactly one
    shard, so concatenation is exact. Output is the full 22-column
    manysearch contract, equal bit for bit to single-process
    ``manysearch_columns`` on every process."""
    payloads = _allgather_payloads(local_manysearch_payload(query, sharded))
    return manysearch_columns_from_payloads(query, sharded, payloads, threshold)


def local_multisearch_payload(query, sharded: ShardedProteomeIndex) -> dict:
    """This shard's multisearch contribution: co-occurrence tuples plus
    per-tuple database-frequency terms (df, summed hash abundance) —
    shard-local facts, since every posting of a hash lives on exactly
    one shard."""
    from ..core.search import (
        _db_hash_stats,
        _join_tuples,
        _segments_from_tuples,
        _validate_with_device,
    )

    _check_params(query, sharded)
    inv = sharded.local
    if inv.n_postings:
        pq, pt, pab, qhash, qpos = _join_tuples(query, inv)
        st_db = _db_hash_stats(inv)
        dbpos = qpos[qhash]
        df_t = st_db.df[dbpos].astype(np.int64)
        dbab_t = st_db.db_ab[dbpos]
        if len(pq):
            local_js = _segments_from_tuples(
                pq, pt, pab, qhash, query.mins, len(query), len(sharded),
                "hash", qpos,
            )
            weighted = np.add.reduceat(local_js.pab, local_js.starts)
            _validate_with_device(
                query, _LocalShardView(sharded), local_js, weighted
            )
    else:
        z = np.zeros(0, np.int64)
        pq = pt = pab = qhash = df_t = z
        dbab_t = np.zeros(0, np.float64)
    return {
        "pq": pq, "pt": pt, "pab": pab, "qhash": qhash, "df": df_t,
        "dbab": dbab_t,
    }


def multisearch_columns_from_payloads(
    query,
    sharded: ShardedProteomeIndex,
    payloads: List[dict],
    threshold: float = 0.0,
    estimate_prob_overlap: bool = True,
):
    """Merge every shard's multisearch payload into the 16 columns.

    The global normalizer Σ db_ab is the total posting abundance (an
    integer far below 2^53, so f64 summation order cannot change it);
    the per-pair sums run over tuples in ascending-hash order, as the
    single-process ``multisearch_columns`` sums them, so the merged
    scores equal its bit for bit."""
    from ..core.search import MULTISEARCH_COLUMNS, _assemble_multisearch_columns
    from ..core.signature import minhash_ksize

    pq = np.concatenate([p["pq"] for p in payloads])
    pt = np.concatenate([p["pt"] for p in payloads])
    pab = np.concatenate([p["pab"] for p in payloads])
    qhash = np.concatenate([p["qhash"] for p in payloads])
    df_t = np.concatenate([p["df"] for p in payloads])
    dbab_t = np.concatenate([p["dbab"] for p in payloads])

    k3 = minhash_ksize(query.config.ksize)
    n_targets = len(sharded)
    n_comparisons = float(len(query) * n_targets)
    cols_all = (
        MULTISEARCH_COLUMNS if estimate_prob_overlap else MULTISEARCH_COLUMNS[:11]
    )
    if len(pq) == 0:
        return {c: [] for c in cols_all}

    # merge sort into the per-ascending-hash reduction order
    qm = query.mins
    order = np.lexsort((qm[qhash], pt, pq))
    pq, pt, pab, qhash = pq[order], pt[order], pab[order], qhash[order]
    df_t, dbab_t = df_t[order], dbab_t[order]
    total = len(pq)
    new = np.empty(total, bool)
    new[0] = True
    new[1:] = (pq[1:] != pq[:-1]) | (pt[1:] != pt[:-1])
    starts = np.flatnonzero(new)
    seg_n = np.diff(np.append(starts, total))
    seg_id = np.cumsum(new) - 1
    seg_q, seg_t = pq[starts], pt[starts]

    # Σ db_ab over the whole corpus = total posting abundance (exact in
    # f64: an integer < 2^53), from the global metadata
    sum_db_ab = float(sharded.t_weight.sum())
    q_sizes = np.diff(query.offsets)
    sum_q_ab = np.add.reduceat(
        np.append(query.abundances, 0), query.offsets[:-1]
    ).astype(np.float64)
    tf = query.abundances[qhash].astype(np.float64) / sum_q_ab[seg_q[seg_id]]
    prob = np.add.reduceat(tf * (dbab_t / sum_db_ab), starts)
    tfidf = np.add.reduceat(
        tf * (1.0 + np.log((1.0 + n_targets) / (1.0 + df_t))), starts
    )

    qs = q_sizes[seg_q]
    ts = sharded.t_sizes[seg_t]
    containment = seg_n / qs
    keep = containment >= threshold
    c_tq = seg_n / ts
    jaccard = seg_n / (qs + ts - seg_n)
    return _assemble_multisearch_columns(
        query, sharded, seg_q, seg_t, seg_n,
        containment, c_tq, jaccard, prob, tfidf, keep,
        k3, n_comparisons, estimate_prob_overlap,
    )


def sharded_multisearch_columns(
    query,
    sharded: ShardedProteomeIndex,
    threshold: float = 0.0,
    estimate_prob_overlap: bool = True,
):
    """Process-level hash-range-sharded multisearch (see
    ``sharded_manysearch_columns`` for the exchange model)."""
    payloads = _allgather_payloads(local_multisearch_payload(query, sharded))
    return multisearch_columns_from_payloads(
        query, sharded, payloads, threshold, estimate_prob_overlap
    )
