"""ProteomeIndex — the central index, sketched on the device, stored
columnar (counterpart of ``kmerseek_tpu/core/index.py``).

* per-protein sketches as one concatenated uint64 ``mins`` array with
  CSR ``offsets`` and int64 ``abundances`` (host);
* the combined minhash as a sorted unique hash array + summed
  abundances;
* the inverted postings for search (``ops.inverted``).

Build: stream FASTA record batches → host validate/resolve →
fixed-grid padded batches → the device sketch stage
(``ops.sketch.sorted_window_hashes``, whose hash kernel is
``csrc/masked_sketch.cu``) → host run-length dedup into Signatures.

``build(engine=...)``: ``"device"`` and ``"auto"`` sketch on ``device``;
``"native"`` sketches with the C++ CPU sketcher of ``native`` (bit-equal;
raises where it cannot be built). The JAX package's ``"auto"`` sketches a
single-batch corpus of under 1M windows natively
(``_NATIVE_BUILD_MAX_KMERS``) to spare a small run the jax import and
XLA compiles, which this package does not pay; here it would only move
small sketches, the 1,024 queries of a search among them, off the card.
So ``"auto"`` always sketches on ``device``.

Persistence is the JAX package's ``.ksx`` format 2: raw ``.npy``
members, ``manifest.json``, ``metadata.json`` and ``hints.json``, so an
index written by either package loads in the other. Format 1
(``arrays.npz`` + ``inverted.npz``) loads too. ``hints.json`` carries the
engines' learned hints (``ops.sparse_search.export_learned_hints``):
``save`` writes them, both loaders seed them.
``KMERSEEK_LOAD_VERIFY=full`` checks the postings of a format-2 load
against the manifest's checksums, as format-1 loads always do, and
rebuilds them on a mismatch.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.sketch_np import merge_sketches_np
from ..utils.device import resolve_device
from .alphabet import validate_resolve_batch
from .fasta import iter_record_batches, pack_fixed_grid, prefetch
from .signature import Signature

INDEX_FORMAT_VERSION = 2
INDEX_SUFFIX = "kmerseek.ksx"


def generate_index_path(fasta: str, moltype: str, ksize: int, scaled: int) -> str:
    return f"{fasta}.{moltype}.k{ksize}.scaled{scaled}.{INDEX_SUFFIX}"


def dense_name_ranks(names: Sequence[str]) -> np.ndarray:
    """Dense lexicographic rank of each name (equal names share a rank):
    search output sorts by these integers instead of the strings."""
    arr = np.asarray(names)
    order = np.argsort(arr, kind="stable")
    snames = arr[order]
    dense = np.cumsum(
        np.concatenate([[0], (snames[1:] != snames[:-1]).astype(np.int64)])
    ) if len(snames) else np.zeros(0, np.int64)
    ranks = np.empty(len(arr), np.int64)
    ranks[order] = dense
    return ranks


def write_npy_member(path: str, name: str, arr) -> Tuple[str, dict]:
    """Write ``{path}/{name}.npy`` through a temp file and ``os.replace``
    (atomic, and re-saving a loaded index into its own directory never
    truncates a live memmap). Returns the member's manifest record."""
    fp = os.path.join(path, f"{name}.npy")
    tmp = f"{fp}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, np.ascontiguousarray(arr))
    os.replace(tmp, fp)
    return name, {
        "bytes": os.path.getsize(fp),
        "len": int(len(arr)),
        "dtype": str(np.asarray(arr).dtype),
    }


def load_npy_members(path: str, files: dict, what: str) -> dict:
    """mmap the ``.npy`` members a manifest lists (read-only), checking
    each file's size and length against its record; ``what`` names the
    container in the error (``.ksx``, ``shard``)."""
    arrs = {}
    for name, rec in files.items():
        fp = os.path.join(path, f"{name}.npy")
        if not os.path.exists(fp) or os.path.getsize(fp) != rec["bytes"]:
            raise ValueError(
                f"corrupt {what}: {name}.npy missing or size-mismatched "
                f"vs manifest at {path}"
            )
        arrs[name] = np.load(fp, mmap_mode="r")
        if len(arrs[name]) != rec["len"]:
            raise ValueError(f"corrupt {what}: {name}.npy length mismatch at {path}")
    return arrs


def _seed_hints(path: str, inv) -> None:
    """Seed the learned-hint caches of a loaded index from its
    ``hints.json`` (``ops.sparse_search.seed_learned_hints``). Hints are
    advisory: a missing, unreadable or malformed file is ignored."""
    hints_path = os.path.join(path, "hints.json")
    if not os.path.exists(hints_path):
        return
    from ..ops.sparse_search import seed_learned_hints

    try:
        with open(hints_path) as f:
            seed_learned_hints(inv, json.load(f))
    except Exception:
        pass


class ProteomeIndexBuilder:
    """Fluent builder (kmerseek's ``ProteomeIndexBuilder``); ``device``
    is where ``build`` sketches (default: the CUDA device)."""

    def __init__(self, device=None) -> None:
        self._ksize = 24
        self._scaled = 5
        self._moltype = "hp"
        self._store_raw = False
        self._batch_size = 1000
        self._progress_interval = 0
        self._device = device

    def ksize(self, k: int) -> "ProteomeIndexBuilder":
        self._ksize = k
        return self

    def scaled(self, s: int) -> "ProteomeIndexBuilder":
        self._scaled = s
        return self

    def moltype(self, m: str) -> "ProteomeIndexBuilder":
        self._moltype = m
        return self

    def store_raw_sequences(self, on: bool = True) -> "ProteomeIndexBuilder":
        self._store_raw = on
        return self

    def batch_size(self, n: int) -> "ProteomeIndexBuilder":
        self._batch_size = n
        return self

    def progress_interval(self, n: int) -> "ProteomeIndexBuilder":
        self._progress_interval = n
        return self

    def build(self, fasta: str) -> "ProteomeIndex":
        return ProteomeIndex.build(
            fasta,
            IndexConfig(self._ksize, self._scaled, self._moltype),
            batch_size=self._batch_size,
            store_raw_sequences=self._store_raw,
            progress_interval=self._progress_interval,
            device=self._device,
        )


@dataclass
class IndexConfig:
    """Validated sketch parameters."""

    ksize: int = 24
    scaled: int = 5
    moltype: str = "hp"

    def __post_init__(self):
        if not 1 <= self.ksize <= 100:
            raise ValueError(f"ksize must be in 1..=100, got {self.ksize}")
        if not 1 <= self.scaled <= 10000:
            raise ValueError(f"scaled must be in 1..=10000, got {self.scaled}")
        if self.moltype not in ("protein", "dayhoff", "hp"):
            raise ValueError(
                f"Invalid moltype: {self.moltype}, only 'protein', 'hp', or "
                "'dayhoff' are supported"
            )


def sketch_batch_signatures(
    names: List[str],
    resolved: Sequence[bytes],
    config: IndexConfig,
    *,
    device: torch.device,
    filename: str = "",
) -> List[Signature]:
    """Device-sketch one batch of validated sequences into Signatures:
    fixed-grid packing → the device sketch stage → host run-length
    dedup. An under-provisioned capacity is retried with twice the
    slots."""
    from ..ops.sketch import finalize_sorted_np, sketch_capacity, sorted_window_hashes

    k, scaled, moltype = config.ksize, config.scaled, config.moltype
    batch_sigs: List = [None] * len(names)
    for arr, lens, idxs in pack_fixed_grid(resolved, min_len=max(k + 1, 256)):
        cap = sketch_capacity(arr.shape[1], k, scaled)
        cap = max((cap + 127) // 128 * 128, 128)
        seqs = torch.from_numpy(arr).to(device)
        lengths = torch.from_numpy(lens).to(device)
        while True:
            out = sorted_window_hashes(
                seqs, lengths, k=k, scaled=scaled, moltype=moltype, capacity=cap
            )
            if int(out[2].max().item()) <= cap:
                break
            cap *= 2  # rare under-provision: retry with more slots
        mins_list, ab_list = finalize_sorted_np(*out)
        for r, i in enumerate(idxs):
            batch_sigs[i] = Signature(
                name=names[i],
                mins=mins_list[r],
                abundances=ab_list[r],
                ksize=k,
                scaled=scaled,
                moltype=moltype,
                filename=filename,
            )
    return batch_sigs


def sketch_batch_signatures_native(
    names: List[str],
    resolved: Sequence[bytes],
    config: IndexConfig,
    *,
    filename: str = "",
) -> List[Signature]:
    """Sketch one batch with the C++ CPU sketcher (``native.sketch_cpu``:
    the same encoding table, murmur64 and scaled filter as the device
    stage, so the same Signatures bit for bit). Raises ``RuntimeError``
    where the library cannot be built (no C++ compiler)."""
    from .. import native
    from ..ops.encoding import encode_bytes_np, max_hash_for_scaled

    if not native.available():
        raise RuntimeError("engine='native' requested but libkseek is unavailable")
    k, scaled, moltype = config.ksize, config.scaled, config.moltype
    mh = max_hash_for_scaled(scaled)
    sigs: List[Signature] = []
    for name, seq in zip(names, resolved):
        enc = encode_bytes_np(np.frombuffer(seq, np.uint8), moltype).tobytes()
        h, a = native.sketch_cpu(enc, k, mh)
        sigs.append(
            Signature(
                name=name,
                mins=h,
                abundances=a.astype(np.int64),
                ksize=k,
                scaled=scaled,
                moltype=moltype,
                filename=filename,
            )
        )
    return sigs


class ProteomeIndex:
    """Sketches + combined minhash + inverted postings for one proteome.

    ``device`` is where the sketch ran and where search runs its device
    stages; host arrays are numpy."""

    def __init__(
        self,
        config: IndexConfig,
        names: List[str],
        mins: np.ndarray,
        abundances: np.ndarray,
        offsets: np.ndarray,
        source_fasta: str = "",
        sequences: Optional[List[bytes]] = None,
        device=None,
    ):
        self.config = config
        self.names = list(names)
        self.mins = np.asarray(mins, dtype=np.uint64)
        self.abundances = np.asarray(abundances, dtype=np.int64)
        self.offsets = np.asarray(offsets, dtype=np.int64)  # (T+1,)
        self.source_fasta = source_fasta
        self.sequences = sequences
        self.device = resolve_device(device)
        self._combined = None
        self._inverted = None
        self._md5s = None
        self._name_ranks = None
        self._md5_array = None
        self._names_array = None
        self._kmer_table = None

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def from_arrays(
        cls, config: IndexConfig, names, mins, abundances, offsets, *, device=None
    ) -> "ProteomeIndex":
        """From the JAX package's CSR arrays (numpy)."""
        return cls(config, names, mins, abundances, offsets, device=device)

    @classmethod
    def from_signatures(
        cls,
        signatures: Sequence[Signature],
        config: Optional[IndexConfig] = None,
        source_fasta: str = "",
        sequences: Optional[List[bytes]] = None,
        device=None,
    ) -> "ProteomeIndex":
        if not signatures:
            raise ValueError("cannot build an index from zero signatures")
        sig0 = signatures[0]
        config = config or IndexConfig(sig0.ksize, sig0.scaled, sig0.moltype)
        offsets = np.zeros(len(signatures) + 1, np.int64)
        np.cumsum([len(s) for s in signatures], out=offsets[1:])
        mins = np.concatenate([s.mins for s in signatures])
        ab = np.concatenate([s.abundances for s in signatures])
        return cls(
            config, [s.name for s in signatures], mins, ab, offsets,
            source_fasta, sequences, device=device,
        )

    @classmethod
    def build(
        cls,
        fasta: str,
        config: Optional[IndexConfig] = None,
        *,
        batch_size: Optional[int] = None,
        store_raw_sequences: bool = False,
        progress_interval: Optional[int] = None,
        ambiguity_policy: str = "first",
        engine: str = "auto",
        device=None,
    ) -> "ProteomeIndex":
        """Sketch every record of ``fasta`` on ``device`` (default: the
        CUDA device; without one this raises unless ``device="cpu"``).
        ``store_raw_sequences`` keeps the validated sequences (saved as
        ``sequences.npz``) for the k-mer table.

        ``progress_interval``: log every that many records (default: the
        process-wide config's, when its metrics are on; else never).
        ``ambiguity_policy``: how B/Z/J resolve (``core.alphabet``).
        ``engine``: ``"auto"`` and ``"device"`` sketch on ``device``,
        ``"native"`` with the C++ CPU sketcher (bit-equal; raises
        ``RuntimeError`` where it cannot be built). Search on the index
        runs on ``device`` whatever sketched it."""
        if engine not in ("auto", "device", "native"):
            raise ValueError(f"unknown sketch engine: {engine!r}")
        from ..utils.config import get_default_performance_config

        device = resolve_device(device)
        config = config or IndexConfig()
        perf = get_default_performance_config()
        if batch_size is None:
            batch_size = perf.batch_size
        if progress_interval is None:
            progress_interval = perf.progress_interval if perf.enable_metrics else 0
        signatures: List[Signature] = []
        sequences: Optional[List[bytes]] = [] if store_raw_sequences else None
        n_done = 0
        filename = os.path.abspath(fasta)
        # background-thread ingest: reading batch i+1 overlaps the
        # sketch of batch i
        for records in prefetch(iter_record_batches(fasta, batch_size)):
            names = [r.name for r in records]
            resolved = validate_resolve_batch(
                [r.seq for r in records], names, policy=ambiguity_policy
            )
            if engine == "native":
                batch_sigs = sketch_batch_signatures_native(
                    names, resolved, config, filename=filename
                )
            else:
                batch_sigs = sketch_batch_signatures(
                    names, resolved, config, device=device, filename=filename
                )
            signatures.extend(batch_sigs)
            if store_raw_sequences:
                sequences.extend(resolved)
            n_done += len(records)
            if progress_interval and n_done % progress_interval == 0:
                from ..utils.logging import logger

                logger.info("processed %d sequences", n_done)
        return cls.from_signatures(
            signatures, config, source_fasta=fasta, sequences=sequences,
            device=device,
        )

    @classmethod
    def build_distributed(
        cls,
        fasta: str,
        config: Optional[IndexConfig] = None,
        *,
        batch_size: int = 1000,
        ambiguity_policy: str = "first",
        device=None,
    ) -> "ProteomeIndex":
        """Multi-process data-parallel build (``parallel.multihost``):
        each process sketches its round-robin record shard on its device
        and the shards are all-gathered — every process returns the
        identical index, equal bit for bit to a single-process
        ``build``."""
        from ..parallel.multihost import build_distributed_index

        return build_distributed_index(
            fasta,
            config,
            batch_size=batch_size,
            ambiguity_policy=ambiguity_policy,
            device=device,
        )

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.names)

    def signature(self, i: int) -> Signature:
        lo, hi = self.offsets[i], self.offsets[i + 1]
        return Signature(
            name=self.names[i],
            mins=self.mins[lo:hi],
            abundances=self.abundances[lo:hi],
            ksize=self.config.ksize,
            scaled=self.config.scaled,
            moltype=self.config.moltype,
            filename=self.source_fasta,
        )

    def signatures(self) -> List[Signature]:
        return [self.signature(i) for i in range(len(self))]

    @property
    def counts(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    @property
    def combined(self) -> Tuple[np.ndarray, np.ndarray]:
        """Union of all sketches: (sorted unique hashes, summed abundances)."""
        if self._combined is None:
            self._combined = merge_sketches_np([self.mins], [self.abundances])
        return self._combined

    def md5_for(self, i: int) -> str:
        """Sourmash md5 of signature ``i`` (cached; persisted in ``.ksx``)."""
        if self._md5s is None:
            self._md5s = [None] * len(self)
        if self._md5s[i] is None:
            self._md5s[i] = self.signature(i).md5sum
        return self._md5s[i]

    @property
    def md5_array(self) -> np.ndarray:
        if self._md5_array is None:
            self._md5_array = np.array(
                [self.md5_for(i) for i in range(len(self))], object
            )
        return self._md5_array

    @property
    def names_array(self) -> np.ndarray:
        if self._names_array is None:
            self._names_array = np.array(self.names, object)
        return self._names_array

    @property
    def name_ranks(self) -> np.ndarray:
        """Dense lexicographic rank of each signature's name (equal names
        share a rank): search output sorts by integer ranks."""
        if self._name_ranks is None:
            self._name_ranks = dense_name_ranks(self.names)
        return self._name_ranks

    def _kmer_table_derivable(self) -> bool:
        """True when ``kmer_table`` can be made (stored sequences or a
        readable source FASTA)."""
        return self.sequences is not None or bool(
            self.source_fasta and os.path.exists(self.source_fasta)
        )

    @property
    def kmer_table(self):
        """Cached k-mer sidecar table (``core.kmers`` parquet contract),
        built on first access from stored sequences or the source FASTA,
        hashed on ``self.device``."""
        if self._kmer_table is None:
            from .kmers import kmer_table_for_index

            self._kmer_table = kmer_table_for_index(self)
        return self._kmer_table

    @property
    def inverted(self):
        """Globally sorted postings, built once on ``self.device``
        (``ops.inverted.build_inverted``; ``KMERSEEK_INVERTED_BUILD`` ∈
        {auto, host, device} picks the build) or loaded from ``.ksx``."""
        if self._inverted is None:
            from ..ops.inverted import build_inverted

            self._inverted = build_inverted(
                self.mins, self.abundances, self.offsets, self.device
            )
        return self._inverted

    def _dense_slots(self, pad_multiple: int):
        """(S, rows, cols): the padded width and every CSR element's
        slot in the dense ``(T, S)`` layout."""
        counts = self.counts
        S = int(counts.max(initial=1))
        S = max(((S + pad_multiple - 1) // pad_multiple) * pad_multiple, pad_multiple)
        rows = np.repeat(np.arange(len(self)), counts)
        cols = np.arange(len(self.mins)) - np.repeat(self.offsets[:-1], counts)
        return S, rows, cols

    def dense_device_keys(self, pad_multiple: int = 128):
        """Padded ``(T, S)`` int64 sketch keys on ``self.device`` and the
        ``(T, S)`` validity mask; S = max sketch size rounded up to
        ``pad_multiple``, padding slots hold the u64::MAX sentinel."""
        S, rows, cols = self._dense_slots(pad_multiple)
        keys = np.full((len(self), S), -1, np.int64)
        keys[rows, cols] = self.mins.view(np.int64)
        valid = np.arange(S)[None, :] < self.counts[:, None]
        return (
            torch.from_numpy(keys).to(self.device),
            torch.from_numpy(valid).to(self.device),
        )

    def dense_device_arrays(self, pad_multiple: int = 128):
        """Padded ``(T, S)`` arrays for ``ops.intersect.pairwise_stats``
        on ``self.device``: ``(keys int64, abund int32, counts int32)``,
        keys as in ``dense_device_keys``, abundances 0 in the padding.
        (The JAX method returns the keys as a (hi, lo) pair.)"""
        S, rows, cols = self._dense_slots(pad_multiple)
        keys = np.full((len(self), S), -1, np.int64)
        keys[rows, cols] = self.mins.view(np.int64)
        ab = np.zeros((len(self), S), np.int32)
        ab[rows, cols] = self.abundances
        return (
            torch.from_numpy(keys).to(self.device),
            torch.from_numpy(ab).to(self.device),
            torch.from_numpy(self.counts).to(self.device),
        )

    # ------------------------------------------------------------------
    # equivalence oracle (kmerseek's ProteomeIndex::is_equivalent_to)
    # ------------------------------------------------------------------

    def is_equivalent_to(self, other: "ProteomeIndex") -> bool:
        """Same config and names, and per name the same mins and
        abundances; the same combined minhash; the same sequences where
        both hold them; the same k-mer tables where both have one or can
        make one."""
        if (
            self.config != other.config
            or len(self) != len(other)
            or sorted(self.names) != sorted(other.names)
        ):
            return False
        order_a = np.argsort(np.asarray(self.names))
        order_b = np.argsort(np.asarray(other.names))
        for ia, ib in zip(order_a, order_b):
            sa, sb = self.signature(int(ia)), other.signature(int(ib))
            if not (
                np.array_equal(sa.mins, sb.mins)
                and np.array_equal(sa.abundances, sb.abundances)
            ):
                return False
        ca, cb = self.combined, other.combined
        if not (np.array_equal(ca[0], cb[0]) and np.array_equal(ca[1], cb[1])):
            return False
        # the k-mer table derives from (sequences, config), so equal
        # name-aligned sequences imply equal tables
        if self.sequences is not None and other.sequences is not None:
            for ia, ib in zip(order_a, order_b):
                if self.sequences[int(ia)] != other.sequences[int(ib)]:
                    return False
        ta, tb = self._kmer_table, other._kmer_table
        if ta is None and tb is not None and self._kmer_table_derivable():
            ta = self.kmer_table
        if tb is None and ta is not None and other._kmer_table_derivable():
            tb = other.kmer_table
        if ta is not None and tb is not None:
            cols = ["sequence_name", "kmer", "hashval", "encoded", "start"]
            sa = ta.select(cols).to_pandas().sort_values(cols).reset_index(drop=True)
            sb = tb.select(cols).to_pandas().sort_values(cols).reset_index(drop=True)
            if not sa.equals(sb):
                return False
        return True

    # ------------------------------------------------------------------
    # persistence (.ksx format 2, shared with the JAX package)
    # ------------------------------------------------------------------

    def save(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)

        inv = self.inverted.with_buckets()
        if hasattr(inv, "ensure_host_from_source"):  # a DeviceInvertedIndex
            inv.ensure_host_from_source(self.mins, self.abundances, self.offsets)
        members = {
            "mins": self.mins,
            "abundances": self.abundances,
            "offsets": self.offsets,
            "inv_g_hi": inv.g_hi,
            "inv_g_lo": inv.g_lo,
            "inv_tid": inv.tid,
            "inv_ab": inv.ab,
            "inv_bucket_starts": inv.bucket_starts,
        }
        with ThreadPoolExecutor(max_workers=3) as pool:
            futures = [pool.submit(write_npy_member, path, *it) for it in members.items()]
            sums = {
                "mins": int(self.mins.sum(dtype=np.uint64)),
                "abundances": int(self.abundances.sum(dtype=np.int64)),
                "inv_g64": int(inv.g64().sum(dtype=np.uint64)),
                "inv_ab": int(inv.ab.sum(dtype=np.int64)),
            }
            meta = {
                "format_version": INDEX_FORMAT_VERSION,
                "ksize": self.config.ksize,
                "scaled": self.config.scaled,
                "moltype": self.config.moltype,
                "n_signatures": len(self),
                "source_fasta": self.source_fasta,
                "names": self.names,
                "has_sequences": self.sequences is not None,
                "md5s": [self.md5_for(i) for i in range(len(self))],
            }
            with open(os.path.join(path, "metadata.json"), "w") as f:
                json.dump(meta, f)
            files = dict(fut.result() for fut in futures)
        manifest = {
            "inverted_shape": [
                int(inv.n_targets),
                int(inv.max_run),
                int(inv.max_span),
                int(inv.bucket_shift),
            ],
            "files": files,
            "sums": sums,
        }
        # the manifest lands last (atomic rename): a crashed half-save
        # leaves no manifest describing unwritten files
        mtmp = os.path.join(path, "manifest.json.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(path, "manifest.json"))
        # a previous format-1 save into this directory must not survive
        for legacy in ("arrays.npz", "inverted.npz"):
            lp = os.path.join(path, legacy)
            if os.path.exists(lp):
                os.remove(lp)
        # the learned hints (the sparse engine's E and fetch lengths, the
        # dense block): a warm start for a fresh process, never results.
        # Written even when empty, so a previous index's hints never
        # survive a re-save into this directory
        from ..ops.sparse_search import export_learned_hints

        with open(os.path.join(path, "hints.json"), "w") as f:
            json.dump(export_learned_hints(inv), f)
        if self.sequences is not None:
            seq_off = np.zeros(len(self.sequences) + 1, np.int64)
            np.cumsum([len(s) for s in self.sequences], out=seq_off[1:])
            np.savez_compressed(
                os.path.join(path, "sequences.npz"),
                data=np.frombuffer(b"".join(self.sequences), np.uint8),
                offsets=seq_off,
            )
        return path

    @classmethod
    def load(cls, path: str, device=None) -> "ProteomeIndex":
        """Open a ``.ksx`` directory: format 2 (members mmapped) or
        format 1 (``arrays.npz`` + ``inverted.npz``). Postings that
        disagree with the sketch arrays are dropped with a warning and
        rebuilt on ``device`` when first used."""
        meta_path = os.path.join(path, "metadata.json")
        if not os.path.exists(meta_path):
            from ..utils.errors import NoSavedState

            raise NoSavedState(f"no saved index at {path}")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta["format_version"] > INDEX_FORMAT_VERSION:
            raise ValueError(f"index format {meta['format_version']} too new")
        sequences = None
        seq_path = os.path.join(path, "sequences.npz")
        if meta.get("has_sequences") and os.path.exists(seq_path):
            sq = np.load(seq_path)
            data, offs = sq["data"].tobytes(), sq["offsets"]
            sequences = [data[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
        manifest_path = os.path.join(path, "manifest.json")
        if os.path.exists(manifest_path):
            return cls._load_npy(path, meta, manifest_path, sequences, device)
        return cls._load_npz(path, meta, sequences, device)

    @classmethod
    def _from_meta(cls, meta, mins, abundances, offsets, sequences, device) -> "ProteomeIndex":
        idx = cls(
            IndexConfig(meta["ksize"], meta["scaled"], meta["moltype"]),
            meta["names"],
            mins,
            abundances,
            offsets,
            source_fasta=meta.get("source_fasta", ""),
            sequences=sequences,
            device=device,
        )
        if meta.get("md5s"):
            idx._md5s = list(meta["md5s"])
        return idx

    @classmethod
    def _load_npz(cls, path, meta, sequences, device) -> "ProteomeIndex":
        """Format 1: ``arrays.npz`` (CSR) and ``inverted.npz`` (postings),
        read whole. The postings must be a permutation of the CSR arrays
        (order-independent sums catch a stale or truncated
        ``inverted.npz``); an older file without the bucket table gets
        one computed."""
        from ..ops.inverted import InvertedIndex

        arrays = np.load(os.path.join(path, "arrays.npz"))
        idx = cls._from_meta(
            meta, arrays["mins"], arrays["abundances"], arrays["offsets"], sequences, device
        )
        inv_path = os.path.join(path, "inverted.npz")
        if not os.path.exists(inv_path):
            return idx
        iz = np.load(inv_path)
        shape = [int(v) for v in iz["shape"]]
        inv = InvertedIndex(iz["g_hi"], iz["g_lo"], iz["tid"], iz["ab"], shape[0], shape[1])
        ok = (
            len(inv.g_hi) == len(idx.mins)
            and shape[0] == len(idx)
            and int(inv.ab.sum(dtype=np.int64)) == int(idx.abundances.sum(dtype=np.int64))
            and int(inv.g64().sum(dtype=np.uint64)) == int(idx.mins.sum(dtype=np.uint64))
        )
        if not ok:
            from ..utils.logging import logger

            logger.warning(
                "persisted inverted index at %s is inconsistent with "
                "the sketch arrays — rebuilding postings",
                inv_path,
            )
            return idx  # postings rebuilt from the CSR arrays when first used
        if "bucket_starts" in iz.files and len(shape) >= 4:
            inv = inv._replace(
                bucket_starts=iz["bucket_starts"], max_span=shape[2], bucket_shift=shape[3]
            )
        else:
            inv = inv.with_buckets()
        idx._inverted = inv
        _seed_hints(path, inv)
        return idx

    @classmethod
    def _load_npy(cls, path, meta, manifest_path, sequences, device) -> "ProteomeIndex":
        """Format 2: mmap the raw ``.npy`` members, checking their sizes
        and lengths against the manifest. ``KMERSEEK_LOAD_VERIFY=full``
        also compares the content with the checksums the save recorded
        (reading every member); on a mismatch the postings are dropped
        and rebuilt from the CSR arrays when first used."""
        from ..ops.inverted import InvertedIndex

        with open(manifest_path) as f:
            manifest = json.load(f)
        arrs = load_npy_members(path, manifest["files"], ".ksx")
        if (
            int(arrs["offsets"][-1]) != len(arrs["mins"])
            or len(arrs["inv_g_hi"]) != len(arrs["mins"])
            or len(arrs["offsets"]) != len(meta["names"]) + 1
        ):
            raise ValueError(f"corrupt .ksx: member shapes disagree at {path}")
        idx = cls._from_meta(
            meta, arrs["mins"], arrs["abundances"], arrs["offsets"], sequences, device
        )
        shape = manifest["inverted_shape"]
        inv = InvertedIndex(
            arrs["inv_g_hi"],
            arrs["inv_g_lo"],
            arrs["inv_tid"],
            arrs["inv_ab"],
            shape[0],
            shape[1],
            bucket_starts=arrs["inv_bucket_starts"],
            max_span=shape[2],
            bucket_shift=shape[3],
        )
        if os.environ.get("KMERSEEK_LOAD_VERIFY") == "full":
            sums = manifest.get("sums", {})
            ok = (
                int(idx.mins.sum(dtype=np.uint64)) == sums.get("mins")
                and int(idx.abundances.sum(dtype=np.int64)) == sums.get("abundances")
                and int(inv.g64().sum(dtype=np.uint64)) == sums.get("inv_g64")
                and int(inv.ab.sum(dtype=np.int64)) == sums.get("inv_ab")
                and sums.get("mins") == sums.get("inv_g64")
                and sums.get("abundances") == sums.get("inv_ab")
            )
            if not ok:
                from ..utils.logging import logger

                logger.warning(
                    "full verify: posting content at %s disagrees with the "
                    "manifest checksums — rebuilding postings",
                    path,
                )
                return idx
        idx._inverted = inv
        _seed_hints(path, inv)
        return idx

    # ------------------------------------------------------------------
    # sourmash interop
    # ------------------------------------------------------------------

    def to_sig_zip(self, path: str) -> str:
        from .sigzip import write_sig_zip

        return write_sig_zip(path, self.signatures())

    @classmethod
    def from_sig_zip(cls, path: str, device=None) -> "ProteomeIndex":
        from .sigzip import read_sig_zip

        return cls.from_signatures(read_sig_zip(path), device=device)

    @classmethod
    def build_with_auto_filename(
        cls, fasta: str, config: Optional[IndexConfig] = None, **kwargs
    ) -> Tuple["ProteomeIndex", str]:
        """Build, and save under ``generate_index_path``'s name."""
        config = config or IndexConfig()
        idx = cls.build(fasta, config, **kwargs)
        path = generate_index_path(fasta, config.moltype, config.ksize, config.scaled)
        idx.save(path)
        return idx, path

    def print_stats(self) -> str:
        """kmerseek's ``print_stats`` summary."""
        comb, _ = self.combined
        lines = [
            f"ProteomeIndex: {len(self)} signatures",
            f"  moltype={self.config.moltype} ksize={self.config.ksize} "
            f"scaled={self.config.scaled}",
            f"  total hashes: {len(self.mins)}",
            f"  combined minhash size: {len(comb)}",
        ]
        return "\n".join(lines)
