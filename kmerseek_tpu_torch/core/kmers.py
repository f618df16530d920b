"""K-mer table extraction — the (hash → k-mer string, position) sidecar
(counterpart of ``kmerseek_tpu/core/kmers.py``).

The parquet contract of kmerseek's sig2kmer path: columns
``sequence_file, sequence_name, kmer, hashval, encoded, start`` with one
row per window occurrence whose hash survives the scaled filter, in
row-major (sequence, start) order. hp/dayhoff collisions (several
original k-mers → one encoded hash) are naturally multimap rows.

The hash pass runs on the index's device: the window-hash kernel
(``csrc/window_hashes.cu``) on a CUDA device, its plain version on the
CPU. Only the kept ``(row, start, hash)`` triples come back to the host;
the strings are numpy slicing on the host.

``write_kmer_table_for_index`` also writes the sidecar's hash index
beside it (``kmer_hash_index_filename``): the file's hashes sorted with
the row of each, and its rows' names, starts and k-mer strings in fixed
widths, so that the stitch finds the rows of a set of hashes by binary
search without decoding the parquet (``open_hash_index``). An index
holds the size, ``st_mtime_ns`` and last bytes of the parquet it was
written with, and is used only while they match.

Spans (``utils.metrics``): ``kmers.extract`` around a sidecar write
(counter ``kmers.rows``), with children ``kmers.hash`` (the device pass,
``nonzero`` and the two copies back, each a ``device.syncs``),
``kmers.strings``, ``kmers.write`` and ``kmers.index``.
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import struct
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import torch

from ..ops.encoding import encode_bytes_np
from ..ops.sketch import window_hashes
from ..utils.device import resolve_device
from ..utils.metrics import count, note_sync, span
from .fasta import pack_batch

KMERS_SCHEMA = pa.schema(
    [
        ("sequence_file", pa.large_string()),
        ("sequence_name", pa.large_string()),
        ("kmer", pa.large_string()),
        ("hashval", pa.uint64()),
        ("encoded", pa.large_string()),
        ("start", pa.uint32()),
    ]
)


def kmer_table_filename(sig_path: str) -> str:
    """sig2kmer.py:27-28 convention."""
    return f"{sig_path}.kmers.pq"


def _kept_windows(arr: np.ndarray, lens: np.ndarray, ksize, scaled, moltype, device):
    """Hash pass on ``device``: the kept windows' ``(rows, starts, hashes
    uint64)`` in row-major order (``torch.nonzero`` order = that of
    ``np.nonzero``)."""
    with span("kmers.hash"):
        hashes, keep = window_hashes(
            torch.from_numpy(arr).to(device),
            torch.from_numpy(lens).to(device),
            k=ksize, scaled=scaled, moltype=moltype,
        )
        nz = torch.nonzero(keep)
        h = hashes[nz[:, 0], nz[:, 1]]
        note_sync(nz)
        nz = nz.cpu().numpy()
        note_sync(h)
        h = h.cpu().numpy()
    return nz[:, 0], nz[:, 1], h.view(np.uint64)


def iter_kmer_batches(
    names: Sequence[str],
    resolved_seqs: Sequence[bytes],
    *,
    ksize: int,
    scaled: int,
    moltype: str,
    sequence_file: str,
    batch_rows: int = 512,
    device=None,
):
    """Yield the k-mer table in ``batch_rows``-sequence pa.Table chunks,
    so that a large sidecar streams to parquet row groups without the
    whole table in memory. ``device`` runs the hash pass (default: the
    CUDA device; without one this raises unless ``device="cpu"``)."""
    from numpy.lib.stride_tricks import sliding_window_view

    device = resolve_device(device)
    for lo in range(0, len(names), batch_rows):
        chunk_names = names[lo : lo + batch_rows]
        chunk_seqs = resolved_seqs[lo : lo + batch_rows]
        arr, lens = pack_batch(chunk_seqs, min_len=max(ksize + 1, 128))
        rows, starts, h64 = _kept_windows(arr, lens, ksize, scaled, moltype, device)
        if len(rows) == 0:
            continue
        with span("kmers.strings"):
            # window bytes come from sliding views over the padded byte grid
            # and decode as fixed-width S<k> columns; no per-window Python
            enc_arr = encode_bytes_np(arr, moltype)
            win = sliding_window_view(arr, ksize, axis=1)
            enc_win = sliding_window_view(enc_arr, ksize, axis=1)
            kmers = (
                np.ascontiguousarray(win[rows, starts])
                .view(f"S{ksize}")
                .ravel()
                .astype(f"U{ksize}")
            )
            encs = (
                np.ascontiguousarray(enc_win[rows, starts])
                .view(f"S{ksize}")
                .ravel()
                .astype(f"U{ksize}")
            )
            name_col = np.asarray(chunk_names, dtype=object)[rows]
            table = pa.Table.from_arrays(
                [
                    pa.array(np.full(len(rows), sequence_file, object), pa.large_string()),
                    pa.array(name_col, pa.large_string()),
                    pa.array(kmers, pa.large_string()),
                    pa.array(h64, pa.uint64()),
                    pa.array(encs, pa.large_string()),
                    pa.array(starts.astype(np.uint32), pa.uint32()),
                ],
                schema=KMERS_SCHEMA,
            )
        yield table


def extract_kmer_table(
    names: Sequence[str],
    resolved_seqs: Sequence[bytes],
    **kw,
) -> pa.Table:
    """Build the k-mer table for already-validated sequences (eager)."""
    chunks: List[pa.Table] = list(iter_kmer_batches(names, resolved_seqs, **kw))
    if not chunks:
        return KMERS_SCHEMA.empty_table()
    return pa.concat_tables(chunks)


# parquet row-group size (rows). Bounds the unit the streaming reader
# (core.stitch join) must hold in memory at once: 2^18 rows of this
# schema ≈ 20-30 MB decoded.
KMERS_ROW_GROUP = 1 << 18


def write_kmer_table(table: pa.Table, path: str) -> str:
    pq.write_table(table, path, row_group_size=KMERS_ROW_GROUP)
    return path


def read_kmer_table(path: str) -> pa.Table:
    return pq.read_table(path)


# The hash index, ``<sidecar>.hidx``, little-endian:
#   [0, 4096)  magic, uint32 version, uint32 length of the JSON header that
#              follows: rows, k, sequence_file, the parquet's identity
#              (``_parquet_identity``), the names' count and width, the
#              offset of each section below and the file's size
#   records    one a file row, in file order: uint32 name code (the order
#              of first appearance), uint32 start, kmer and encoded k bytes
#   hashes     uint64, every row's hashval sorted; a stable sort, so equal
#              hashes keep file order
#   order      uint32, the file row of each sorted hash
#   names      the distinct names' UTF-8 bytes, sorted, NUL-padded
#   codes      uint32, the name code of each sorted name
# Sections after the records start on 8-byte boundaries.
HASH_INDEX_MAGIC = b"KMSHIDX\0"
HASH_INDEX_VERSION = 1
_HEADER_BYTES = 4096
_PREFIX = struct.Struct("<8sII")
_TAIL_BYTES = 1 << 16  # the parquet's last bytes: its footer and more


def kmer_hash_index_filename(path: str) -> str:
    """The hash index written beside the sidecar ``path``."""
    return f"{path}.hidx"


def _record_dtype(k: int) -> np.dtype:
    return np.dtype([("name", "<u4"), ("start", "<u4"), ("kmer", f"S{k}"), ("encoded", f"S{k}")])


def _parquet_identity(path: str) -> dict:
    """What an index records of its parquet, and a reader compares: the
    size, ``st_mtime_ns`` and a digest of the last ``_TAIL_BYTES``."""
    st = os.stat(path)
    with open(path, "rb") as f:
        f.seek(max(st.st_size - _TAIL_BYTES, 0))
        tail = hashlib.blake2b(f.read(), digest_size=16).hexdigest()
    return {"parquet_size": st.st_size, "parquet_mtime_ns": st.st_mtime_ns, "parquet_tail": tail}


def _fixed_width(column: pa.ChunkedArray, k: int) -> np.ndarray:
    """A string column of ``k``-byte values as ``S<k>`` (a view of its
    data buffer where it is one ``large_string`` chunk)."""
    arr = column.combine_chunks().cast(pa.large_string())
    if len(arr) == 0:
        return np.zeros(0, f"S{k}")
    offsets = np.frombuffer(arr.buffers()[1], np.int64, len(arr) + 1, arr.offset * 8)
    data = np.frombuffer(arr.buffers()[2], np.uint8, offsets[-1] - offsets[0], offsets[0])
    # a NUL would be lost: numpy drops an S value's trailing NULs
    if arr.null_count or (np.diff(offsets) != k).any() or not data.all():
        raise ValueError(f"k-mer strings must be {k} bytes wide, with no NUL")
    return data.view(f"S{k}")


class _HashIndexWriter:
    """Writes a sidecar's hash index as the sidecar's chunks come: their
    records go to a temporary file in file order, and only the hashes
    are held, for the sort. ``finish`` adds the sorted sections and the
    header once the parquet is closed, and moves the file into place.
    A sidecar the format cannot hold (more than one ``sequence_file``, a
    name ending in NUL, 2^32 rows) gets no index."""

    def __init__(self, path: str, k: int):
        self.path = kmer_hash_index_filename(path)
        self.tmp = self.path + ".tmp"
        self.k, self.dtype = k, _record_dtype(k)
        self.hashes: List[np.ndarray] = []
        self.codes: dict = {}  # name -> code, in order of first appearance
        self.sequence_file = None
        self.indexable = True
        self.file = open(self.tmp, "wb")
        self.file.write(bytes(_HEADER_BYTES))

    def __enter__(self) -> "_HashIndexWriter":
        return self

    def __exit__(self, *exc) -> None:
        self._discard()

    def _discard(self) -> None:
        """Remove the temporary file, unless ``finish`` put it in place."""
        if not self.file.closed:
            self.file.close()
            os.remove(self.tmp)

    def _code(self, name: str) -> int:
        code = self.codes.get(name)
        if code is None:
            code = self.codes[name] = len(self.codes)
            self.indexable &= not name.endswith("\0")
        return code

    def add(self, chunk: pa.Table) -> None:
        """The records of ``chunk`` (of ``KMERS_SCHEMA``), the next rows of
        the file."""
        if not self.indexable or len(chunk) == 0:
            return
        with span("kmers.index"):
            files = chunk.column("sequence_file")
            if self.sequence_file is None:
                self.sequence_file = files[0].as_py()
            self.indexable &= pc.all(pc.equal(files, self.sequence_file), skip_nulls=False).as_py() is True
            names = pc.dictionary_encode(chunk.column("sequence_name")).combine_chunks()
            codes = np.array([self._code(s) for s in names.dictionary.to_pylist()], np.uint32)
            rec = np.empty(len(chunk), self.dtype)
            rec["name"] = codes[names.indices.to_numpy()]
            rec["start"] = chunk.column("start").to_numpy()
            rec["kmer"] = _fixed_width(chunk.column("kmer"), self.k)
            rec["encoded"] = _fixed_width(chunk.column("encoded"), self.k)
            self.file.write(rec.tobytes())
            self.hashes.append(chunk.column("hashval").to_numpy())

    def finish(self, parquet_path: str) -> None:
        """Sort, write the sections and the header, and put the index in
        place. For a sidecar it cannot hold, remove any index there."""
        from ..ops.inverted import _stable_argsort_u64

        with span("kmers.index"):
            hashes = np.concatenate(self.hashes) if self.hashes else np.zeros(0, np.uint64)
            n = len(hashes)
            names = [s.encode() for s in self.codes]
            width = max(map(len, names), default=1)
            sizes = {"hashes": 8 * n, "order": 4 * n, "names": width * len(names), "codes": 4 * len(names)}
            sections, end = {}, _HEADER_BYTES + n * self.dtype.itemsize
            for key, size in sizes.items():
                sections[key] = end = -(-end // 8) * 8
                end += size
            head = json.dumps({"rows": n, "k": self.k, "sequence_file": self.sequence_file,
                               **_parquet_identity(parquet_path), "name_width": width, "names": len(names),
                               "sections": sections, "bytes": end}).encode()
            if not self.indexable or n >= 1 << 32 or _PREFIX.size + len(head) > _HEADER_BYTES:
                self._discard()
                if os.path.exists(self.path):
                    os.remove(self.path)
                return
            order = _stable_argsort_u64(hashes)
            table = np.array(names, dtype=f"S{width}")
            by_name = np.argsort(table, kind="stable")
            for key, arr in (("hashes", hashes[order]), ("order", order.astype("<u4")),
                             ("names", table[by_name]), ("codes", by_name.astype("<u4"))):
                self.file.seek(sections[key])
                self.file.write(arr.tobytes())
            self.file.truncate(end)
            self.file.seek(0)
            self.file.write(_PREFIX.pack(HASH_INDEX_MAGIC, HASH_INDEX_VERSION, len(head)) + head)
            self.file.close()
            os.replace(self.tmp, self.path)


class HashIndex(NamedTuple):
    """A sidecar's hash index, its arrays mapped from the file."""

    rows: int  # the parquet's rows
    sequence_file: Optional[str]  # None in an index of no rows
    hashes: np.ndarray  # uint64, sorted
    order: np.ndarray  # uint32, the file row of each sorted hash
    records: np.ndarray  # ``_record_dtype(k)``, one a file row
    names: np.ndarray  # S<width>, the distinct names sorted
    codes: np.ndarray  # uint32, the name code of each sorted name


def open_hash_index(path: str) -> Optional[HashIndex]:
    """The hash index of the sidecar ``path``, or None where it has none,
    or the index is unreadable, of another version, or was written with
    another parquet than the one at ``path`` now (size, ``st_mtime_ns``
    or last bytes differ)."""
    try:
        with open(kmer_hash_index_filename(path), "rb") as f:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, version, n = _PREFIX.unpack_from(buf)
        if magic != HASH_INDEX_MAGIC or version != HASH_INDEX_VERSION:
            return None
        head = json.loads(buf[_PREFIX.size : _PREFIX.size + n])
        identity = _parquet_identity(path)
        if any(head[key] != v for key, v in identity.items()) or head["bytes"] != len(buf):
            return None
        rows, sec = head["rows"], head["sections"]
        return HashIndex(
            rows,
            head["sequence_file"],
            np.frombuffer(buf, "<u8", rows, sec["hashes"]),
            np.frombuffer(buf, "<u4", rows, sec["order"]),
            np.frombuffer(buf, _record_dtype(head["k"]), rows, _HEADER_BYTES),
            np.frombuffer(buf, f"S{head['name_width']}", head["names"], sec["names"]),
            np.frombuffer(buf, "<u4", head["names"], sec["codes"]),
        )
    except (OSError, ValueError, KeyError, TypeError, struct.error):
        return None


def _resolved_sequences_for_index(index):
    """Stored raw sequences, or re-read + validate the source FASTA."""
    sequences = index.sequences
    if sequences is None:
        if not index.source_fasta or not os.path.exists(index.source_fasta):
            raise ValueError(
                "index has neither stored sequences nor a readable "
                "source_fasta; re-build with store_raw_sequences=True"
            )
        from .alphabet import validate_resolve_batch
        from .fasta import read_fasta

        records = read_fasta(index.source_fasta)
        by_name = {r.name: r.seq for r in records}
        sequences = validate_resolve_batch(
            [by_name[n] for n in index.names], index.names
        )
    return sequences


def _index_kw(index, sequence_file: Optional[str]) -> dict:
    """``iter_kmer_batches`` arguments for a built ProteomeIndex: its
    sequences and parameters, hashed on its device."""
    return dict(
        names=index.names,
        resolved_seqs=_resolved_sequences_for_index(index),
        ksize=index.config.ksize,
        scaled=index.config.scaled,
        moltype=index.config.moltype,
        sequence_file=sequence_file or os.path.abspath(index.source_fasta),
        device=index.device,
    )


def kmer_table_for_index(index, sequence_file: Optional[str] = None) -> pa.Table:
    """Extract the table for a built ProteomeIndex (eager)."""
    return extract_kmer_table(**_index_kw(index, sequence_file))


def write_kmer_table_for_index(
    index, path: str, sequence_file: Optional[str] = None
) -> str:
    """Stream the index's k-mer table straight to ``path``, one row
    group per ``KMERS_ROW_GROUP`` rows: peak memory is about one row
    group, not the table. Decodes identically to
    ``write_kmer_table(kmer_table_for_index(index), path)``. Its hash
    index goes beside it (``kmer_hash_index_filename``)."""
    def flush(writer, pending):
        with span("kmers.write"):
            writer.write_table(pa.concat_tables(pending), row_group_size=KMERS_ROW_GROUP)

    kw = _index_kw(index, sequence_file)
    with span("kmers.extract"), _HashIndexWriter(path, kw["ksize"]) as hash_index:
        with pq.ParquetWriter(path, KMERS_SCHEMA) as writer:
            pending: List[pa.Table] = []
            n_pending = 0
            for chunk in iter_kmer_batches(**kw):
                count("kmers.rows", len(chunk))
                hash_index.add(chunk)
                pending.append(chunk)
                n_pending += len(chunk)
                if n_pending >= KMERS_ROW_GROUP:
                    flush(writer, pending)
                    pending, n_pending = [], 0
            if pending:
                flush(writer, pending)
        hash_index.finish(path)  # the parquet is closed: its size and mtime are final
    return path
