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

Spans (``utils.metrics``): ``kmers.extract`` around a sidecar write
(counter ``kmers.rows``), with children ``kmers.hash`` (the device pass,
``nonzero`` and the two copies back, each a ``device.syncs``),
``kmers.strings`` and ``kmers.write``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import pyarrow as pa
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
    ``write_kmer_table(kmer_table_for_index(index), path)``."""
    def flush(writer, pending):
        with span("kmers.write"):
            writer.write_table(pa.concat_tables(pending), row_group_size=KMERS_ROW_GROUP)

    with span("kmers.extract"), pq.ParquetWriter(path, KMERS_SCHEMA) as writer:
        pending: List[pa.Table] = []
        n_pending = 0
        for chunk in iter_kmer_batches(**_index_kw(index, sequence_file)):
            count("kmers.rows", len(chunk))
            pending.append(chunk)
            n_pending += len(chunk)
            if n_pending >= KMERS_ROW_GROUP:
                flush(writer, pending)
                pending, n_pending = [], 0
        if pending:
            flush(writer, pending)
    return path
