"""FASTA ingest with transparent compression and batch packing.

Counterpart of ``kmerseek_tpu/core/fasta.py``, Python parser only:
streaming records, gzip/zstd/bzip2/xz auto-detection by magic bytes,
``"-"`` for stdin, record id = the full header after ``>``; plus the
fixed-grid packer that turns ragged records into padded ``(B, L)``
uint8 arrays for the sketch kernel.
"""

from __future__ import annotations

import bz2
import gzip
import io
import lzma
import sys
from dataclasses import dataclass
from typing import Iterator, List, Sequence

import numpy as np

_MAGICS = (
    (b"\x1f\x8b", "gzip"),
    (b"\x28\xb5\x2f\xfd", "zstd"),
    (b"BZh", "bzip2"),
    (b"\xfd7zXZ\x00", "xz"),
)


@dataclass
class FastaRecord:
    name: str  # full header after '>'
    seq: bytes


def _detect_compression(head: bytes) -> str:
    for magic, name in _MAGICS:
        if head.startswith(magic):
            return name
    return "plain"


def _decompress_bytes(raw: bytes, comp: str) -> bytes:
    if comp == "plain":
        return raw
    if comp == "gzip":
        return gzip.decompress(raw)
    if comp == "bzip2":
        return bz2.decompress(raw)
    if comp == "xz":
        return lzma.decompress(raw)
    if comp == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(raw, max_output_size=1 << 34)
    raise ValueError(comp)


def open_maybe_compressed(path: str) -> io.BufferedReader:
    """Open ``path`` with compression auto-detect; ``"-"`` reads stdin."""
    if path == "-":
        raw = sys.stdin.buffer.read()
        data = _decompress_bytes(raw, _detect_compression(raw[:8]))
        return io.BufferedReader(io.BytesIO(data))
    with open(path, "rb") as f:
        head = f.read(8)
    comp = _detect_compression(head)
    if comp == "plain":
        return open(path, "rb")
    if comp == "gzip":
        return io.BufferedReader(gzip.open(path, "rb"))
    if comp == "bzip2":
        return io.BufferedReader(bz2.open(path, "rb"))
    if comp == "xz":
        return io.BufferedReader(lzma.open(path, "rb"))
    with open(path, "rb") as f:  # zstd
        return io.BufferedReader(io.BytesIO(_decompress_bytes(f.read(), comp)))


def iter_fasta(path: str) -> Iterator[FastaRecord]:
    """Stream records; multi-line sequences are concatenated."""
    name = None
    chunks: List[bytes] = []
    with open_maybe_compressed(path) as f:
        for raw_line in f:
            line = raw_line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield FastaRecord(name, b"".join(chunks))
                name = line[1:].decode("utf-8")
                chunks = []
            elif line:
                if name is None:
                    raise ValueError(f"{path}: sequence data before first header")
                chunks.append(line)
    if name is not None:
        yield FastaRecord(name, b"".join(chunks))


LENGTH_GRID = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
ROW_GRID = (8, 32, 128, 512, 1024)


def _grid_up(value: int, grid) -> int:
    for g in grid:
        if value <= g:
            return g
    return grid[-1] * ((value + grid[-1] - 1) // grid[-1])


def pack_fixed_grid(seqs: Sequence[bytes], min_len: int = 256):
    """Pack records into padded batches with shapes from a fixed grid.

    Snapping (rows, length) to a small grid keeps the kernel's launch
    shapes few and the padding bounded. Rows are padded with empty
    sequences (length 0 → zero windows). Returns a list of
    ``(arr, lens, record_indices)``.
    """
    buckets: dict = {}
    for i, s in enumerate(seqs):
        L = _grid_up(max(len(s), min_len), LENGTH_GRID)
        buckets.setdefault(L, []).append(i)
    out = []
    for L, idxs in sorted(buckets.items()):
        rows = _grid_up(len(idxs), ROW_GRID)
        arr = np.zeros((rows, L), dtype=np.uint8)
        lens = np.zeros((rows,), dtype=np.int32)
        for r, i in enumerate(idxs):
            s = seqs[i]
            arr[r, : len(s)] = np.frombuffer(s, dtype=np.uint8)
            lens[r] = len(s)
        out.append((arr, lens, idxs))
    return out


def iter_record_batches(
    path: str, batch_size: int = 1000
) -> Iterator[List[FastaRecord]]:
    """Bounded batches for streaming ingest."""
    batch: List[FastaRecord] = []
    for rec in iter_fasta(path):
        batch.append(rec)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def prefetch(iterable, depth: int = 2):
    """Background-thread prefetch: FASTA reading / decompression of the
    next batch overlaps the device sketch of this one. ``depth`` bounds
    the queue; exceptions in the producer re-raise in the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()  # consumer abandoned: unblock + exit producer

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not _put(item):
                    return  # consumer gone — release the source promptly
            _put(_END)
        except BaseException as e:  # re-raised on the consumer side
            _put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
