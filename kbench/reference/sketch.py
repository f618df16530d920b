"""Plain numpy FracMinHash sketches, written from the published
definitions and nothing of the program under test.

* FASTA: a record is the header after ``>`` and the concatenated
  sequence lines.
* Residues are uppercased; ``B Z J`` resolve to ``D E I``; a record ends
  after its first ``*`` (kept); any other byte outside the 20 standard
  amino acids and ``X U O *`` is an error.
* Encodings (sourmash ``aa_to_dayhoff`` / ``aa_to_hp``): ``protein``
  hashes the residues as they are; ``dayhoff`` maps to ``a``–``f``;
  ``hp`` to ``h`` (hydrophobic) / ``p`` (polar); anything else to ``x``.
* Hash: MurmurHash3 x64_128, seed 42, first 64-bit lane, over each
  window of k encoded bytes (sourmash ``0.murmur64``).
* Filter: keep a window iff its hash <= max_hash, with sourmash's
  ``max_hash = (u64::MAX as f64 / scaled) as u64`` (saturating).
* A signature is the sorted distinct kept hashes with their counts.
* sourmash md5: md5 of ``str(3k)`` followed by the decimal mins.
* Postings: every (hash, target, abundance), sorted by hash, ties in
  target order; the bucket table holds, for each of 2^20 buckets of
  ``hash >> shift``, the first posting at or past it, with ``shift``
  anchored at the largest hash's leading zeros and at least 32.
"""

from __future__ import annotations

import hashlib
from typing import List, NamedTuple, Tuple

import numpy as np

SEED = 42
BUCKET_BITS = 20
_U64 = np.uint64

_HP = {"h": "AFGILMPVWY", "p": "CDEHKNQRST"}
_DAYHOFF = {"a": "C", "b": "AGPST", "c": "DENQ", "d": "HKR", "e": "ILMV", "f": "FWY"}
_VALID = b"ACDEFGHIKLMNPQRSTVWYXUO*BZJ"
_RESOLVE = {ord("B"): ord("D"), ord("Z"): ord("E"), ord("J"): ord("I")}


def _class_table(classes: dict) -> np.ndarray:
    t = np.full(256, ord("x"), np.uint8)
    for out, members in classes.items():
        for ch in members:
            t[ord(ch)] = ord(out)
    return t


ENCODINGS = {
    "protein": np.arange(256, dtype=np.uint8),
    "hp": _class_table(_HP),
    "dayhoff": _class_table(_DAYHOFF),
}


def max_hash(scaled: int) -> int:
    """sourmash's threshold: the division in f64, the cast saturating."""
    return min(int(float(2**64) / scaled), 2**64 - 1)


def read_fasta(path: str) -> Tuple[List[str], List[bytes]]:
    names, seqs, chunks = [], [], None
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if chunks is not None:
                    seqs.append(b"".join(chunks))
                names.append(line[1:].decode())
                chunks = []
            elif line:
                chunks.append(line)
    if chunks is not None:
        seqs.append(b"".join(chunks))
    return names, seqs


def clean(seq: bytes) -> bytes:
    """Uppercase, cut after the first stop, check, resolve B/Z/J."""
    s = seq.upper()
    stop = s.find(b"*")
    if stop >= 0:
        s = s[: stop + 1]
    bad = s.translate(None, _VALID)
    if bad:
        raise ValueError(f"invalid residue {bad[:1]!r}")
    return bytes(_RESOLVE.get(c, c) for c in s) if any(c in _RESOLVE for c in s) else s


class Sketches(NamedTuple):
    names: List[str]
    mins: np.ndarray  # (N,) uint64, ascending within each signature
    abundances: np.ndarray  # (N,) int64
    offsets: np.ndarray  # (T + 1,) int64


def _rotl(x, r):
    return (x << _U64(r)) | (x >> _U64(64 - r))


def _fmix(x):
    x = x ^ (x >> _U64(33))
    x = x * _U64(0xFF51AFD7ED558CCD)
    x = x ^ (x >> _U64(33))
    x = x * _U64(0xC4CEB9FE1A85EC53)
    return x ^ (x >> _U64(33))


_C1 = _U64(0x87C37B91114253D5)
_C2 = _U64(0x4CF5AD432745937F)


def murmur64(data: np.ndarray, starts: np.ndarray, k: int, seed: int = SEED) -> np.ndarray:
    """MurmurHash3 x64_128's first lane of ``data[s:s+k]`` for every s in
    ``starts`` (``data`` uint8; windows must lie inside it)."""
    padded = np.zeros(len(data) + 16, np.uint8)
    padded[: len(data)] = data
    # the little-endian u64 word that starts at each byte
    words = np.ndarray((len(data) + 8,), dtype="<u8", buffer=padded, strides=(1,))
    starts = np.asarray(starts, np.int64)

    def word(offset, nbytes=8):
        w = words[starts + offset].astype(np.uint64)
        return w if nbytes == 8 else w & _U64((1 << (8 * nbytes)) - 1)

    h1 = np.full(len(starts), seed, np.uint64)
    h2 = h1.copy()
    nblocks, tail = divmod(k, 16)
    for b in range(nblocks):
        k1 = _rotl(word(16 * b) * _C1, 31) * _C2
        h1 = ((_rotl(h1 ^ k1, 27) + h2) * _U64(5)) + _U64(0x52DCE729)
        k2 = _rotl(word(16 * b + 8) * _C2, 33) * _C1
        h2 = ((_rotl(h2 ^ k2, 31) + h1) * _U64(5)) + _U64(0x38495AB5)
    if tail > 8:
        h2 = h2 ^ (_rotl(word(16 * nblocks + 8, tail - 8) * _C2, 33) * _C1)
    if tail > 0:
        h1 = h1 ^ (_rotl(word(16 * nblocks, min(tail, 8)) * _C1, 31) * _C2)
    h1 = h1 ^ _U64(k)
    h2 = h2 ^ _U64(k)
    h1 = h1 + h2
    h2 = h2 + h1
    return _fmix(h1) + _fmix(h2)


def window_hashes(seqs: List[bytes], k: int, moltype: str):
    """Every window's hash and the index of its sequence."""
    lens = np.array([len(s) for s in seqs], np.int64)
    data = ENCODINGS[moltype][np.frombuffer(b"".join(seqs), np.uint8)]
    offs = np.concatenate([[0], np.cumsum(lens)])
    nwin = np.maximum(lens - k + 1, 0)
    sid = np.repeat(np.arange(len(seqs), dtype=np.int64), nwin)
    first = np.concatenate([[0], np.cumsum(nwin)])[:-1]
    starts = np.repeat(offs[:-1], nwin) + (np.arange(nwin.sum()) - np.repeat(first, nwin))
    return murmur64(data, starts, k), sid


def sketch(names: List[str], seqs: List[bytes], k: int, scaled: int, moltype: str,
           hash_dtype=np.uint64) -> Sketches:
    """Signatures of cleaned sequences. ``hash_dtype=np.float64`` carries
    the hashes through f64, the precision control of the index cells."""
    h, sid = window_hashes(seqs, k, moltype)
    if hash_dtype is np.uint64:
        keep = h <= _U64(max_hash(scaled))
    else:
        hf = h.astype(hash_dtype)
        keep = hf <= hash_dtype(max_hash(scaled))
        with np.errstate(all="ignore"):
            h = hf.astype(np.uint64)
    h, sid = h[keep], sid[keep]
    order = np.lexsort((h, sid))
    h, sid = h[order], sid[order]
    new = np.ones(len(h), bool)
    new[1:] = (h[1:] != h[:-1]) | (sid[1:] != sid[:-1])
    heads = np.flatnonzero(new)
    ab = np.diff(np.append(heads, len(h))).astype(np.int64)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum(np.bincount(sid[heads], minlength=len(seqs)), out=offsets[1:])
    return Sketches(list(names), h[heads], ab, offsets)


def sketch_fasta(path: str, k: int, scaled: int, moltype: str, hash_dtype=np.uint64) -> Sketches:
    names, seqs = read_fasta(path)
    return sketch(names, [clean(s) for s in seqs], k, scaled, moltype, hash_dtype)


def sourmash_md5(mins: np.ndarray, k: int) -> str:
    text = str(3 * k) + "".join(str(int(m)) for m in mins)
    return hashlib.md5(text.encode()).hexdigest()


class Postings(NamedTuple):
    hashes: np.ndarray  # (N,) uint64 ascending
    tid: np.ndarray  # (N,) int64
    ab: np.ndarray  # (N,) int64


def postings(s: Sketches) -> Postings:
    tid = np.repeat(np.arange(len(s.names), dtype=np.int64), np.diff(s.offsets))
    order = np.argsort(s.mins, kind="stable")
    return Postings(s.mins[order], tid[order], s.abundances[order])


def bucket_table(hashes: np.ndarray) -> Tuple[np.ndarray, int]:
    """(first posting of every bucket, 2^20 + 1 entries; the shift)."""
    top = int(hashes[-1]) if len(hashes) else 0
    shift = max(64 - BUCKET_BITS - (64 - top.bit_length() if top else 0), 32)
    ids = (hashes >> _U64(shift)).astype(np.int64)
    return np.searchsorted(ids, np.arange((1 << BUCKET_BITS) + 1), "left"), shift
