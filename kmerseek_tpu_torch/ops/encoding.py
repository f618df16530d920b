"""Amino-acid alphabets, reduced encodings, and validation tables
(counterpart of ``kmerseek_tpu/ops/encoding.py``, copied).

All encodings are 256-entry byte lookup tables: one gather on the
host, one table read per byte in the CUDA kernel.

* moltype dispatch ``protein|dayhoff|hp``; Dayhoff 6-class encoding
  (lowercase a-f, unknown→'x') and HP 2-class encoding (h/p,
  unknown→'x'), matching sourmash's ``aa_to_dayhoff`` / ``aa_to_hp``.
* Valid residues: 20 standard AAs + specials ``X U O *`` + ambiguity
  codes ``B Z J``; ambiguity resolves deterministically to the first
  candidate (B→D, Z→E, J→I).
* ``max_hash_for_scaled`` keeps sourmash's f64 rounding.
"""

from __future__ import annotations

import numpy as np

STANDARD_AA = "ACDEFGHIKLMNPQRSTVWY"
SPECIAL_AA = "XUO*"
AMBIGUOUS_AA = "BZJ"

AMBIGUITY_FIRST = {"B": "D", "Z": "E", "J": "I"}
AMBIGUITY_CHOICES = {"B": "DN", "Z": "EQ", "J": "IL"}

_DAYHOFF_CLASSES = {
    "a": "C",
    "b": "AGPST",
    "c": "DENQ",
    "d": "HKR",
    "e": "ILMV",
    "f": "FWY",
}
_HP_CLASSES = {
    "h": "AFGILMPVWY",
    "p": "CDEHKNQRST",
}


def _build_moltype_lut(classes: dict) -> np.ndarray:
    """256-entry LUT applying sourmash-style uppercase-then-map, unknown→'x'."""
    lut = np.full(256, ord("x"), dtype=np.uint8)
    for out, members in classes.items():
        for ch in members:
            lut[ord(ch)] = ord(out)
            lut[ord(ch.lower())] = ord(out)
    return lut


DAYHOFF_LUT = _build_moltype_lut(_DAYHOFF_CLASSES)
HP_LUT = _build_moltype_lut(_HP_CLASSES)
IDENTITY_LUT = np.arange(256, dtype=np.uint8)

ENCODING_LUTS = {
    "protein": IDENTITY_LUT,
    "dayhoff": DAYHOFF_LUT,
    "hp": HP_LUT,
}

# Uppercasing LUT (ASCII only).
UPPER_LUT = np.arange(256, dtype=np.uint8)
for _c in range(ord("a"), ord("z") + 1):
    UPPER_LUT[_c] = _c - 32

# Validity of an *uppercased* residue byte.
VALID_LUT = np.zeros(256, dtype=np.bool_)
for _ch in STANDARD_AA + SPECIAL_AA + AMBIGUOUS_AA:
    VALID_LUT[ord(_ch)] = True

# Ambiguity-resolution LUT (deterministic policy).
RESOLVE_FIRST_LUT = np.arange(256, dtype=np.uint8)
for _amb, _res in AMBIGUITY_FIRST.items():
    RESOLVE_FIRST_LUT[ord(_amb)] = ord(_res)


def get_encoding_lut(moltype: str) -> np.ndarray:
    """moltype → 256-byte encoding LUT."""
    try:
        return ENCODING_LUTS[moltype if moltype != "raw" else "protein"]
    except KeyError:
        raise ValueError(
            f"Invalid moltype: {moltype}, only 'protein', 'hp', or 'dayhoff' "
            "are supported"
        ) from None


def encode_bytes_np(seq: np.ndarray, moltype: str) -> np.ndarray:
    """Vectorized host encoding of a uint8 byte array."""
    return get_encoding_lut(moltype)[np.asarray(seq, dtype=np.uint8)]


def max_hash_for_scaled(scaled: int) -> int:
    """FracMinHash keep-threshold, with sourmash's f64 rounding.

    sourmash computes ``(u64::MAX as f64 / scaled) as u64``; the division
    happens in f64, so scaled=5 gives 3689348814741910528 rather than
    the integer 2^64/5. scaled=1 saturates to u64::MAX.
    """
    if scaled <= 0:
        raise ValueError(f"scaled must be positive, got {scaled}")
    v = int(float(2**64) / scaled)  # Python float == f64
    return min(v, 2**64 - 1)
