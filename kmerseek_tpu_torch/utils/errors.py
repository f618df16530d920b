"""Typed error hierarchy (counterpart of ``kmerseek_tpu/utils/errors.py``).

``InvalidAminoAcid`` (char + 1-based position) is re-exported from
``core.alphabet``; ``NoSavedState`` is raised by ``ProteomeIndex.load``.
The JAX package's ``FastaError``, ``ConfigurationError`` and
``with_context`` have no user in the port yet.
"""

from __future__ import annotations

from ..core.alphabet import InvalidAminoAcid  # noqa: F401  (re-export)


class KmerseekError(Exception):
    """Base for all framework errors."""


class StorageError(KmerseekError):
    """Index persistence failure (Database/Serialization variants)."""


class NoSavedState(StorageError):
    """No saved index found at the given path."""
