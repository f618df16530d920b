"""ctypes bindings for the package's C++ host runtime, ``libkseek``
(counterpart of ``kmerseek_tpu/native``; ``fastio.cc`` here is the
port's own copy of the source).

The library provides the host pieces that kmerseek implements in Rust:
the FASTA parser, the multithreaded CPU sketcher (``--engine native``),
a stable multithreaded u64 argsort (the host posting build), the
search CSV's body from typed columns (``format_csv``) and the decimal
text of u64 arrays (``decimal_u64``, the sourmash md5s' input).

It is compiled with the C++ compiler (``$CXX``, else ``g++``, ``c++``
or ``clang++``) at first use into ``kmerseek_tpu_torch/_build/``. The
library's name holds a hash of the source, the flags, the compiler and
the host CPU's model and flags: the flags include ``-march=native``, so
a library built for one machine is never loaded on another. The compile
writes a temporary file that is ``os.replace``d into place, so processes
that build at the same time never load half a file. Nothing is built
when the module is imported.

* ``available()`` is False only when no C++ compiler is found. A
  compiler that is present and fails raises, with its stderr.
* ``NativeUnsupported`` means an input the native path does not take
  (stdin, or more keys than the argsort's u32 index range), and nothing
  else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PACKAGE_DIR, "native", "fastio.cc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds this process spent compiling the library (0.0 when it was found
# built) and loading it, once loaded
build_seconds: Optional[float] = None
load_seconds: Optional[float] = None


class NativeUnsupported(RuntimeError):
    """Input not handled by the native path (the caller reads it another way)."""


def find_compiler() -> Optional[str]:
    """The C++ compiler the library is built with, or None."""
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    return None


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: the first processor's model
    and feature lines of ``/proc/cpuinfo``."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    first = {}
    for line in lines:
        key = line.split(b":", 1)[0].strip()
        if key in (b"model name", b"flags", b"Features", b"CPU part"):
            first.setdefault(key, line)
    return b"\n".join(first[k] for k in sorted(first))


def library_path(cxx: str, source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """``_build/libkseek-<digest>.so`` for ``source`` built by ``cxx``
    on this host."""
    h = hashlib.sha256()
    for part in (" ".join(CXX_FLAGS).encode(), cxx.encode(), _host_cpu()):
        h.update(part + b"\0")
    with open(source, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir, f"libkseek-{h.hexdigest()[:16]}.so")


def compile_library(cxx: str, source: str, out: str) -> float:
    """Compile ``source`` into the shared library ``out``; returns the
    seconds it took. Raises with the compiler's stderr when it fails."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp-{os.getpid()}-{threading.get_ident()}"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", tmp, source], capture_output=True, text=True, timeout=600
    )
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"{os.path.basename(cxx)} failed on {source} (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent builder never sees half a file
    return time.perf_counter() - t0


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None without a compiler."""
    global _lib, build_seconds, load_seconds
    with _lock:
        if _lib is not None:
            return _lib
        cxx = find_compiler()
        if cxx is None:
            return None
        t0 = time.perf_counter()
        path = library_path(cxx, SOURCE, BUILD_DIR)
        built = compile_library(cxx, SOURCE, path) if not os.path.exists(path) else 0.0
        lib = ctypes.CDLL(path)
        _configure(lib)
        build_seconds, load_seconds = built, time.perf_counter() - t0 - built
        _lib = lib
        return lib


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "no C++ compiler found: the native host library builds only where "
            "g++ (or $CXX) is installed"
        )
    return lib


def _configure(lib: ctypes.CDLL) -> None:
    lib.ks_parse_fasta.restype = ctypes.c_void_p
    lib.ks_parse_fasta.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ks_result_n_records.restype = ctypes.c_int64
    lib.ks_result_n_records.argtypes = [ctypes.c_void_p]
    lib.ks_result_error.restype = ctypes.c_char_p
    lib.ks_result_error.argtypes = [ctypes.c_void_p]
    lib.ks_result_name.restype = ctypes.c_char_p
    lib.ks_result_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ks_result_seq.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.ks_result_seq.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ks_result_seq_len.restype = ctypes.c_int64
    lib.ks_result_seq_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ks_result_free.restype = None
    lib.ks_result_free.argtypes = [ctypes.c_void_p]
    lib.ks_sketch_cpu.restype = ctypes.c_int64
    lib.ks_sketch_cpu.argtypes = [
        ctypes.c_char_p,  # encoded bytes
        ctypes.c_int64,  # length
        ctypes.c_int32,  # k
        ctypes.c_uint64,  # max_hash
        ctypes.POINTER(ctypes.c_uint64),  # out hashes (capacity W)
        ctypes.POINTER(ctypes.c_uint32),  # out abundances
    ]
    lib.ks_sketch_cpu_batch.restype = ctypes.c_double
    lib.ks_sketch_cpu_batch.argtypes = [
        ctypes.c_char_p,  # concatenated encoded bytes
        ctypes.POINTER(ctypes.c_int64),  # offsets (n+1)
        ctypes.c_int64,  # n sequences
        ctypes.c_int32,  # k
        ctypes.c_uint64,  # max_hash
        ctypes.c_int32,  # n_threads
        ctypes.POINTER(ctypes.c_int64),  # out: total kmers hashed
    ]
    lib.ks_argsort_u64.restype = ctypes.c_int32
    lib.ks_argsort_u64.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),  # keys
        ctypes.c_int64,  # n
        ctypes.POINTER(ctypes.c_int64),  # out order
        ctypes.c_int32,  # n_threads
    ]
    lib.ks_format_csv.restype = ctypes.c_int64
    lib.ks_format_csv.argtypes = [
        ctypes.c_int64,  # n_rows
        ctypes.c_int32,  # n_cols
        ctypes.POINTER(ctypes.c_int32),  # kind of each column
        ctypes.POINTER(ctypes.c_void_p),  # data of each column
        ctypes.POINTER(ctypes.c_void_p),  # text offsets of each column (n_rows + 1), else null
        ctypes.c_void_p,  # out
        ctypes.c_int64,  # capacity of out
    ]
    lib.ks_decimal_u64.restype = ctypes.c_int64
    lib.ks_decimal_u64.argtypes = [
        ctypes.c_void_p,  # values
        ctypes.c_int64,  # n
        ctypes.c_void_p,  # out, 20 bytes a value
        ctypes.c_void_p,  # end of each value's text
    ]


def available() -> bool:
    """True when the library is loaded or can be built (a C++ compiler
    is found); builds and loads it on the first call."""
    return _load() is not None


def library_file() -> str:
    """Path of the loaded library (built first if needed)."""
    return _require()._name


def parse_fasta(path: str) -> List[Tuple[str, bytes]]:
    """Parse a FASTA file (any compression ``core.fasta`` detects) with
    the C++ parser: ``[(name, sequence), ...]``."""
    if path == "-":
        raise NativeUnsupported("stdin is read by the Python parser")
    lib = _require()
    from ..core.fasta import _decompress_bytes, _detect_compression

    with open(path, "rb") as f:
        raw = f.read()
    data = _decompress_bytes(raw, _detect_compression(raw[:8]))
    res = lib.ks_parse_fasta(data, len(data))
    if not res:
        raise NativeUnsupported("native parser returned null")
    try:
        err = lib.ks_result_error(res)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        out = []
        for i in range(lib.ks_result_n_records(res)):
            name = lib.ks_result_name(res, i).decode("utf-8")
            out.append((name, ctypes.string_at(lib.ks_result_seq(res, i), lib.ks_result_seq_len(res, i))))
        return out
    finally:
        lib.ks_result_free(res)


def sketch_cpu(encoded: bytes, k: int, max_hash: int):
    """Single-sequence CPU sketch: (sorted unique uint64 hashes <=
    ``max_hash``, uint32 abundances)."""
    import numpy as np

    lib = _require()
    w = max(len(encoded) - k + 1, 0)
    if w == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    out_h = np.zeros(w, np.uint64)
    out_a = np.zeros(w, np.uint32)
    n = lib.ks_sketch_cpu(
        encoded,
        len(encoded),
        k,
        max_hash,
        out_h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out_h[:n], out_a[:n]


def argsort_u64(keys, n_threads=None):
    """Stable multithreaded argsort of a uint64 array, equal to
    ``np.argsort(keys, kind="stable")``. Raises ``NativeUnsupported``
    beyond the u32 index range."""
    import numpy as np

    lib = _require()
    if n_threads is None:
        from ..utils.config import get_default_performance_config

        n_threads = get_default_performance_config().effective_thread_count
    k = np.ascontiguousarray(keys, dtype=np.uint64)
    out = np.empty(len(k), np.int64)
    rc = lib.ks_argsort_u64(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(k),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(n_threads),
    )
    if rc != 0:
        raise NativeUnsupported("input exceeds native argsort index range")
    return out


def sketch_cpu_batch_throughput(
    encoded_concat: bytes, offsets, k: int, max_hash: int, n_threads=None
):
    """Multithreaded CPU sketch of a whole corpus, sketches discarded;
    returns (seconds, windows hashed). ``n_threads`` defaults to the
    process-wide PerformanceConfig's effective thread count."""
    import numpy as np

    if n_threads is None:
        from ..utils.config import get_default_performance_config

        n_threads = get_default_performance_config().effective_thread_count
    lib = _require()
    offs = np.asarray(offsets, dtype=np.int64)
    total = ctypes.c_int64(0)
    secs = lib.ks_sketch_cpu_batch(
        encoded_concat,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(offs) - 1,
        k,
        max_hash,
        n_threads,
        ctypes.byref(total),
    )
    return secs, total.value


# ks_format_csv's column kinds and the longest cell of each numeric kind
_CSV_FLOAT64, _CSV_INT64, _CSV_TEXT = 0, 1, 2
_CSV_CELL_MAX = {_CSV_FLOAT64: 24, _CSV_INT64: 20}


def format_csv(columns, n_rows: int) -> str:
    """The body of a CSV: ``n_rows`` lines, each row's cells joined by
    ``,`` and ended by a newline. Each column is a float64 array (each
    value as ``repr`` writes it), an int64 array (as ``str``), or a list
    of ``str`` cells written as they are: quoting is the caller's."""
    import numpy as np

    lib = _require()
    n_cols = len(columns)
    kinds = (ctypes.c_int32 * n_cols)()
    data = (ctypes.c_void_p * n_cols)()
    offsets = (ctypes.c_void_p * n_cols)()
    keep = []  # every buffer the call reads, alive until it returns
    cap = n_rows * n_cols
    for c, col in enumerate(columns):
        if len(col) != n_rows:
            raise ValueError(f"column {c} has {len(col)} cells, not {n_rows}")
        if isinstance(col, np.ndarray):
            if col.dtype not in (np.float64, np.int64):
                raise TypeError(f"column {c} is {col.dtype}, not float64 or int64")
            kind = _CSV_FLOAT64 if col.dtype == np.float64 else _CSV_INT64
            arr = np.ascontiguousarray(col)
            cap += n_rows * _CSV_CELL_MAX[kind]
            data[c] = arr.ctypes.data
            keep.append(arr)
        else:
            kind = _CSV_TEXT
            joined = "".join(col)
            if joined.isascii():
                buf = joined.encode("ascii")
                lens = np.fromiter(map(len, col), np.int64, n_rows)
            else:
                cells = [s.encode("utf-8", "surrogatepass") for s in col]
                buf = b"".join(cells)
                lens = np.fromiter(map(len, cells), np.int64, n_rows)
            off = np.zeros(n_rows + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            cap += len(buf)
            data[c] = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p)
            offsets[c] = off.ctypes.data
            keep += [buf, off]
        kinds[c] = kind
    out = np.empty(max(cap, 1), np.uint8)
    n = lib.ks_format_csv(n_rows, n_cols, kinds, data, offsets, out.ctypes.data, len(out))
    if n < 0:
        raise RuntimeError("ks_format_csv: output bound exceeded")
    return str(memoryview(out)[:n], "utf-8", "surrogatepass")


def decimal_u64(values):
    """The decimal text of every value of the uint64 array ``values``, back
    to back (the bytes of ``"".join(map(str, values.tolist()))``), as a
    uint8 array, and the end of each value's text in it (int64)."""
    import numpy as np

    lib = _require()
    arr = np.ascontiguousarray(values, np.uint64)
    out = np.empty(max(20 * len(arr), 1), np.uint8)
    ends = np.empty(len(arr), np.int64)
    n = lib.ks_decimal_u64(arr.ctypes.data, len(arr), out.ctypes.data, ends.ctypes.data)
    return out[:n], ends
