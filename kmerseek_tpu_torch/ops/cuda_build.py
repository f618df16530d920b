"""Build and load the package's CUDA sources at first use.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers: a build takes seconds). Libraries land in ``_build/`` inside
the package, named by the source's content hash, so an edited source
rebuilds and an unchanged one loads at once. Nothing is built or
loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# seconds spent compiling each source in this process (0 when cached)
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _library_path(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def _compile(source: str) -> str:
    lib = _library_path(source)
    if os.path.exists(lib):
        build_seconds.setdefault(source, 0.0)
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp-{os.getpid()}-{threading.get_ident()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent builder never sees half a file
    build_seconds[source] = time.perf_counter() - t0
    return lib


def build_all(sources: Iterable[str]) -> Dict[str, float]:
    """Compile every source in parallel (one ``nvcc`` each); returns the
    per-source compile seconds (0 for a cached library)."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        for fut in [pool.submit(_compile, s) for s in sources]:
            fut.result()
    return {s: build_seconds[s] for s in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, building it if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(_compile(source))
            lib.kmerseek_cuda_error_string.argtypes = [ctypes.c_int]
            lib.kmerseek_cuda_error_string.restype = ctypes.c_char_p
            _loaded[source] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.kmerseek_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
