"""Build and load the package's CUDA sources at first use.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers: a build takes seconds). Libraries land in ``_build/`` inside
the package, named by the hash of the source, of every header it
includes from ``csrc/`` (``#include "x.cuh"``, followed recursively)
and of the flags, so an edited source or shared header rebuilds every
library that uses it and an unchanged one loads at once. ``-Xptxas -v``
is among the flags: what ptxas reports for each kernel (registers,
shared memory, spills) is kept beside the library and read back by
``resource_usage``. Nothing is built or loaded when a module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List

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
    "-Xptxas",
    "-v",
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


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _library_path(source: str, csrc_dir: str = CSRC_DIR) -> str:
    """``_build/lib<stem>-<digest>.so``: the digest covers ``source``, the
    local headers it includes (transitively) and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    seen, todo = set(), [source]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        with open(os.path.join(csrc_dir, name), "rb") as f:
            text = f.read()
        h.update(name.encode() + b"\0" + text)
        todo.extend(
            inc.decode() for inc in _LOCAL_INCLUDE.findall(text)
            if os.path.exists(os.path.join(csrc_dir, inc.decode()))
        )
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


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
    with open(f"{tmp}.txt", "w") as f:
        f.write(proc.stderr)
    os.replace(f"{tmp}.txt", f"{lib}.ptxas.txt")
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


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?, (\d+) bytes smem)?")


def _short_name(demangled: str) -> str:
    """``void <unnamed>::f<(int)5, (bool)1>(args...)`` → ``f<5, 1>``."""
    name = demangled.removeprefix("void ")
    name = name.replace("<unnamed>::", "").replace("(anonymous namespace)::", "")
    name = re.sub(r"\((?:int|bool)\)", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def parse_ptxas(text: str) -> List[dict]:
    """``nvcc -Xptxas -v`` output → one ``{"kernel" (mangled),
    "registers", "smem_bytes" (static), "stack_bytes",
    "spill_store_bytes", "spill_load_bytes"}`` per kernel."""
    out, cur = [], None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            cur = {"kernel": m.group(1)}
        elif cur is not None and (m := _SPILL.search(line)):
            cur.update(zip(("stack_bytes", "spill_store_bytes", "spill_load_bytes"), map(int, m.groups())))
        elif cur is not None and (m := _USED.search(line)):
            cur["registers"] = int(m.group(1))
            cur["smem_bytes"] = int(m.group(2) or 0)
            out.append(cur)
            cur = None
    return out


def resource_usage(source: str) -> List[dict]:
    """What ptxas reported for each kernel of ``csrc/<source>`` when it
    was built (``parse_ptxas``), the kernels' names demangled and
    shortened where ``cu++filt`` is at hand."""
    with open(f"{_compile(source)}.ptxas.txt") as f:
        out = parse_ptxas(f.read())
    filt = shutil.which("cu++filt") or os.path.join(os.path.dirname(find_nvcc()), "cu++filt")
    if out and os.path.exists(filt):
        names = subprocess.run(
            [filt, *(k["kernel"] for k in out)], capture_output=True, text=True
        ).stdout.splitlines()
        if len(names) == len(out):
            for k, name in zip(out, names):
                k["kernel"] = _short_name(name)
    return out


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
