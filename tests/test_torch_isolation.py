"""The port stands alone and runs on the card by default.

* importing every port module (``parallel/`` included), ``chip_smoke``
  and ``profile_torch_main_path`` pulls in neither jax nor any
  ``kmerseek_tpu`` module, and no import statement of theirs, at top
  level or inside a function (``chip_smoke``'s worker mode imports
  there), names one;
* without a CUDA device, entry points given no device raise instead of
  running on the CPU;
* each CUDA wrapper given a CPU tensor takes the plain version and
  counts no launch;
* a kernel library's name changes with every header its source
  includes, so an edited shared header rebuilds it; the shared header
  holds the only copy of the hash and of the encoded staging;
* the build module reads registers, shared memory and spills out of
  what ``nvcc -Xptxas -v`` prints.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import kmerseek_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kmerseek_tpu_torch.__path__, "kmerseek_tpu_torch.")
         if m.name != "kmerseek_tpu_torch.__main__"]
for n in names:
    importlib.import_module(n)
import chip_smoke, profile_torch_main_path, bench_torch_kernels_ab
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "kmerseek_tpu" or m.startswith("kmerseek_tpu."))
missing = [n for n in ("parallel", "parallel.multihost", "parallel.sharded", "parallel.dist")
           if "kmerseek_tpu_torch." + n not in names]
assert not missing, missing
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    n, bad = out.stdout.split(maxsplit=1)
    assert int(n) >= 30 and bad.strip() == "[]"


def _port_sources():
    pkg = os.path.join(REPO, "kmerseek_tpu_torch")
    out = [os.path.join(REPO, n) for n in ("chip_smoke.py", "profile_torch_main_path.py", "bench_torch_kernels_ab.py")]
    for root, _dirs, files in os.walk(pkg):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_import_statement_names_jax_or_the_jax_package():
    """Every ``import`` of the port and its scripts, wherever it stands:
    a lazy import inside a function (an entry point of ``parallel/``,
    ``chip_smoke``'s worker mode) is one the import probe never runs."""
    import ast

    sources = _port_sources()
    assert sum("/parallel/" in p for p in sources) == 4
    bad = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [
                f"{os.path.relpath(path, REPO)}:{node.lineno} {m}" for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "kmerseek_tpu")
            ]
    assert not bad, bad


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from click.testing import CliRunner

    from kmerseek_tpu_torch.cli import cli
    from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
    from kmerseek_tpu_torch.entry import entry

    fasta = tmp_path / "t.fa"
    fasta.write_text(">a\nMKVLAAGIVLLLAAGCSSAAGIVLLLAAGC\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProteomeIndex.build(str(fasta))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProteomeIndex.build(str(fasta), store_raw_sequences=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProteomeIndex.from_arrays(IndexConfig(), ["a"], [1], [1], [0, 1])
    from kmerseek_tpu_torch.core.search import do_manysearch, do_multisearch

    sig = ProteomeIndex.build(str(fasta), device="cpu").to_sig_zip(str(tmp_path / "t.sig.zip"))
    for search in (do_manysearch, do_multisearch):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            search(sig, sig, str(tmp_path / "out.csv"))
        assert not os.path.exists(tmp_path / "out.csv")
    for args in (["index", str(fasta)], ["index", "--extract-kmers", str(fasta)]):
        res = CliRunner().invoke(cli, args)
        assert res.exit_code == 2 and "no CUDA device" in res.output
    assert not os.path.exists(f"{fasta}.hp.k24.scaled5.sig.zip")


def _hash_case(which):
    from kmerseek_tpu_torch.ops import sketch_cuda

    rng = np.random.default_rng(2)
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    seqs = torch.from_numpy(aa[rng.integers(0, 20, size=(4, 256))])
    lens = torch.tensor([0, 10, 200, 256], dtype=torch.int32)
    kw = dict(k=16, scaled=5, moltype="hp")
    wrapper, ref = getattr(sketch_cuda, which), getattr(sketch_cuda, f"{which}_ref")
    return (
        wrapper,
        lambda: wrapper(seqs, lens, **kw),
        lambda: ref(seqs, lens, **kw),
        lambda: wrapper(seqs.to(torch.int32), lens, **kw),
    )


def _sort_case():
    from kmerseek_tpu_torch.ops.sort_cuda import bitonic_sort_rows, bitonic_sort_rows_ref

    keys = torch.from_numpy(np.random.default_rng(3).integers(-(2**63), 2**63 - 1, size=(3, 100)))
    return (
        bitonic_sort_rows,
        lambda: bitonic_sort_rows(keys),
        lambda: bitonic_sort_rows_ref(keys),
        lambda: bitonic_sort_rows(keys.to(torch.int32)),
    )


@pytest.mark.parametrize("which", ["masked_window_keys", "window_hashes", "bitonic_sort_rows"])
def test_wrapper_on_cpu_takes_plain_version(which):
    wrapper, run, run_ref, run_bad = _sort_case() if which == "bitonic_sort_rows" else _hash_case(which)
    before = wrapper.launches
    a, b = run(), run_ref()
    assert wrapper.launches == before
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        assert torch.equal(x, y)
    with pytest.raises(TypeError):
        run_bad()


def test_library_name_follows_included_headers(tmp_path):
    from kmerseek_tpu_torch.ops import cuda_build

    for name in ("masked_sketch.cu", "window_hashes.cu", "bitonic_sort.cu", "murmur64.cuh"):
        shutil.copy(os.path.join(cuda_build.CSRC_DIR, name), tmp_path / name)
    d = str(tmp_path)
    before = {s: cuda_build._library_path(s, d) for s in ("masked_sketch.cu", "window_hashes.cu", "bitonic_sort.cu")}
    assert before["masked_sketch.cu"] == cuda_build._library_path("masked_sketch.cu")
    with open(tmp_path / "murmur64.cuh", "a") as f:
        f.write("// edited\n")
    after = {s: cuda_build._library_path(s, d) for s in before}
    # both users of the shared header get a new name; the sort does not
    assert after["masked_sketch.cu"] != before["masked_sketch.cu"]
    assert after["window_hashes.cu"] != before["window_hashes.cu"]
    assert after["bitonic_sort.cu"] == before["bitonic_sort.cu"]


@pytest.mark.parametrize("source", ["masked_sketch.cu", "window_hashes.cu"])
def test_shared_header_holds_the_only_copy(source):
    """The hash, the LUT encoding and the encoded staging are defined in
    ``murmur64.cuh`` alone; each kernel source calls them and defines no
    copy of its own, and the first design's staging is gone."""
    import re

    from kmerseek_tpu_torch.ops import cuda_build

    def read(name):
        with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
            return f.read()

    header, text = read("murmur64.cuh"), read(source)
    shared = ("stage_encoded", "encode4", "hash_thread_run", "murmur64_run", "murmur64", "fmix64", "run_threads")
    for fn in shared:
        definition = re.compile(rf"^[\w \t:<>&*]*\b{fn}\s*\([^;{{]*\)\s*\{{", re.M)
        assert len(definition.findall(header)) == 1, fn
        assert not definition.search(text), fn
    for call in ("stage_encoded(lut,", "hash_thread_run<K>(s_seq, k, seed, h)", "run_threads(W)"):
        assert call in text, call
    assert '#include "murmur64.cuh"' in text
    for gone in ("stage_encoded_tile", "kTile", "ByteLut", "lut_host"):
        assert gone not in header and gone not in text, gone


def test_ptxas_report_is_parsed():
    from kmerseek_tpu_torch.ops import cuda_build

    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN1a4sortILi5ELb1EEEvPKy' for 'sm_90a'
ptxas info    : Function properties for _ZN1a4sortILi5ELb1EEEvPKy
    24 bytes stack frame, 20 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 1488 bytes smem, 416 bytes cmem[0]
ptxas info    : Compiling entry function 'plain' for 'sm_90a'
ptxas info    : Function properties for plain
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, 380 bytes cmem[0]
"""
    assert cuda_build.parse_ptxas(text) == [
        {"kernel": "_ZN1a4sortILi5ELb1EEEvPKy", "stack_bytes": 24, "spill_store_bytes": 20,
         "spill_load_bytes": 36, "registers": 64, "smem_bytes": 1488},
        {"kernel": "plain", "stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
         "registers": 16, "smem_bytes": 0},
    ]
    short = cuda_build._short_name
    assert short("void <unnamed>::sort_tile_kernel<(int)5, (bool)1>(const unsigned long long *, int)") == "sort_tile_kernel<5, 1>"
    assert short("(anonymous namespace)::window_hashes_kernel(unsigned char const*, int)") == "window_hashes_kernel"
    assert "-Xptxas" in cuda_build.NVCC_FLAGS
