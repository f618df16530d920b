"""The port stands alone and runs on the card by default.

* importing every port module, ``chip_smoke`` and
  ``profile_torch_main_path`` pulls in neither jax
  nor any ``kmerseek_tpu`` module;
* without a CUDA device, entry points given no device raise instead of
  running on the CPU;
* the CUDA wrapper given a CPU tensor takes the plain version and
  counts no launch.
"""

import os
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
import chip_smoke, profile_torch_main_path
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "kmerseek_tpu" or m.startswith("kmerseek_tpu."))
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
    assert int(n) >= 15 and bad.strip() == "[]"


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from click.testing import CliRunner

    from kmerseek_tpu_torch.cli import cli
    from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex

    fasta = tmp_path / "t.fa"
    fasta.write_text(">a\nMKVLAAGIVLLLAAGCSSAAGIVLLLAAGC\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProteomeIndex.build(str(fasta))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProteomeIndex.from_arrays(IndexConfig(), ["a"], [1], [1], [0, 1])
    res = CliRunner().invoke(cli, ["index", str(fasta)])
    assert res.exit_code == 2 and "no CUDA device" in res.output
    assert not os.path.exists(f"{fasta}.hp.k24.scaled5.sig.zip")


def test_wrapper_on_cpu_takes_plain_version():
    from kmerseek_tpu_torch.ops.sketch_cuda import masked_window_keys, masked_window_keys_ref

    rng = np.random.default_rng(2)
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    seqs = torch.from_numpy(aa[rng.integers(0, 20, size=(4, 256))])
    lens = torch.tensor([0, 10, 200, 256], dtype=torch.int32)
    before = masked_window_keys.launches
    a = masked_window_keys(seqs, lens, k=16, scaled=5, moltype="hp")
    b = masked_window_keys_ref(seqs, lens, k=16, scaled=5, moltype="hp")
    assert masked_window_keys.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(TypeError):
        masked_window_keys(seqs.to(torch.int32), lens, k=16, scaled=5, moltype="hp")
