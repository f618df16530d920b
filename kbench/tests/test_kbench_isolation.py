"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's);
the reference imports nothing of the port; the entry refuses to run
without a card."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

from kbench import harness

KBENCH = os.path.join(ROOT, "kbench")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(KBENCH, sub)):
        if "tests" in d.split(os.sep):
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = set(_imports(path))
        assert "kmerseek_tpu_torch" not in names and "torch" not in names, path


def test_runtime_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kmerseek_tpu_torch_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kmerseek_tpu.core", sys)
    assert harness.forbidden_modules() == ["kmerseek_tpu"]


def _entry(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "kbench/run.py", "--workload", "hp24-search-b128",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_entry_refuses_without_a_card():
    p = _entry(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr


@pytest.mark.parametrize("what", ["only the benchmark"])
def test_entry_fails_without_the_program(tmp_path, what):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(KBENCH, tmp_path / "kbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = _entry(str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""
