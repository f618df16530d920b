"""``python -m kmerseek_tpu_torch index|search --device cpu`` against
``kmerseek_tpu.cli`` with ``--engine device``: CSV and ``.sig.zip``
bytes are equal."""

import os
import shutil

import pytest
from click.testing import CliRunner

from kmerseek_tpu.cli import cli as jax_cli
from kmerseek_tpu_torch.cli import cli as torch_cli
from tests.test_torch_index import write_fasta


@pytest.fixture
def corpus(tmp_path):
    write_fasta(str(tmp_path / "t.fa"), n=30, seed=11, max_len=400)
    with open(tmp_path / "t.fa") as src, open(tmp_path / "q.fa", "w") as dst:
        dst.write("".join(src.readlines()[:40]))  # the first records, as queries
    return tmp_path


def _run(cli, args):
    res = CliRunner().invoke(cli, args, catch_exceptions=False)
    assert res.exit_code == 0, res.output
    return res


def test_index_search_match_jax_cli(corpus):
    t, q = str(corpus / "t.fa"), str(corpus / "q.fa")
    sig = f"{t}.hp.k24.scaled5.sig.zip"
    outs, sigs = {}, {}
    for name, cli, extra in [
        ("jax", jax_cli, ["--engine", "device"]),
        ("torch", torch_cli, ["--device", "cpu"]),
    ]:
        _run(cli, ["index", t, "--force", *extra])
        assert os.path.isdir(f"{sig}.ksx")
        sigs[name] = open(sig, "rb").read()
        out = str(corpus / f"{name}.csv")
        # search loads the target .ksx written by `index`
        _run(cli, ["search", q, t, "--output", out, *extra])
        outs[name] = open(out).read()
        os.remove(f"{q}.hp.k24.scaled5.sig.zip")
        shutil.rmtree(f"{sig}.ksx")
    assert sigs["torch"] == sigs["jax"]
    assert outs["torch"] == outs["jax"]
    assert outs["torch"].count("\n") > 10


def test_search_loads_jax_written_ksx(corpus):
    t, q = str(corpus / "t.fa"), str(corpus / "q.fa")
    _run(jax_cli, ["index", t, "--ksize", "16", "--engine", "device"])
    a, b = str(corpus / "a.csv"), str(corpus / "b.csv")
    _run(torch_cli, ["search", q, t, "--ksize", "16", "--device", "cpu", "--output", a])
    _run(jax_cli, ["search", q, t, "--ksize", "16", "--engine", "device", "--output", b])
    assert open(a).read() == open(b).read()


@pytest.mark.parametrize(
    "args",
    [
        ["index", "X", "--engine", "native"],
        ["index", "X", "--extract-kmers"],
        ["index", "X", "--profile", "p"],
        ["search", "X", "Y", "--extract-kmers"],
        ["search", "X", "Y", "--annotate-domains", "d.xml"],
    ],
)
def test_unported_flags_refuse(args):
    res = CliRunner().invoke(torch_cli, args + ["--device", "cpu"])
    assert res.exit_code == 2 and "not yet ported" in res.output
