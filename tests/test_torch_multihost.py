"""The port's ``parallel.multihost`` against the JAX package's, function by
function, on seeded FASTA files: the round-robin split, the hash ranges,
the pack → merge exchange simulated for 1, 2, 3 and 5 processes (an empty
shard and a missing ordinal included), the local sketch stage and the
single-process build. Tolerance 0: ``==`` and ``np.array_equal``.
(The exchange under a real process group: ``test_torch_multihost_real.py``.)
"""

import numpy as np
import pytest
import torch

import kmerseek_tpu.parallel.multihost as jmh
from kmerseek_tpu.core.index import IndexConfig as JCfg
from kmerseek_tpu.core.index import ProteomeIndex as JIdx
from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
from kmerseek_tpu_torch.parallel import multihost as tmh
from test_torch_multisearch import _write_corpus

CFG = (16, 5, "hp")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tdir = tmp_path_factory.mktemp("multihost")
    tfa, _qfa = _write_corpus(tdir, seed=41, n_targets=23, n_queries=4)
    port = ProteomeIndex.build(tfa, IndexConfig(*CFG), device="cpu")
    ref = JIdx.build(tfa, JCfg(*CFG))
    return tfa, port, ref


def _same_index(a, b):
    assert a.names == b.names
    for member in ("mins", "abundances", "offsets"):
        x, y = getattr(a, member), getattr(b, member)
        assert x.dtype == y.dtype and np.array_equal(x, y), member


def _same_payload(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _split(sigs, n_procs):
    ords = [[i for i in range(len(sigs)) if tmh.host_owns_record(i, p, n_procs)] for p in range(n_procs)]
    return ords, [[sigs[i] for i in o] for o in ords]


@pytest.mark.parametrize("n_procs", [1, 2, 3, 5])
def test_round_robin_and_hash_ranges_match_jax(n_procs):
    rng = np.random.default_rng(n_procs)
    for i in range(40):
        for p in range(n_procs):
            assert tmh.host_owns_record(i, p, n_procs) == jmh.host_owns_record(i, p, n_procs)
    for span in (1 << 64, 2**64 // 5 + 1, 1000, n_procs):
        ranges = [tmh.hash_range_for_shard(d, n_procs, span) for d in range(n_procs)]
        assert ranges == [jmh.hash_range_for_shard(d, n_procs, span) for d in range(n_procs)]
        assert ranges[0][0] == 0 and ranges[-1][1] == span
        # every range edge and its neighbours, values on both sides of 2^63
        edges = np.array([e for lo, hi in ranges for e in (lo, max(hi - 1, 0))], dtype=object)
        mins = np.concatenate([
            np.array([int(e) % (1 << 64) for e in edges], np.uint64),
            rng.integers(0, min(span, 2**64 - 1), size=200, dtype=np.uint64),
        ])
        got = tmh.shard_of_hash(mins, n_procs, span)
        assert np.array_equal(got, jmh.shard_of_hash(mins, n_procs, span))
        for h, d in zip(mins.tolist(), got.tolist()):
            assert ranges[d][0] <= h < ranges[d][1] or h >= span


def test_shard_of_hash_orders_unsigned():
    """Hashes at and above 2^63 go to the upper shards: the bounds are
    searched as uint64, never as int64."""
    mins = np.array([0, 2**62, 2**63 - 1, 2**63, 2**64 - 1], np.uint64)
    assert tmh.shard_of_hash(mins, 4).tolist() == [0, 1, 1, 2, 3]
    assert tmh.shard_of_hash(mins, 4).tolist() == jmh.shard_of_hash(mins, 4).tolist()


@pytest.mark.parametrize("n_procs", [1, 2, 3, 5])
def test_iter_host_shard_batches_matches_jax(corpus, n_procs):
    tfa = corpus[0]
    seen = []
    for p in range(n_procs):
        got = list(tmh.iter_host_shard_batches(tfa, p, n_procs, batch_size=4))
        want = list(jmh.iter_host_shard_batches(tfa, p, n_procs, batch_size=4))
        assert [[(o, r.name, r.seq) for o, r in b] for b in got] == [
            [(o, r.name, r.seq) for o, r in b] for b in want
        ]
        assert all(len(b) <= 4 for b in got)
        seen += [o for b in got for o, _r in b]
    assert sorted(seen) == list(range(23))


@pytest.mark.parametrize("n_procs", [1, 2, 3, 5])
def test_pack_and_merge_match_jax_and_the_single_build(corpus, n_procs):
    _tfa, port, ref = corpus
    ords, shards = _split(port.signatures(), n_procs)
    _jords, jshards = _split(ref.signatures(), n_procs)
    payloads = [tmh.pack_local_shard(o, s) for o, s in zip(ords, shards)]
    for p, o, js in zip(payloads, ords, jshards):
        _same_payload(p, jmh.pack_local_shard(o, js))
    # merged in arbitrary payload order: the global record order again
    merged = tmh.merge_shards(payloads[::-1], IndexConfig(*CFG), source_fasta="x.fa", device="cpu")
    _same_index(merged, port)
    _same_index(merged, jmh.merge_shards(payloads, JCfg(*CFG)))
    assert merged.source_fasta == "x.fa" and merged.device.type == "cpu"
    assert merged.signature(0).filename == "x.fa"


def test_empty_shards_pack_and_merge(corpus):
    """Five processes, three records: two processes own nothing."""
    _tfa, port, ref = corpus
    sigs = port.signatures()[:3]
    ords, shards = _split(sigs, 5)
    assert ords[3] == [] and ords[4] == []
    payloads = [tmh.pack_local_shard(o, s) for o, s in zip(ords, shards)]
    _same_payload(payloads[4], jmh.pack_local_shard([], []))
    assert len(payloads[4]["mins"]) == 0 and payloads[4]["mins"].dtype == np.uint64
    merged = tmh.merge_shards(payloads, IndexConfig(*CFG), device="cpu")
    assert merged.names == port.names[:3]
    assert np.array_equal(merged.mins, port.mins[: port.offsets[3]])
    assert np.array_equal(merged.offsets, port.offsets[:4])


@pytest.mark.parametrize("case", ["missing", "duplicated"])
def test_merge_detects_a_missing_or_duplicated_shard(corpus, case):
    _tfa, port, ref = corpus
    ords, shards = _split(port.signatures(), 3)
    payloads = [tmh.pack_local_shard(o, s) for o, s in zip(ords, shards)]
    bad = payloads[:2] if case == "missing" else payloads + payloads[:1]
    with pytest.raises(RuntimeError, match="missing or duplicated"):
        tmh.merge_shards(bad, IndexConfig(*CFG), device="cpu")
    with pytest.raises(RuntimeError, match="missing or duplicated"):
        jmh.merge_shards(bad, JCfg(*CFG))


@pytest.mark.parametrize("n_procs", [1, 2, 3])
def test_sketch_local_shard_matches_jax(corpus, n_procs):
    tfa = corpus[0]
    for p in range(n_procs):
        ords, sigs = tmh.sketch_local_shard(tfa, IndexConfig(*CFG), p, n_procs, batch_size=5, device="cpu")
        jords, jsigs = jmh.sketch_local_shard(tfa, JCfg(*CFG), p, n_procs, batch_size=5)
        assert ords == jords == list(range(p, 23, n_procs))
        for a, b in zip(sigs, jsigs):
            assert (a.name, a.ksize, a.scaled, a.moltype, a.filename) == (
                b.name, b.ksize, b.scaled, b.moltype, b.filename)
            assert np.array_equal(a.mins, b.mins) and np.array_equal(a.abundances, b.abundances)
            assert a.md5sum == b.md5sum


def test_single_process_build_distributed_is_the_plain_build(corpus, monkeypatch):
    tfa, port, ref = corpus
    for v in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    assert tmh.initialize_distributed() == (0, 1)
    before = dict(tmh.exchange_stats)
    for built in (
        ProteomeIndex.build_distributed(tfa, IndexConfig(*CFG), device="cpu"),
        tmh.build_distributed_index(tfa, IndexConfig(*CFG), batch_size=6, device="cpu"),
    ):
        _same_index(built, port)
        _same_index(built, JIdx.build_distributed(tfa, JCfg(*CFG)))
        assert built.source_fasta == tfa
    assert tmh.exchange_stats == before  # one process: no exchange


def test_allgather_of_one_process_touches_no_group():
    local = {"mins": np.array([1, 2**64 - 1], np.uint64), "tid": np.zeros(0, np.int64)}
    out = tmh._allgather_payloads(local)
    assert len(out) == 1 and out[0] is local


def test_rank_device_and_defaults_ask_for_the_card(corpus):
    assert tmh.rank_device("cpu", 3) == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmh.rank_device(None, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmh.build_distributed_index(corpus[0], IndexConfig(*CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProteomeIndex.build_distributed(corpus[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmh.sketch_local_shard(corpus[0], IndexConfig(*CFG), 0, 1)


@pytest.mark.parametrize("module", ["multihost", "sharded", "dist"])
def test_every_public_name_has_a_counterpart(module):
    """Each public function and class that a JAX ``parallel`` module
    defines exists under the same name in the port's module."""
    import importlib
    import inspect

    ref = importlib.import_module(f"kmerseek_tpu.parallel.{module}")
    port = importlib.import_module(f"kmerseek_tpu_torch.parallel.{module}")
    names = [
        n for n, obj in vars(ref).items()
        if not n.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
        and obj.__module__ == ref.__name__
    ]
    assert len(names) >= 8
    missing = [n for n in names if not callable(getattr(port, n, None))]
    assert not missing, missing
    from kmerseek_tpu_torch import entry

    assert callable(ProteomeIndex.build_distributed) and callable(entry.dryrun_multichip)
    assert port.__name__ == "kmerseek_tpu_torch.parallel." + module
