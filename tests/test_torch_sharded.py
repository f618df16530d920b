"""The port's ``parallel.sharded`` against the JAX package's on seeded
FASTA files: the pack / partition / merge steps simulated for several
processes and shard counts, the local posting build against the global
build restricted to the range, the merged manysearch and multisearch
columns against the JAX single-host engine and its
``*_columns_from_payloads``, and shard directories written by either
package and read by the other. Tolerance 0: ``==``, ``np.array_equal``.
(The exchange under a real process group: ``test_torch_multihost_real.py``.)
"""

import json
import os
import shutil

import numpy as np
import pytest

import kmerseek_tpu.core.search as jsearch
import kmerseek_tpu.parallel.sharded as jsh
from kmerseek_tpu.core.index import IndexConfig as JCfg
from kmerseek_tpu.core.index import ProteomeIndex as JIdx
from kmerseek_tpu_torch.core import search as tsearch
from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
from kmerseek_tpu_torch.parallel import sharded as tsh
from kmerseek_tpu_torch.parallel.multihost import hash_range_for_shard
from kmerseek_tpu_torch.utils.errors import NoSavedState
from test_torch_multisearch import _write_corpus, cross_checks

CFG = (16, 5, "hp")
# (processes that sketched, shards of the hash space)
LAYOUTS = [(1, 1), (2, 3), (3, 2), (5, 5)]
MEMBERS = ("g_hi", "g_lo", "tid", "ab", "bucket_starts")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tdir = tmp_path_factory.mktemp("sharded")
    tfa, qfa = _write_corpus(tdir, seed=51, n_targets=37, n_queries=12)
    pt = ProteomeIndex.build(tfa, IndexConfig(*CFG), device="cpu")
    pq = ProteomeIndex.build(qfa, IndexConfig(*CFG), device="cpu")
    return tfa, pt, pq, JIdx.build(tfa, JCfg(*CFG)), JIdx.build(qfa, JCfg(*CFG))


def _simulate(mod, target, n_hosts, n_shards, **kw):
    """Round-robin split + full shard construction in one process, with
    either package's functions (``mod``): → (meta, shards, meta payloads,
    posting payloads per shard)."""
    sigs = target.signatures()
    ords = [list(range(h, len(sigs), n_hosts)) for h in range(n_hosts)]
    hs = [[sigs[i] for i in o] for o in ords]
    metas = [mod.pack_target_meta(o, s) for o, s in zip(ords, hs)]
    names, sizes, weights, md5s = mod.merge_target_meta(metas)
    span = mod.occupied_span(target.config.scaled)
    shards, posts = [], []
    for d in range(n_shards):
        posts.append([mod.pack_range_postings(o, s, d, n_shards, span) for o, s in zip(ords, hs)])
        local = mod.build_local_inverted(posts[-1], len(names))
        shards.append(
            mod.ShardedProteomeIndex(target.config, names, sizes, weights, md5s, local, d, n_shards, **kw)
        )
    return (names, sizes, weights, md5s), shards, metas, posts


def _same_payload(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _same_inverted(a, b):
    for m in MEMBERS:
        x, y = np.asarray(getattr(a, m)), np.asarray(getattr(b, m))
        assert x.dtype == y.dtype and np.array_equal(x, y), m
    assert (a.n_targets, a.max_run, a.max_span, a.bucket_shift) == (
        b.n_targets, b.max_run, b.max_span, b.bucket_shift)


def _same_columns(got, want):
    assert list(got.keys()) == list(want.keys())
    for k, e in want.items():
        if isinstance(e, np.ndarray):
            g = np.asarray(got[k])
            assert g.dtype == e.dtype and np.array_equal(g, e), k
        else:
            assert got[k] == e, k


@pytest.mark.parametrize("scaled", [1, 2, 5, 1000])
def test_occupied_span_matches_jax(scaled):
    assert tsh.occupied_span(scaled) == jsh.occupied_span(scaled)
    assert tsh.SHARDED_FORMAT_VERSION == jsh.SHARDED_FORMAT_VERSION


@pytest.mark.parametrize("n_hosts,n_shards", LAYOUTS)
def test_exchange_steps_match_jax(corpus, n_hosts, n_shards):
    _tfa, pt, _pq, jt, _jq = corpus
    meta, shards, metas, posts = _simulate(tsh, pt, n_hosts, n_shards, device="cpu")
    jmeta, jshards, jmetas, jposts = _simulate(jsh, jt, n_hosts, n_shards)
    for a, b in zip(metas, jmetas):
        _same_payload(a, b)
    assert meta[0] == jmeta[0] == pt.names and meta[3] == jmeta[3]
    assert np.array_equal(meta[1], jmeta[1]) and np.array_equal(meta[2], jmeta[2])
    assert meta[3] == [pt.md5_for(i) for i in range(len(pt))]
    for d in range(n_shards):
        for a, b in zip(posts[d], jposts[d]):
            _same_payload(a, b)
        _same_inverted(shards[d].local, jshards[d].local)
        assert shards[d].hash_range == jshards[d].hash_range
        assert shards[d].n_local_postings == jshards[d].n_local_postings
        assert np.array_equal(shards[d].name_ranks, jshards[d].name_ranks)


@pytest.mark.parametrize("n_hosts,n_shards", LAYOUTS)
def test_local_inverted_is_the_global_build_restricted_to_the_range(corpus, n_hosts, n_shards):
    _tfa, pt, _pq, _jt, _jq = corpus
    _meta, shards, _metas, posts = _simulate(tsh, pt, n_hosts, n_shards, device="cpu")
    inv = pt.inverted
    g = inv.g64()
    span = tsh.occupied_span(CFG[1])
    for d, sh in enumerate(shards):
        lo, hi = hash_range_for_shard(d, n_shards, span)
        keep = (g >= np.uint64(lo)) & (g <= np.uint64(hi - 1))
        assert np.array_equal(sh.local.g64(), g[keep])
        assert np.array_equal(sh.local.tid, inv.tid[keep])
        assert np.array_equal(sh.local.ab, inv.ab[keep])
        assert sh.local.n_targets == len(pt)
        # the payloads' arrival order does not matter
        again = tsh.build_local_inverted(posts[d][::-1], len(pt))
        _same_inverted(again, sh.local)
    assert sum(sh.n_local_postings for sh in shards) == inv.n_postings
    if n_shards > 1:
        assert all(0 < sh.n_local_postings < inv.n_postings for sh in shards)


@pytest.mark.parametrize("case", ["missing", "duplicated"])
def test_merge_target_meta_detects_a_missing_or_duplicated_shard(corpus, case):
    _tfa, pt, _pq, _jt, _jq = corpus
    sigs = pt.signatures()
    metas = [tsh.pack_target_meta(list(range(h, len(sigs), 3)), sigs[h::3]) for h in range(3)]
    bad = metas[1:] if case == "missing" else metas + metas[2:]
    with pytest.raises(RuntimeError, match="missing or duplicated"):
        tsh.merge_target_meta(bad)
    with pytest.raises(RuntimeError, match="missing or duplicated"):
        jsh.merge_target_meta(bad)


@pytest.mark.parametrize("n_hosts,n_shards", LAYOUTS)
def test_sharded_manysearch_bit_equal(corpus, n_hosts, n_shards):
    _tfa, pt, pq, jt, jq = corpus
    want = jsearch.manysearch_columns(jq, jt)
    assert len(want) == 22 and len(want["query_name"]) > 0
    _meta, shards, _m, _p = _simulate(tsh, pt, n_hosts, n_shards, device="cpu")
    _jmeta, jshards, _jm, _jp = _simulate(jsh, jt, n_hosts, n_shards)
    payloads = [tsh.local_manysearch_payload(pq, sh) for sh in shards]
    jpayloads = [jsh.local_manysearch_payload(jq, sh) for sh in jshards]
    for a, b in zip(payloads, jpayloads):
        _same_payload(a, b)
    # every shard merges to the identical full result, whatever the order
    for sh, order in ((shards[0], payloads), (shards[-1], payloads[::-1])):
        got = tsh.manysearch_columns_from_payloads(pq, sh, order)
        _same_columns(got, want)
        _same_columns(got, jsh.manysearch_columns_from_payloads(jq, jshards[0], jpayloads))
        _same_columns(got, tsearch.manysearch_columns(pq, pt))
    got = tsh.manysearch_columns_from_payloads(pq, shards[0], payloads, threshold=0.2)
    _same_columns(got, jsearch.manysearch_columns(jq, jt, threshold=0.2))


@pytest.mark.parametrize("estimate", [True, False])
@pytest.mark.parametrize("n_hosts,n_shards", LAYOUTS)
def test_sharded_multisearch_bit_equal(corpus, n_hosts, n_shards, estimate):
    _tfa, pt, pq, jt, jq = corpus
    want = jsearch.multisearch_columns(jq, jt, estimate_prob_overlap=estimate)
    assert len(want) == (16 if estimate else 11) and len(want["query_name"]) > 0
    _meta, shards, _m, _p = _simulate(tsh, pt, n_hosts, n_shards, device="cpu")
    _jmeta, jshards, _jm, _jp = _simulate(jsh, jt, n_hosts, n_shards)
    payloads = [tsh.local_multisearch_payload(pq, sh) for sh in shards]
    jpayloads = [jsh.local_multisearch_payload(jq, sh) for sh in jshards]
    for a, b in zip(payloads, jpayloads):
        _same_payload(a, b)
    got = tsh.multisearch_columns_from_payloads(
        pq, shards[-1], payloads[::-1], estimate_prob_overlap=estimate
    )
    _same_columns(got, want)
    _same_columns(
        got,
        jsh.multisearch_columns_from_payloads(jq, jshards[0], jpayloads, estimate_prob_overlap=estimate),
    )
    _same_columns(got, tsearch.multisearch_columns(pq, pt, estimate_prob_overlap=estimate))


def test_empty_shard_and_no_hits(corpus):
    """256 shards of three small sketches leave ranges without a posting;
    payloads that share nothing give the empty columns."""
    _tfa, full, _pq, jfull, _jq = corpus
    pt = ProteomeIndex.from_signatures(full.signatures()[:3], device="cpu")
    jt = JIdx.from_signatures(jfull.signatures()[:3])
    pq, jq = full, jfull  # every target as a query: the three hit themselves
    _meta, shards, _m, _p = _simulate(tsh, pt, 2, 256, device="cpu")
    empty = [sh for sh in shards if sh.n_local_postings == 0]
    assert empty and len(empty) < 256 and empty[0].local.max_run == 1
    assert all(len(v) == 0 for v in tsh.local_manysearch_payload(pq, empty[0]).values())
    assert all(len(v) == 0 for v in tsh.local_multisearch_payload(pq, empty[0]).values())
    payloads = [tsh.local_manysearch_payload(pq, sh) for sh in shards]
    want = jsearch.manysearch_columns(jq, jt)
    assert len(want["query_name"]) >= 3
    _same_columns(tsh.manysearch_columns_from_payloads(pq, shards[5], payloads), want)
    mpayloads = [tsh.local_multisearch_payload(pq, sh) for sh in shards]
    _same_columns(
        tsh.multisearch_columns_from_payloads(pq, shards[7], mpayloads), jsearch.multisearch_columns(jq, jt)
    )
    none = [tsh.local_manysearch_payload(pq, sh) for sh in empty]
    assert tsh.manysearch_columns_from_payloads(pq, empty[0], none) == {
        c: [] for c in tsearch.MANYSEARCH_COLUMNS}
    nonem = [tsh.local_multisearch_payload(pq, sh) for sh in empty]
    assert tsh.multisearch_columns_from_payloads(pq, empty[0], nonem) == {
        c: [] for c in tsearch.MULTISEARCH_COLUMNS}


def test_parameter_mismatch_raises(corpus):
    tfa, pt, _pq, _jt, _jq = corpus
    _meta, shards, _m, _p = _simulate(tsh, pt, 1, 2, device="cpu")
    other = ProteomeIndex.build(tfa, IndexConfig(10, 5, "hp"), device="cpu")
    for fn in (tsh.local_manysearch_payload, tsh.local_multisearch_payload):
        with pytest.raises(ValueError, match="parameters differ"):
            fn(other, shards[0])


def test_single_process_sharded_build_degenerates(corpus, monkeypatch):
    """P = 1: ``build_sharded_index`` runs the whole exchange path with no
    communication and equals the plain build's postings and search."""
    tfa, pt, pq, jt, jq = corpus
    for v in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    sh = tsh.build_sharded_index(tfa, IndexConfig(*CFG), batch_size=9, device="cpu")
    assert (sh.shard, sh.n_shards, sh.source_fasta) == (0, 1, os.path.abspath(tfa))
    assert sh.names == pt.names and sh.device.type == "cpu"
    _same_inverted(sh.local, pt.inverted)
    _same_inverted(sh.local, jsh.build_sharded_index(tfa, JCfg(*CFG)).local)
    _same_columns(tsh.sharded_manysearch_columns(pq, sh), jsearch.manysearch_columns(jq, jt))
    _same_columns(tsh.sharded_multisearch_columns(pq, sh), jsearch.multisearch_columns(jq, jt))


def test_local_join_is_cross_checked_on_the_shard_device(corpus):
    _tfa, pt, pq, _jt, _jq = corpus
    _meta, shards, _m, _p = _simulate(tsh, pt, 2, 2, device="cpu")
    before = cross_checks()
    tsh.local_manysearch_payload(pq, shards[0])
    tsh.local_multisearch_payload(pq, shards[1])
    assert cross_checks() == before + 2


def _tree(d):
    return sorted(os.listdir(d))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shard_directory_is_interchangeable(corpus, tmp_path, writer):
    """A directory saved by either package loads in the other: same
    member names, dtypes, bytes and manifest keys; the loaded shards
    merge to the same search."""
    _tfa, pt, pq, jt, jq = corpus
    _meta, shards, _m, _p = _simulate(tsh, pt, 2, 3, device="cpu")
    _jmeta, jshards, _jm, _jp = _simulate(jsh, jt, 2, 3)
    pdir, jdir = str(tmp_path / "port.ksx"), str(tmp_path / "jax.ksx")
    for sh, jshd in zip(shards, jshards):
        d, jd = sh.save(pdir), jshd.save(jdir)
        assert os.path.basename(d) == os.path.basename(jd) == f"shard_{sh.shard}_of_3"
        assert _tree(d) == _tree(jd) == sorted([f"{m}.npy" for m in MEMBERS + ("t_sizes", "t_weight")] + ["manifest.json"])
        with open(os.path.join(d, "manifest.json")) as f, open(os.path.join(jd, "manifest.json")) as jf:
            assert json.load(f) == json.load(jf)
        for name in _tree(d):
            if name.endswith(".npy"):
                with open(os.path.join(d, name), "rb") as f, open(os.path.join(jd, name), "rb") as jf:
                    assert f.read() == jf.read(), name
    src = pdir if writer == "port" else jdir
    loaded = [tsh.load_sharded_index(src, s, 3, device="cpu") for s in range(3)]
    jloaded = [jsh.load_sharded_index(src, s, 3) for s in range(3)]
    for sh, ld, jld in zip(shards, loaded, jloaded):
        assert ld.names == jld.names == sh.names and ld.md5s == jld.md5s == sh.md5s
        assert np.array_equal(ld.t_sizes, sh.t_sizes) and np.array_equal(ld.t_weight, sh.t_weight)
        _same_inverted(ld.local, sh.local)
        _same_inverted(jld.local, sh.local)
        assert not np.asarray(ld.local.g_hi).flags.writeable  # mmap'd read-only
        assert (ld.config.ksize, ld.config.scaled, ld.config.moltype) == CFG
        assert (ld.shard, ld.n_shards, ld.source_fasta) == (sh.shard, 3, sh.source_fasta)
    want = jsearch.manysearch_columns(jq, jt)
    payloads = [tsh.local_manysearch_payload(pq, ld) for ld in loaded]
    _same_columns(tsh.manysearch_columns_from_payloads(pq, loaded[0], payloads), want)
    mpayloads = [tsh.local_multisearch_payload(pq, ld) for ld in loaded]
    _same_columns(
        tsh.multisearch_columns_from_payloads(pq, loaded[1], mpayloads), jsearch.multisearch_columns(jq, jt)
    )
    jpayloads = [jsh.local_manysearch_payload(jq, ld) for ld in jloaded]
    _same_columns(jsh.manysearch_columns_from_payloads(jq, jloaded[0], jpayloads), want)
    # a shard re-saved into its own directory while its members are mapped
    again = tsh.ShardedProteomeIndex.load(loaded[2].save(src) and src, 2, 3, device="cpu")
    _same_inverted(again.local, shards[2].local)


@pytest.mark.parametrize(
    "fault", ["never_saved", "truncated", "missing_member", "wrong_shard", "wrong_n_shards", "checksum", "too_new"]
)
def test_load_rejects_wrong_shards_and_corruption(corpus, tmp_path, monkeypatch, fault):
    _tfa, pt, _pq, _jt, _jq = corpus
    _meta, shards, _m, _p = _simulate(tsh, pt, 1, 2, device="cpu")
    path = str(tmp_path / "s.ksx")
    d = shards[0].save(path)
    load = lambda s, n: tsh.load_sharded_index(path, s, n, device="cpu")  # noqa: E731
    assert load(0, 2).n_local_postings == shards[0].n_local_postings
    fp = os.path.join(d, "g_hi.npy")
    if fault == "never_saved":
        with pytest.raises(NoSavedState):
            load(1, 2)
    elif fault == "truncated":
        with open(fp, "r+b") as f:
            f.truncate(os.path.getsize(fp) - 8)
        with pytest.raises(ValueError, match="corrupt shard"):
            load(0, 2)
    elif fault == "missing_member":
        os.remove(os.path.join(d, "tid.npy"))
        with pytest.raises(ValueError, match="corrupt shard: tid.npy missing"):
            load(0, 2)
    elif fault == "wrong_shard":
        shutil.copytree(d, os.path.join(path, "shard_1_of_2"))
        with pytest.raises(ValueError, match="holds shard 0/2, process expected 1/2"):
            load(1, 2)
    elif fault == "wrong_n_shards":
        shutil.copytree(d, os.path.join(path, "shard_0_of_4"))
        with pytest.raises(ValueError, match="holds shard 0/2, process expected 0/4"):
            load(0, 4)
    elif fault == "checksum":
        arr = np.load(fp)
        arr[0] ^= 1  # same size and length, other content
        np.save(fp, arr)
        assert load(0, 2) is not None  # the structural check cannot see it
        monkeypatch.setenv("KMERSEEK_LOAD_VERIFY", "full")
        with pytest.raises(ValueError, match="checksum mismatch"):
            load(0, 2)
    else:
        mp = os.path.join(d, "manifest.json")
        with open(mp) as f:
            manifest = json.load(f)
        manifest["format_version"] = tsh.SHARDED_FORMAT_VERSION + 1
        with open(mp, "w") as f:
            json.dump(manifest, f)
        with pytest.raises(ValueError, match="too new"):
            load(0, 2)


def test_sharded_entry_points_default_to_the_card(corpus, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    tfa, pt, _pq, _jt, _jq = corpus
    _meta, shards, _m, _p = _simulate(tsh, pt, 1, 1, device="cpu")
    shards[0].save(str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsh.build_sharded_index(tfa, IndexConfig(*CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsh.load_sharded_index(str(tmp_path / "s"), 0, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _simulate(tsh, pt, 1, 1)
