"""REAL 2-process ``torch.distributed`` (Gloo) group on the CPU for the
port's ``parallel.multihost`` and ``parallel.sharded``.

Two spawned processes form a group over localhost and run
``build_distributed_index``, ``build_sharded_index`` with both sharded
searches, ``save`` — and, in a FRESH group, ``ShardedProteomeIndex.load``
with both searches again. The parent holds every result to the JAX
package's single-host build and search of the same seeded FASTA files:
index arrays, posting slices, every manysearch and multisearch column
(``==``) and the CSV bytes. Tolerance 0 throughout.

The workers are this file run as a script (``python
test_torch_multihost_real.py worker …``); they import only the port.
Every launch bounds the rendezvous and the collectives
(``KMERSEEK_DIST_TIMEOUT``) and the parent's wait, kills the survivors
of a failed group and fails.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = (16, 5, "hp")
GROUP_TIMEOUT_S = 60  # rendezvous and every collective, in each worker
WAIT_TIMEOUT_S = 150  # the parent's wait for a whole group


# ----------------------------------------------------------------------
# the worker (no jax, nothing of the JAX package)
# ----------------------------------------------------------------------


def _columns_payload(prefix, cols):
    out = {}
    for k, v in cols.items():
        if isinstance(v, np.ndarray):
            out[f"{prefix}_{k}"] = v
        else:
            out[f"{prefix}_{k}"] = np.asarray(v, dtype=np.str_ if v and isinstance(v[0], str) else None)
    return out


def _worker(argv):
    init_method, world, rank, mode, tfa, qfa, save_path, out = argv
    world, rank = int(world), int(rank)
    from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
    from kmerseek_tpu_torch.core.search import write_search_csv_columns
    from kmerseek_tpu_torch.parallel import multihost, sharded

    if mode == "die" and rank == 1:
        sys.exit(7)  # before the rendezvous: the other rank must not hang
    got = multihost.initialize_distributed(init_method, world, rank)
    assert got == (rank, world), got
    assert multihost.initialize_distributed() == got  # the live group is reported
    cfg = IndexConfig(*CFG)
    payload = {}
    if mode == "build":
        idx = ProteomeIndex.build_distributed(tfa, cfg, batch_size=7, device="cpu")
        payload.update(
            mins=idx.mins, abundances=idx.abundances, offsets=idx.offsets,
            names=np.asarray(idx.names, dtype=np.str_),
            replica_bytes=np.asarray(
                [multihost.exchange_stats["bytes_sent"], multihost.exchange_stats["bytes_received"]]
            ),
        )
        sh = sharded.build_sharded_index(tfa, cfg, batch_size=7, device="cpu")
        sh.save(save_path)
    else:
        sh = sharded.ShardedProteomeIndex.load(save_path, device="cpu")  # shard from the group
    assert (sh.shard, sh.n_shards) == (rank, world)
    # queries are replicated: each process sketches the query FASTA
    query = ProteomeIndex.build(qfa, cfg, device="cpu")
    many = sharded.sharded_manysearch_columns(query, sh)
    multi = sharded.sharded_multisearch_columns(query, sh)
    write_search_csv_columns(many, out + ".many.csv")
    write_search_csv_columns(multi, out + ".multi.csv")
    payload.update(
        shard=np.asarray([sh.shard, sh.n_shards]),
        local_g=sh.local.g64(), local_tid=np.asarray(sh.local.tid), local_ab=np.asarray(sh.local.ab),
        t_sizes=sh.t_sizes, t_weight=sh.t_weight,
        sharded_names=np.asarray(sh.names, dtype=np.str_), md5s=np.asarray(sh.md5s, dtype=np.str_),
    )
    payload.update(_columns_payload("many", many))
    payload.update(_columns_payload("multi", multi))
    np.savez(out, **payload)


if __name__ == "__main__":
    assert sys.argv[1] == "worker", sys.argv
    sys.path.insert(0, REPO)
    _worker(sys.argv[2:])
    sys.exit(0)


# ----------------------------------------------------------------------
# the tests (parent side: both packages)
# ----------------------------------------------------------------------

import pytest  # noqa: E402


def _free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _run_group(mode, tfa, qfa, save_path, out_dir, tag, expect_failure=False):
    """Spawn a real 2-process Gloo group; → (out paths, return codes, wall)."""
    init_method = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", KMERSEEK_DIST_TIMEOUT=str(GROUP_TIMEOUT_S))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    outs = [os.path.join(out_dir, f"{tag}{i}.npz") for i in range(2)]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", init_method, "2", str(i),
             mode, tfa, qfa, save_path, outs[i]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for i in range(2)
    ]
    deadline = time.monotonic() + WAIT_TIMEOUT_S
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=max(deadline - time.monotonic(), 1)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"2-process group '{mode}' did not finish in {WAIT_TIMEOUT_S} s; workers killed")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    rcs = [p.returncode for p in procs]
    if not expect_failure:
        for i, (rc, (out, err)) in enumerate(zip(rcs, results)):
            assert rc == 0, f"worker {i} failed (rc={rc}):\n{out[-1500:]}\n{err[-3000:]}"
    return outs, rcs, time.perf_counter() - t0


def _eq(got, want, what):
    if isinstance(want, np.ndarray):
        assert np.array_equal(np.asarray(got), want), what
    else:
        assert (got.tolist() if isinstance(got, np.ndarray) else got) == want, what


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """One build group and one fresh load group over the same files, and
    the JAX package's single-host index and columns."""
    import types

    import kmerseek_tpu.core.search as jsearch
    from kmerseek_tpu.core.index import IndexConfig as JCfg
    from kmerseek_tpu.core.index import ProteomeIndex as JIdx
    from test_torch_multisearch import _write_corpus

    tdir = tmp_path_factory.mktemp("group")
    tfa, qfa = _write_corpus(tdir, seed=33, n_targets=45, n_queries=14)
    ns = types.SimpleNamespace(dir=tdir, tfa=tfa, qfa=qfa, save=str(tdir / "sharded.ksx"))
    ns.build_outs, _, ns.build_wall = _run_group("build", tfa, qfa, ns.save, str(tdir), "b")
    ns.load_outs, _, ns.load_wall = _run_group("load", tfa, qfa, ns.save, str(tdir), "l")
    ns.plain = JIdx.build(tfa, JCfg(*CFG))
    ns.query = JIdx.build(qfa, JCfg(*CFG))
    ns.many = jsearch.manysearch_columns(ns.query, ns.plain)
    ns.multi = jsearch.multisearch_columns(ns.query, ns.plain)
    ns.csv = {}
    for name, cols in (("many", ns.many), ("multi", ns.multi)):
        path = str(tdir / f"jax.{name}.csv")
        jsearch.write_search_csv_columns(cols, path)
        with open(path, "rb") as f:
            ns.csv[name] = f.read()
    return ns


@pytest.mark.parametrize("rank", [0, 1])
def test_two_process_group_builds_bit_equal_index(groups, rank):
    got = np.load(groups.build_outs[rank])
    plain = groups.plain
    assert got["names"].tolist() == plain.names
    assert np.array_equal(got["mins"], plain.mins) and got["mins"].dtype == np.uint64
    assert np.array_equal(got["abundances"], plain.abundances)
    assert np.array_equal(got["offsets"], plain.offsets)
    sent, received = got["replica_bytes"].tolist()
    assert sent > 0 and received > 0  # the exchange really crossed the group


@pytest.mark.parametrize("which", ["build", "load"])
def test_two_process_hash_range_shards_partition_the_postings(groups, which):
    from kmerseek_tpu.parallel.multihost import hash_range_for_shard
    from kmerseek_tpu.parallel.sharded import occupied_span

    got = [np.load(p) for p in getattr(groups, f"{which}_outs")]
    inv = groups.plain.inverted
    span = occupied_span(CFG[1])
    for i, g in enumerate(got):
        assert g["shard"].tolist() == [i, 2]
        lo, hi = hash_range_for_shard(i, 2, span)
        assert int(g["local_g"].min()) >= lo and int(g["local_g"].max()) < hi
        assert 0.3 * inv.n_postings < len(g["local_g"]) < 0.7 * inv.n_postings
        assert g["sharded_names"].tolist() == groups.plain.names
        assert g["md5s"].tolist() == [groups.plain.md5_for(t) for t in range(len(groups.plain))]
        assert np.array_equal(g["t_sizes"], np.diff(groups.plain.offsets))
    for member, want in (("local_g", inv.g64()), ("local_tid", inv.tid), ("local_ab", inv.ab)):
        assert np.array_equal(np.concatenate([got[0][member], got[1][member]]), want), member


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("which", ["build", "load"])
@pytest.mark.parametrize("search", ["many", "multi"])
def test_two_process_sharded_search_bit_equal(groups, which, rank, search):
    """Collectives in build AND search, and after a reload by a fresh
    group: every column ``==`` the JAX single-host engine's, CSV bytes
    equal."""
    out = getattr(groups, f"{which}_outs")[rank]
    got = np.load(out)
    want = getattr(groups, search)
    assert len(want["query_name"]) > 0
    assert len(want) == (22 if search == "many" else 16)
    for k, e in want.items():
        _eq(got[f"{search}_{k}"], e, f"{which}.{search}.{k}")
    with open(f"{out}.{search}.csv", "rb") as f:
        assert f.read() == groups.csv[search]


@pytest.mark.parametrize("shard", [0, 1])
def test_group_saved_shard_loads_in_the_jax_package(groups, shard):
    """The directory a rank of the group wrote is the JAX package's
    format: it loads there and merges to the same search."""
    import kmerseek_tpu.parallel.sharded as jsharded

    loaded = [jsharded.load_sharded_index(groups.save, s, 2) for s in range(2)]
    payloads = [jsharded.local_manysearch_payload(groups.query, ld) for ld in loaded]
    got = jsharded.manysearch_columns_from_payloads(groups.query, loaded[shard], payloads)
    for k, e in groups.many.items():
        _eq(got[k], e, k)


def test_dead_rank_fails_the_group_instead_of_hanging(tmp_path):
    """Rank 1 exits before the rendezvous: rank 0's group times out and
    its process fails; nothing waits for ever."""
    global GROUP_TIMEOUT_S
    saved, GROUP_TIMEOUT_S = GROUP_TIMEOUT_S, 5
    try:
        _outs, rcs, wall = _run_group(
            "die", "none.fa", "none.fa", str(tmp_path / "s"), str(tmp_path), "d", expect_failure=True
        )
    finally:
        GROUP_TIMEOUT_S = saved
    assert rcs[1] == 7 and rcs[0] not in (0, None)
    assert wall < 60
