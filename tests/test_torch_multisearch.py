"""The port's multisearch, file-level search API and column writers
against the JAX package's, on the same seeded FASTA files (``device="cpu"``
in the port). Every column is compared with ``==``, floats included:
tolerance 0, because both sides reduce the same f64 terms in the same
order on the host. CSV output is compared byte for byte."""

import io
import types

import numpy as np
import pytest

import kmerseek_tpu.core.search as jsearch
from kmerseek_tpu.core.index import IndexConfig as JCfg
from kmerseek_tpu.core.index import ProteomeIndex as JIdx
from kmerseek_tpu_torch.core import search as tsearch
from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
from kmerseek_tpu_torch.core.sigzip import read_sig_zip, write_sig_zip
from kmerseek_tpu_torch.utils import metrics

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
CONFIGS = {"hp": (16, 5, "hp"), "dayhoff": (10, 1, "dayhoff")}


def cross_checks() -> int:
    """The sparse device cross-checks run so far in this process (the
    registry's ``search.cross_check`` spans)."""
    return metrics.span_totals().get("search.cross_check", (0, 0.0))[0]


def _write_corpus(tdir, seed=21, n_targets=40, n_queries=12):
    """Targets: random proteins, two exact repeats and a shared segment (so
    equal hashes form runs), names holding ``,`` and ``"``; queries:
    planted 120-residue segments of targets with ~5% substitutions, one
    unrelated record and one shorter than k."""
    rng = np.random.default_rng(seed)
    seqs = [AA[rng.integers(0, 20, rng.integers(100, 400))] for _ in range(n_targets)]
    seqs[5] = seqs[4].copy()
    seqs[9] = seqs[4].copy()
    seqs[7][:80] = seqs[6][:80]
    tfa, qfa = str(tdir / "t.fa"), str(tdir / "q.fa")
    with open(tfa, "w") as f:
        for i, s in enumerate(seqs):
            name = f'sp|P{i:05d}|T{i} protein {i}, "isoform" {i % 3}' if i % 4 == 0 else f"t{i}"
            f.write(f">{name}\n{s.tobytes().decode()}\n")
    with open(qfa, "w") as f:
        for i in range(n_queries - 2):
            s = seqs[int(rng.integers(0, n_targets))]
            a = int(rng.integers(0, len(s) - 99))
            seg = s[a : a + 120].copy()
            sub = rng.random(len(seg)) < 0.05
            seg[sub] = AA[rng.integers(0, 20, int(sub.sum()))]
            f.write(f">q{i}, planted\n{seg.tobytes().decode()}\n")
        f.write(f">unrelated\n{AA[rng.integers(0, 20, 60)].tobytes().decode()}\n")
        f.write(">short\nMKV\n")
    return tfa, qfa


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request, tmp_path_factory):
    """Query and target indexes of both packages for one configuration,
    and their ``.sig.zip`` files as written by each package."""
    cfg = CONFIGS[request.param]
    tdir = tmp_path_factory.mktemp(f"multi-{request.param}")
    tfa, qfa = _write_corpus(tdir)
    ns = types.SimpleNamespace(cfg=cfg, dir=tdir)
    ns.pq = ProteomeIndex.build(qfa, IndexConfig(*cfg), device="cpu")
    ns.pt = ProteomeIndex.build(tfa, IndexConfig(*cfg), device="cpu")
    ns.jq = JIdx.build(qfa, JCfg(*cfg), engine="device")
    ns.jt = JIdx.build(tfa, JCfg(*cfg), engine="device")
    ns.zips = {
        "port": (ns.pq.to_sig_zip(str(tdir / "q.port.sig.zip")), ns.pt.to_sig_zip(str(tdir / "t.port.sig.zip"))),
        "jax": (ns.jq.to_sig_zip(str(tdir / "q.jax.sig.zip")), ns.jt.to_sig_zip(str(tdir / "t.jax.sig.zip"))),
    }
    return ns


def _assert_columns_equal(got, want):
    assert list(got) == list(want)
    for c in want:
        g, w = got[c], want[c]
        assert type(g) is type(w), c
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, c
            assert not (w.dtype.kind == "f" and np.isnan(w).any()), c
            assert (g == w).all(), c  # floats too: tolerance 0
        else:
            assert g == w, c


@pytest.mark.parametrize(
    "kw,n_cols",
    [
        ({}, 16),
        ({"estimate_prob_overlap": False}, 11),
        ({"threshold": 0.2}, 16),
        ({"threshold": 0.2, "estimate_prob_overlap": False}, 11),
    ],
)
def test_multisearch_columns_match_jax(pair, kw, n_cols):
    runs = cross_checks()
    got = tsearch.multisearch_columns(pair.pq, pair.pt, **kw)
    assert cross_checks() == runs + 1
    want = jsearch.multisearch_columns(pair.jq, pair.jt, **kw)
    _assert_columns_equal(got, want)
    assert list(got) == tsearch.MULTISEARCH_COLUMNS[:n_cols] == jsearch.MULTISEARCH_COLUMNS[:n_cols]
    n_all = len(tsearch.multisearch_columns(pair.pq, pair.pt)["containment"])
    n = len(got["containment"])
    # runs of equal hashes (the repeated targets) and several rows a query
    assert pair.pt.inverted.max_run >= 3 and n_all > 12
    if "threshold" in kw:
        assert 0 < n < n_all and got["containment"].min() >= 0.2
    else:
        assert n == n_all
    assert tsearch.multisearch(pair.pq, pair.pt, **kw) == jsearch.multisearch(pair.jq, pair.jt, **kw)


@pytest.mark.parametrize("estimate", [True, False])
def test_multisearch_empty_intersection_matches_jax(pair, estimate, tmp_path):
    """A target index that shares no hash with the queries: every column
    present and empty, as in the JAX package."""
    rng = np.random.default_rng(99)
    fa = tmp_path / "lone.fa"
    fa.write_text(f">lone\n{AA[rng.integers(0, 20, 40)].tobytes().decode()}\n")
    pt = ProteomeIndex.build(str(fa), IndexConfig(*pair.cfg), device="cpu")
    jt = JIdx.build(str(fa), JCfg(*pair.cfg), engine="device")
    got = tsearch.multisearch_columns(pair.pq, pt, estimate_prob_overlap=estimate)
    want = jsearch.multisearch_columns(pair.jq, jt, estimate_prob_overlap=estimate)
    assert got == want == {c: [] for c in tsearch.MULTISEARCH_COLUMNS[: 16 if estimate else 11]}
    assert tsearch.manysearch_columns(pair.pq, pt) == jsearch.manysearch_columns(pair.jq, jt)


@pytest.mark.parametrize("inner", ["ab", "hash"])
@pytest.mark.parametrize("route", ["packed", "lexsort"])
def test_host_join_orders_match_jax(pair, inner, route, monkeypatch):
    """Both within-segment orders, through the packed key and through the
    lexsort beyond its guard (forced by a huge target count)."""
    pqt = tsearch._join_tuples(pair.pq, pair.pt.inverted)
    jqt = jsearch._join_tuples(pair.jq, pair.jt.inverted)
    T = len(pair.pt) if route == "packed" else 2**62
    got = tsearch._segments_from_tuples(*pqt[:4], pair.pq.mins, len(pair.pq), T, inner, pqt[4])
    want = jsearch._segments_from_tuples(*jqt[:4], pair.jq.mins, len(pair.jq), T, inner, jqt[4])
    for f in tsearch._JoinSegments.__slots__:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    key = got.pab if inner == "ab" else pair.pq.mins[got.qhash]
    same_seg = got.seg_id[1:] == got.seg_id[:-1]
    assert (key[1:][same_seg] >= key[:-1][same_seg]).all() and same_seg.any()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fn", ["do_manysearch", "do_multisearch"])
@pytest.mark.parametrize("written_by", ["port", "jax", "mixed"])
def test_file_level_search_csv_bytes_match_jax(pair, fn, written_by, tmp_path):
    k, scaled, moltype = pair.cfg
    q = pair.zips["port" if written_by == "port" else "jax"][0]
    t = pair.zips["jax" if written_by == "jax" else "port"][1]
    out_p, out_j = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    rows_p = getattr(tsearch, fn)(q, t, out_p, ksize=k, scaled=scaled, moltype=moltype, device="cpu")
    rows_j = getattr(jsearch, fn)(q, t, out_j, ksize=k, scaled=scaled, moltype=moltype)
    assert _read(out_p) == _read(out_j)
    assert rows_p == rows_j and len(rows_p) > 12
    header = _read(out_p).split(b"\n", 1)[0].decode().split(",")
    assert header == (tsearch.MANYSEARCH_COLUMNS if fn == "do_manysearch" else tsearch.MULTISEARCH_COLUMNS)
    # entities with a .sig product path, and no requested parameters
    ent = types.SimpleNamespace
    out_e = str(tmp_path / "entity.csv")
    getattr(tsearch, fn)(ent(sig=q), ent(sig=t), out_e, device="cpu")
    assert _read(out_e) == _read(out_p)


@pytest.mark.parametrize("fn", ["do_manysearch", "do_multisearch"])
@pytest.mark.parametrize("fault", ["ksize", "scaled", "moltype", "several_sets", "index_ksize"])
def test_file_level_search_rejects_as_jax(pair, fn, fault, tmp_path):
    k, scaled, moltype = pair.cfg
    q, t = pair.zips["port"]
    want = dict(ksize=k, scaled=scaled, moltype=moltype)
    args_p, args_j = (q, t), (q, t)
    if fault == "several_sets":
        # one archive holding both configurations' signatures
        other = next(c for c in CONFIGS.values() if c != pair.cfg)
        extra = ProteomeIndex.build(str(pair.dir / "q.fa"), IndexConfig(*other), device="cpu")
        both = str(tmp_path / "both.sig.zip")
        write_sig_zip(both, read_sig_zip(q) + extra.signatures())
        args_p = args_j = (both, t)
        bad = {}
    elif fault == "index_ksize":  # a ProteomeIndex checked against the request
        args_p, args_j = (pair.pq, t), (pair.jq, t)
        bad = dict(want, ksize=k + 1)
    else:
        bad = dict(want, **{fault: {"ksize": k + 1, "scaled": scaled + 1, "moltype": "protein"}[fault]})
    out = str(tmp_path / "never.csv")
    with pytest.raises(ValueError) as ep:
        getattr(tsearch, fn)(*args_p, out, device="cpu", **bad)
    with pytest.raises(ValueError) as ej:
        getattr(jsearch, fn)(*args_j, out, **bad)
    assert str(ep.value) == str(ej.value)
    if fault == "several_sets":  # explicit parameters select one set
        out_p, out_j = str(tmp_path / "p.csv"), str(tmp_path / "j.csv")
        getattr(tsearch, fn)(*args_p, out_p, device="cpu", **want)
        getattr(jsearch, fn)(q, t, out_j, **want)
        assert _read(out_p) == _read(out_j)


def _csv_of(writer, *args):
    buf = io.StringIO()
    import contextlib

    with contextlib.redirect_stdout(buf):
        writer(*args)  # filename None: stdout
    return buf.getvalue()


@pytest.mark.parametrize("search", ["manysearch", "multisearch"])
@pytest.mark.parametrize("to", ["file", "stdout"])
def test_column_writer_matches_row_writer_and_jax(pair, search, to, tmp_path):
    columns = getattr(tsearch, f"{search.upper()}_COLUMNS")
    cols = getattr(tsearch, f"{search}_columns")(pair.pq, pair.pt)
    rows = getattr(tsearch, search)(pair.pq, pair.pt)
    jcols = getattr(jsearch, f"{search}_columns")(pair.jq, pair.jt)
    if to == "file":
        paths = [str(tmp_path / n) for n in ("cols.csv", "rows.csv", "jax.csv")]
        tsearch.write_search_csv_columns(cols, paths[0])
        tsearch.write_search_csv(rows, columns, paths[1])
        jsearch.write_search_csv_columns(jcols, paths[2])
        got = [_read(p).decode() for p in paths]
    else:
        got = [
            _csv_of(tsearch.write_search_csv_columns, cols),
            _csv_of(tsearch.write_search_csv, rows, columns),
            _csv_of(jsearch.write_search_csv_columns, jcols),
        ]
    assert got[0] == got[1] == got[2] == tsearch.rows_to_csv(rows, columns)
    assert tsearch.rows_to_csv(list(rows), columns) == got[0]
    # names with a comma and a quote are quoted, quotes doubled
    assert '"sp|P00004|T4 protein 4, ""isoform"" 1"' in got[0] and '"q0, planted"' in got[0]


@pytest.mark.parametrize("search", ["manysearch", "multisearch"])
@pytest.mark.parametrize("threshold", [0.0, 0.2])
def test_search_rows_are_the_row_dicts_of_their_columns(pair, search, threshold):
    """``manysearch`` / ``multisearch`` return ``SearchRows``: read as a
    list, the row dicts that the JAX package's ``_rows_from_columns``
    builds from the same columns, with the same keys in the same order,
    values and Python types; indexing, slicing and ``==`` act as on that
    list."""
    cols = getattr(tsearch, f"{search}_columns")(pair.pq, pair.pt, threshold=threshold)
    rows = getattr(tsearch, search)(pair.pq, pair.pt, threshold=threshold)
    want = jsearch._rows_from_columns(cols)
    assert isinstance(rows, tsearch.SearchRows) and len(rows) == len(want) > 4
    for i, (got, w) in enumerate(zip(rows, want)):
        for g in (got, rows[i], rows[i - len(rows)]):
            assert list(g) == list(w) == list(cols)
            assert [type(v) for v in g.values()] == [type(v) for v in w.values()]
            assert g == w
    assert type(rows[0]["containment"]) is float and type(rows[0]["ksize"]) is int
    for s in (slice(1, 4), slice(None, None, -2), slice(-3, None), slice(5, 2)):
        assert type(rows[s]) is list and rows[s] == want[s]
    again = getattr(tsearch, search)(pair.pq, pair.pt, threshold=threshold)
    assert rows == want and want == rows and rows == tuple(want) and rows == again
    assert rows != want[:-1] and rows != want[::-1] and rows != "rows"
    with pytest.raises(IndexError):
        rows[len(rows)]
    with pytest.raises(TypeError):
        hash(rows)


@pytest.mark.parametrize("search", ["manysearch", "multisearch"])
def test_parquet_writer_round_trips(pair, search, tmp_path):
    import pyarrow.parquet as pq

    cols = getattr(tsearch, f"{search}_columns")(pair.pq, pair.pt)
    out = str(tmp_path / "out.parquet")
    tsearch.write_search_parquet(cols, out)
    table = pq.read_table(out)
    assert table.column_names == list(cols)
    for c, v in cols.items():
        back = table[c].to_numpy(zero_copy_only=False) if isinstance(v, np.ndarray) else table[c].to_pylist()
        assert (back == v).all() if isinstance(v, np.ndarray) else back == v, c
    # the file API picks parquet by extension
    fn = getattr(tsearch, f"do_{search}")
    q, t = pair.zips["port"]
    fn(q, t, str(tmp_path / "api.pq"), device="cpu")
    assert pq.read_table(str(tmp_path / "api.pq")).equals(table)


def test_top_level_exports_match_jax_package():
    import kmerseek_tpu
    import kmerseek_tpu_torch

    for name in (
        "manysearch", "multisearch", "do_manysearch", "do_multisearch", "manysearch_columns",
        "multisearch_columns", "write_search_csv_columns", "write_search_parquet",
    ):
        assert getattr(kmerseek_tpu_torch, name) is getattr(tsearch, name)
        assert getattr(kmerseek_tpu, name) is getattr(jsearch, name)
    assert kmerseek_tpu_torch.ProteomeIndex is ProteomeIndex
    with pytest.raises(AttributeError):
        kmerseek_tpu_torch.no_such_name
