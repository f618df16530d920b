"""The port's search CSV writer (``kmerseek_tpu_torch.core.search``) on the
CPU: the C++ library's float cells against ``repr`` and its integer cells
against ``str``, then the writer's bytes, through the library and through
the Python fallback (``native.available`` patched to False, as on a host
without a C++ compiler), against the JAX package's ``rows_to_csv`` /
``_write_rows`` (``csv.writer`` over each formatted cell), for a string,
a file and stdout, from row dicts and from ``SearchRows``."""

import contextlib
import io

import numpy as np
import pytest

import kmerseek_tpu.core.search as jsearch
from kmerseek_tpu_torch import native
from kmerseek_tpu_torch.core import search as tsearch
from kmerseek_tpu_torch.core.index import IndexConfig, ProteomeIndex
from test_search import GOLDEN
from test_torch_multisearch import _write_corpus


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("no C++ compiler: the native CSV formatter is not built")


def _cells(column, n):
    body = native.format_csv([column], n)
    assert body.endswith("\n") or n == 0
    return body.split("\n")[:-1]


def _edge_doubles():
    base = [0.0, 5e-324, 2.2250738585072014e-308, np.finfo(np.float64).max, 0.1, 2 / 3, 1e22, 1e23,
            1e300, 0.5, 1.0, 9007199254740992.0]
    out = []
    with np.errstate(over="ignore"):  # the largest double's upper neighbour is inf
        for v in [1e-4, 1e-5, 1e15, 1e16, 1e17, *base]:
            out += [v, np.nextafter(v, np.inf), np.nextafter(v, -np.inf)]
    out = [x for v in out for x in (v, -v)]
    return np.array(out + [np.inf, -np.inf, np.nan, -np.nan], np.float64)


def test_float_cells_are_repr(lib):
    """At least 10^6 seeded doubles: uniform [0, 1), normals scaled by
    10^-30 to 10^30, count/size rationals, 72nd roots as the ANI columns
    have them, random bit patterns (NaNs, infinities and subnormals
    among them), and the edge list: +-0.0, 5e-324, the largest double,
    +-inf, nan, and the exponent-form boundaries with their neighbours."""
    rng = np.random.default_rng(2026_10_18)
    n = 220_000
    counts = rng.integers(1, 5_000, n)
    sizes = counts + rng.integers(0, 50_000, n)
    vals = np.concatenate([
        rng.random(n),
        rng.standard_normal(n) * 10.0 ** rng.integers(-30, 31, n),
        counts / sizes,
        np.exp(np.log(counts / sizes) / 72),
        rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False).view(np.float64),
        _edge_doubles(),
    ])
    assert len(vals) >= 10**6
    assert _cells(vals, len(vals)) == list(map(repr, vals.tolist()))


def test_int_cells_are_str(lib):
    rng = np.random.default_rng(72)
    lim = np.iinfo(np.int64)
    tens = [10**e for e in range(19)]
    vals = np.array(
        [lim.min, lim.min + 1, lim.max, lim.max - 1, 0, -1, 1]
        + [v for t in tens for v in (t, t - 1, -t, 1 - t)],
        np.int64,
    )
    vals = np.concatenate([vals, rng.integers(lim.min, lim.max, 100_000, endpoint=True)])
    assert _cells(vals, len(vals)) == list(map(str, vals.tolist()))


def test_text_cells_are_copied_as_given(lib):
    cells = ["plain", '"q,uoted"', "", "naïve βeta", "\U0001f9ec", "x" * 5000]
    assert native.format_csv([cells, np.arange(6, dtype=np.int64)], 6) == "".join(
        f"{c},{i}\n" for i, c in enumerate(cells))


@pytest.mark.parametrize("column, error", [(["a", "b"], ValueError), (np.zeros(2), ValueError),
                                           (np.zeros(3, np.float32), TypeError)])
def test_format_csv_refuses_a_column_it_cannot_read(lib, column, error):
    with pytest.raises(error, match="column 1"):
        native.format_csv([np.zeros(3), column], 3)


# ---------------------------------------------------------------------------
# the writer's bytes against the JAX package's csv.writer rows
# ---------------------------------------------------------------------------

ADVERSARIAL_NAMES = ['plain', 'with,comma', 'with "quote"', 'line\nbreak', 'cr\rhere', 'both,"x"', '',
                     'Ünïcödé βeta, "isoform" 2', "naïve"]


def _golden_rows():
    """CED-9 against BCL-2: the reference's golden manysearch rows."""
    rows = []
    for tag, vals in sorted(GOLDEN.items()):
        row = {
            "query_name": "CED9_CAEEL Apoptosis regulator ced-9", "query_md5": "fe3714626e8180caf90f78091563aae6",
            "match_name": f"sp|{tag}|{tag}_HUMAN {tag}, BCL-2 family", "ksize": 48, "scaled": 5,
            "moltype": "hp", "average_abund": 1.0, "median_abund": 1.0, "std_abund": 0.0,
        }
        row.update(vals)
        rows.append({c: row[c] for c in tsearch.MANYSEARCH_COLUMNS})
    return rows, tsearch.MANYSEARCH_COLUMNS


def _adversarial_rows():
    floats = [0.0, 1.0, 0.1, 1e-05, 1.5e16, 2 / 3, 1e300, 5e-324, -0.0]
    m = max(len(ADVERSARIAL_NAMES), len(floats))
    cols = {"match_name": (ADVERSARIAL_NAMES + ["pad"] * m)[:m], "containment": (floats + [0.5] * m)[:m],
            "intersect_hashes": list(range(m)), 'odd "name", here': ["x"] * m}
    return [dict(zip(cols, v)) for v in zip(*cols.values())], list(cols)


def _mixed_rows():
    """Columns the library does not take: float32 scalars, None, bool, an
    int beyond int64, floats and ints mixed, a str holding a number."""
    n = 12
    rng = np.random.default_rng(3)
    cols = {
        "f32": [np.float32(x) for x in rng.random(n)],
        "none": [None if i % 2 else 1.5 for i in range(n)],
        "flag": [bool(i % 3) for i in range(n)],
        "big": [2**70 + i if i % 4 == 0 else i for i in range(n)],
        "mixed": [0.25 if i % 2 else 3 for i in range(n)],
        "text_num": ["7" if i % 2 else 7 for i in range(n)],
        "tuple": [(i, "a,b") for i in range(n)],
        "f64": [np.float64(x) for x in rng.random(n)],
        "i64": [np.int64(i * 10**17) for i in range(n)],
        "special": [float("nan"), float("inf"), float("-inf"), -0.0] * 3,
    }
    return [dict(zip(cols, v)) for v in zip(*cols.values())], list(cols)


def _many_rows():
    """More rows than one native call formats."""
    n = tsearch._CSV_BLOCK_ROWS + 3
    rng = np.random.default_rng(9)
    f = (rng.integers(1, 500, n) / rng.integers(500, 5000, n)).tolist()
    cols = {"name": [f"q{i % 97}, {i}" if i % 5 == 0 else f"q{i}" for i in range(n)], "f": f,
            "n": list(range(n))}
    return [dict(zip(cols, v)) for v in zip(*cols.values())], list(cols)


def _corpus_rows(search, tmp_path):
    tfa, qfa = _write_corpus(tmp_path)
    cfg = IndexConfig(16, 5, "hp")
    q = ProteomeIndex.build(qfa, cfg, device="cpu")
    t = ProteomeIndex.build(tfa, cfg, device="cpu")
    return getattr(tsearch, search)(q, t), getattr(tsearch, f"{search.upper()}_COLUMNS")


def _ced9_bcl2_rows(search, request):
    ced9, bcl2 = request.getfixturevalue("ced9"), request.getfixturevalue("bcl2_first25")
    cfg = IndexConfig(16, 5, "hp")
    q = ProteomeIndex.build(ced9, cfg, device="cpu")
    t = ProteomeIndex.build(bcl2, cfg, device="cpu")
    return getattr(tsearch, search)(q, t), getattr(tsearch, f"{search.upper()}_COLUMNS")


INPUTS = {
    "ced9_bcl2_golden": lambda req, tmp: _golden_rows(),
    "ced9_bcl2_manysearch": lambda req, tmp: _ced9_bcl2_rows("manysearch", req),
    "ced9_bcl2_multisearch": lambda req, tmp: _ced9_bcl2_rows("multisearch", req),
    "corpus_manysearch": lambda req, tmp: _corpus_rows("manysearch", tmp),
    "corpus_multisearch": lambda req, tmp: _corpus_rows("multisearch", tmp),
    "adversarial_names": lambda req, tmp: _adversarial_rows(),
    "mixed_types": lambda req, tmp: _mixed_rows(),
    "zero_rows": lambda req, tmp: ([], tsearch.MANYSEARCH_COLUMNS),
    # csv.writer quotes the only field of a row when it is empty
    "lone_column": lambda req, tmp: ([{"match_name": v} for v in ["", "a", "", "b,c"]], ["match_name"]),
    "more_than_a_block": lambda req, tmp: _many_rows(),
}


@pytest.fixture(params=["native", "python"])
def path(request, monkeypatch):
    if request.param == "native":
        request.getfixturevalue("lib")
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


def _stdout_of(writer, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        writer(*args)
    return buf.getvalue()


@pytest.mark.parametrize("to", ["string", "file", "stdout"])
@pytest.mark.parametrize("name", list(INPUTS))
def test_writer_bytes_match_jax(name, to, path, request, tmp_path):
    rows, columns = INPUTS[name](request, tmp_path)
    expect = jsearch.rows_to_csv(rows, columns)
    if to == "string":
        got = tsearch.rows_to_csv(rows, columns)
        assert tsearch.rows_to_csv(tsearch.SearchRows({c: [r[c] for r in rows] for c in columns}), columns) == got
    elif to == "file":
        out, ref = str(tmp_path / "p.csv"), str(tmp_path / "j.csv")
        tsearch.write_search_csv(rows, columns, out)
        jsearch.write_search_csv(rows, columns, ref)
        with open(out, "rb") as f, open(ref, "rb") as g:
            got_b, ref_b = f.read(), g.read()
        assert got_b == ref_b
        got = got_b.decode()
    else:
        got = _stdout_of(tsearch.write_search_csv, rows, columns)
    assert got == expect
    if rows:
        assert got.count("\n") >= len(rows) + 1


@pytest.mark.parametrize("to", ["file", "stdout"])
@pytest.mark.parametrize("name", ["corpus_manysearch", "corpus_multisearch", "adversarial_names", "mixed_types",
                                  "more_than_a_block"])
def test_column_writer_bytes_match_jax(name, to, path, request, tmp_path):
    """``write_search_csv_columns`` on columns as lists, and, where a
    search made them, as ``manysearch_columns`` / ``multisearch_columns``
    return them (numpy numeric columns)."""
    rows, columns = INPUTS[name](request, tmp_path)
    expect = jsearch.rows_to_csv(rows, columns)
    cols = {c: [r[c] for r in rows] for c in columns}
    if name.startswith("corpus_"):
        search = name.split("_", 1)[1]
        tfa, qfa = str(tmp_path / "t.fa"), str(tmp_path / "q.fa")
        cfg = IndexConfig(16, 5, "hp")
        cols = getattr(tsearch, f"{search}_columns")(ProteomeIndex.build(qfa, cfg, device="cpu"),
                                                     ProteomeIndex.build(tfa, cfg, device="cpu"))
        assert any(isinstance(v, np.ndarray) and v.dtype == np.float64 for v in cols.values())
    if to == "file":
        out = str(tmp_path / "c.csv")
        tsearch.write_search_csv_columns(cols, out)
        with open(out, newline="") as f:
            got = f.read()
    else:
        got = _stdout_of(tsearch.write_search_csv_columns, cols)
    assert got == expect


def test_numpy_columns_of_other_dtypes(path):
    """float32 and unsigned columns as numpy arrays write what their
    ``.tolist()`` rows write (a uint64 beyond int64 included): as
    columns, as ``SearchRows`` and as the list of its row dicts."""
    cols = {
        "f32": np.array([0.1, 1e-5, 3e38], np.float32),
        "u64": np.array([0, 2**63 + 5, 7], np.uint64),
        "u32": np.array([1, 2**32 - 1, 0], np.uint32),
        "i16": np.array([-3, 0, 3], np.int16),
        "b": np.array([True, False, True]),
    }
    rows = tsearch.SearchRows(cols)
    assert list(rows) == jsearch._rows_from_columns(cols)
    assert [type(v) for v in rows[1].values()] == [float, int, int, int, bool]
    want = jsearch.rows_to_csv(jsearch._rows_from_columns(cols), list(cols))
    assert _stdout_of(tsearch.write_search_csv_columns, cols) == want
    assert _stdout_of(tsearch.write_search_csv, rows, list(cols)) == want
    assert tsearch.rows_to_csv(rows, list(cols)) == tsearch.rows_to_csv(list(rows), list(cols)) == want
