"""The port's line-table modules (``radtxfr_tpu_torch/lines/query.py``,
``hapi_db.py``, ``fetch.py`` and ``synthetic.to_hapi_cache``) against
``radtxfr_tpu.lines``' on the CPU, on the same seeded lists (float64).

* The query DSL's full operator set, ``select``, ``filter_mask``, ``group``
  with every reducer, multi-key descending ``sort``, ``extract_columns``
  and ``stick_xy`` give the JAX package's results exactly.
* ``save_table``, ``write_par`` and ``hapi_compat.db_commit`` write the same
  bytes as the JAX package's, and each package reads the other's files to
  the same columns; ``HapiDatabase`` lists, loads, describes and commits
  alike.
* ``to_hapi_cache`` fills a stand-in hapi module with JAX's cache dict.
* ``fetch`` offline only: the same URLs and parameter lists,
  ``parse_custom_payload`` of a literal payload, and a ``urlopen`` that
  raises giving ``ConnectionError`` on both sides.
"""

import json
import os
import types
import urllib.request

import numpy as np
import pytest
import torch

from radtxfr_tpu import hapi_compat as jhc
from radtxfr_tpu.lines import fetch as jfetch
from radtxfr_tpu.lines import hapi_db as jdb
from radtxfr_tpu.lines import query as jquery
from radtxfr_tpu.lines.store import parse_par as jparse_par
from radtxfr_tpu.lines.synthetic import synthetic_lines as jsynthetic
from radtxfr_tpu.lines.synthetic import to_hapi_cache as jto_hapi_cache

from radtxfr_tpu_torch import hapi_compat as hc
from radtxfr_tpu_torch.lines import fetch, hapi_db, query
from radtxfr_tpu_torch.lines.store import parse_par
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines, to_hapi_cache
from port_fixtures import one_torch_thread  # noqa: F401

F64 = torch.float64
COLUMNS = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
           "delta_air", "sd_air", "mol_id", "iso_row")


def _pair(n=300, seed=84, **kw):
    """The same synthetic list in both packages (the port's on the CPU)."""
    return (synthetic_lines(n, seed=seed, device="cpu", dtype=F64, **kw),
            jsynthetic(n, seed=seed, **kw))


def _same_store(port, jax_store):
    """The port's store holds the JAX store's rows, in its order."""
    assert port.sw.device.type == "cpu" and port.sw.dtype == F64
    for c in COLUMNS:
        np.testing.assert_array_equal(port.host[c],
                                      np.asarray(getattr(jax_store, c)),
                                      err_msg=c)
        np.testing.assert_array_equal(port.host[c],
                                      getattr(port, c).numpy(), err_msg=c)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


EXPRESSIONS = [
    ("RANGE", "nu", 700.0, 900.0), ("BETWEEN", "nu", 700.0, 900.0),
    ("between", "nu", 700.0, 900.0),
    *((op, "nu", 800.0) for op in (
        "<", "LESS", "LT", ">", "MORE", "MT", "<=", "LESSOREQUAL", "LTE",
        ">=", "MOREOREQUAL", "MTE", "=", "==", "EQ", "EQUAL", "EQUALS",
        "!=", "<>", "~=", "NE", "NOTEQUAL")),
    ("<", 0.0, "nu", 5000.0),
    ("SUM", "nu", "nu", 1.0), ("+", "sw", "sw"),
    ("MUL", "nu", 2.0, 3.0), ("*", "gamma_air", "n_air"),
    ("DIFF", "nu", 1.0), ("-", "nu"), ("DIV", "nu", 2.0),
    ("/", "gamma_self", "gamma_air"), ("ABS", ("-", 0.0, "nu")),
    ("IN", "molec_id", (1, 2)), ("SUBSET", "molec_id", ("LIST", 1, 3)),
    ("&&", ("NOT", ("IN", "molec_id", (1,))),
     ("||", ("==", "molec_id", 2), ("==", "molec_id", 3))),
    ("AND", (">", "sw", 1e-23), ("!", ("<", "elower", 1000.0))),
    ("&", (">", "nu", 600.0), ("<", "nu", 1400.0)),
    ("OR", ("<", "nu", 600.0), (">", "nu", 1400.0)),
    ("|", ("==", "molec_id", 1), ("==", "molec_id", 3)),
    ("STR", "abc"), ("STRING", "x"), ("SET", (1, 2, 3)),
    ("LIST", 1.0, 2.0), ("nu0"), ("iso_row"), 3.5,
]


@pytest.mark.parametrize("expr", EXPRESSIONS,
                         ids=[str(i) for i in range(len(EXPRESSIONS))])
def test_evaluate_matches_jax(expr):
    store, jstore = _pair()
    got, want = query.evaluate(store, expr), jquery.evaluate(jstore, expr)
    if isinstance(want, (str, list)) or np.ndim(want) == 0:
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)


def test_regex_operators_match_jax():
    tbl = {"name": ["H2O", "CO2", "O3", "HDO"], "nu": np.arange(4.0)}
    for expr in (("MATCH", ("STR", "H.*"), "name"),
                 ("LIKE", ("STR", ".*O$"), "name"),
                 ("SEARCH", ("STR", "O2"), "name")):
        np.testing.assert_array_equal(query.evaluate(tbl, expr),
                                      jquery.evaluate(tbl, expr))
    expr = ("FINDALL", ("STR", "O"), "name")
    assert query.evaluate(tbl, expr) == jquery.evaluate(tbl, expr)
    with pytest.raises(ValueError, match="unknown operation"):
        query.evaluate(tbl, ("NOPE", "nu"))
    with pytest.raises(KeyError):
        query.evaluate(tbl, "missing")


def test_select_and_filter_mask_match_jax():
    store, jstore = _pair()
    cond = ("and", ("between", "nu", 700.0, 900.0), ("==", "molec_id", 1))
    np.testing.assert_array_equal(query.filter_mask(store, cond),
                                  jquery.filter_mask(jstore, cond))
    assert query.filter_mask(store, ("==", 1, 1)).all()
    _same_store(query.select(store, cond), jquery.select(jstore, cond))


@pytest.mark.parametrize("by", ["molec_id", ["iso_row"]])
def test_group_every_reducer_matches_jax(by):
    store, jstore = _pair(400, seed=85)
    aggs = {f"{how.lower()}_{i}": (how, expr)
            for i, (how, expr) in enumerate(
                (h, e) for h in jquery.GROUP_FUNCTIONS
                for e in ("sw", ("/", "gamma_self", "gamma_air")))}
    got = query.group(store, by=by, aggregates=aggs)
    want = jquery.group(jstore, by=by, aggregates=aggs)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_group_multi_key_matches_jax():
    store, jstore = _pair(400, seed=85)
    aggs = {"n": ("COUNT", None), "s": ("SUM", "sw"), "p": ("MUL", "n_air")}
    got = query.group(store, by=("molec_id", "iso_row"), aggregates=aggs)
    want = jquery.group(jstore, by=("molec_id", "iso_row"), aggregates=aggs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="unknown group function"):
        query.group(store, by="molec_id", aggregates={"x": ("NOPE", "sw")})


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("by", ["sw", ["molec_id", "sw"],
                                ("molec_id", "iso_row", "nu")])
def test_sort_matches_jax(by, descending):
    store, jstore = _pair()
    got = query.sort(store, by=by, descending=descending)
    _same_store(got, jquery.sort(jstore, by=by, descending=descending))


def test_extract_columns_and_stick_xy_match_jax():
    tbl = {"raw": [" 42  3.50 foo", " 7 -1.25 bar"]}
    for fix, fmts, names, t in (
            (False, ("%3d", "%6f", "%4s"), ("a", "b", "c"), tbl),
            (True, ("%3d", "%2s"), ("n", "s"),
             {"raw": ["123ab", "456cd"]})):
        got = query.extract_columns(t, "raw", fmts, names, fix_col=fix)
        want = jquery.extract_columns(t, "raw", fmts, names, fix_col=fix)
        assert list(got) == list(want)
        for k in names:
            np.testing.assert_array_equal(got[k], want[k])
    store, jstore = _pair(50, seed=86)
    for a, b in zip(query.stick_xy(store), jquery.stick_xy(jstore)):
        np.testing.assert_array_equal(a, b)


def test_save_table_bytes_and_cross_read(tmp_path):
    store, jstore = _pair(150, seed=87)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    hapi_db.save_table(store, str(tmp_path / "p"), "t")
    jdb.save_table(jstore, str(tmp_path / "j"), "t")
    for ext in (".data", ".header"):
        assert _bytes(tmp_path / "p" / ("t" + ext)) == \
            _bytes(tmp_path / "j" / ("t" + ext))
    back = hapi_db.load_table(str(tmp_path / "j" / "t.data"), device="cpu")
    _same_store(back, jdb.load_table(str(tmp_path / "p" / "t.data")))
    cols = hapi_db.load_table_columns(str(tmp_path / "j" / "t.data"))
    jcols = jdb.load_table_columns(str(tmp_path / "p" / "t.data"))
    for k in jcols:
        np.testing.assert_array_equal(cols[k], jcols[k])
    assert json.loads(_bytes(tmp_path / "p" / "t.header"))[
        "number_of_rows"] == 150


def test_write_par_bytes_and_cross_read(tmp_path):
    store, jstore = _pair(120, seed=88)
    a, b = str(tmp_path / "p.par"), str(tmp_path / "j.par")
    hapi_db.write_par(store, a)
    jdb.write_par(jstore, b)
    assert _bytes(a) == _bytes(b)
    assert all(len(r) == 160 for r in open(a).read().splitlines())
    _same_store(parse_par(b, device="cpu", dtype=F64, native=False),
                jparse_par(a, native=False))


def test_hapi_database_matches_jax(tmp_path):
    store, jstore = _pair(40, seed=89)
    d = str(tmp_path)
    hapi_db.write_par(store, os.path.join(d, "lines.par"))
    db, jdbase = hapi_db.HapiDatabase(d, device="cpu"), jdb.HapiDatabase(d)
    path = db.commit("t1", store)
    assert _bytes(path) == _bytes(jdb.save_table(jstore, d, "t2"))
    assert db.table_names() == jdbase.table_names() == ["lines", "t1", "t2"]
    assert db.load("t1") is store  # commit registered it
    other = hapi_db.HapiDatabase(d, device="cpu")
    for name in other.table_names():
        _same_store(other.load(name), jdbase.load(name))
        assert other.describe(name) == jdbase.describe(name)
    other = hapi_db.HapiDatabase(d, device="cpu")
    assert other.load("t2", dtype=torch.float32).sw.dtype == torch.float32
    with pytest.raises(FileNotFoundError):
        other.load("absent")
    with pytest.raises(KeyError):
        other.commit("absent")


def test_hapi_db_verbs_files_match_jax(tmp_path):
    """db_begin/select/db_commit through both drop-ins: the committed files
    are byte-identical, and each package's db_begin reads the other's."""
    store, jstore = _pair(60, seed=7, nu_min=990.0, nu_max=1030.0)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    hapi_db.save_table(store, str(tmp_path / "p"), "syn")
    jdb.save_table(jstore, str(tmp_path / "j"), "syn")
    for mod in (hc, jhc):
        for reg in (mod._TABLES, mod._EXTRAS, mod._META):
            reg.clear()
    hc.db_begin(str(tmp_path / "p"), device="cpu")
    jhc.db_begin(str(tmp_path / "j"))
    cond = ("between", "nu", 1000.0, 1010.0)
    hc.select("syn", DestinationTableName="band", Conditions=cond)
    jhc.select("syn", DestinationTableName="band", Conditions=cond)
    hc.db_commit()
    jhc.db_commit()
    for name in ("syn", "band"):
        for ext in (".data", ".header"):
            assert _bytes(tmp_path / "p" / (name + ext)) == \
                _bytes(tmp_path / "j" / (name + ext))
    hc._TABLES.clear()
    hc.db_begin(str(tmp_path / "j"), device="cpu")
    jhc._TABLES.clear()
    jhc.db_begin(str(tmp_path / "p"))
    assert hc.tableList() == jhc.tableList() == ["band", "syn"]
    for name in hc.tableList():
        _same_store(hc._get_table(name), jhc._get_table(name))


def test_to_hapi_cache_matches_jax():
    store, jstore = _pair(80, seed=91)
    ours = types.SimpleNamespace(LOCAL_TABLE_CACHE={})
    theirs = types.SimpleNamespace(LOCAL_TABLE_CACHE={})
    to_hapi_cache(store, "t", ours)
    jto_hapi_cache(jstore, "t", theirs)
    got, want = ours.LOCAL_TABLE_CACHE["t"], theirs.LOCAL_TABLE_CACHE["t"]
    assert got["header"] == want["header"]
    assert list(got["data"]) == list(want["data"])
    for k, v in want["data"].items():
        assert got["data"][k].dtype == v.dtype
        np.testing.assert_array_equal(got["data"][k], v, err_msg=k)


def test_fetch_urls_and_parlists_match_jax():
    for args, kw in ((([1, 2, 4], 690.0, 1410.0), {}),
                     (([1], 690.0, 1410.0), {"pargroups": ["sdvoigt"]}),
                     (([7, 8], 0.5, 1.5), {"params": ["y_air", "SD_air"],
                                           "host": "http://example.org"})):
        assert fetch.build_query_url(*args, **kw) == \
            jfetch.build_query_url(*args, **kw)
    for group in jfetch.PARAMETER_GROUPS:
        for dotpar in (True, False):
            assert fetch.prepare_parlist([group], dotpar=dotpar) == \
                jfetch.prepare_parlist([group], dotpar=dotpar)
    assert fetch.PARAMETER_GROUPS == jfetch.PARAMETER_GROUPS
    assert fetch._global_ids(2, [1, 2, 3]) == jfetch._global_ids(2, [1, 2, 3])


def _payload(tmp_path):
    store, _ = _pair(40, seed=13, nu_min=900.0, nu_max=950.0)
    path = tmp_path / "lines.par"
    hapi_db.write_par(store, str(path))
    par_rows = path.read_text().splitlines()
    rng = np.random.default_rng(2)
    perm = rng.permutation(len(par_rows))
    sd = rng.uniform(0.05, 0.2, len(par_rows))
    dp = rng.normal(0.0, 1e-5, len(par_rows))
    rows = [f"{par_rows[i]},{dp[i]:.6E},{sd[i]:.4f}" for i in perm]
    # a duplicated line centre (stable order) and hapi's missing markers
    rows.append(rows[3].rsplit(",", 2)[0] + ",1.0E-06,0.0900")
    rows[0] = rows[0].rsplit(",", 2)[0] + ",#,"
    return "\n".join(rows) + "\n"


@pytest.mark.parametrize("parlist", [["par_line", "deltap_air", "SD_air"],
                                     ["par_line", "deltap_air", "y_self"]])
def test_parse_custom_payload_matches_jax(tmp_path, parlist):
    text = _payload(tmp_path)
    store, extras = fetch.parse_custom_payload(text, parlist, device="cpu")
    jstore, jextras = jfetch.parse_custom_payload(text, parlist)
    _same_store(store, jstore)
    assert list(extras) == list(jextras)
    for k in jextras:
        np.testing.assert_array_equal(extras[k], jextras[k], err_msg=k)
    with pytest.raises(ValueError, match="par_line"):
        fetch.parse_custom_payload(text, ["deltap_air"], device="cpu")


def test_fetch_offline_raises_connection_error(monkeypatch):
    monkeypatch.setattr(hc, "_DEVICE", torch.device("cpu"))
    calls = []

    def refuse(url, timeout=None):
        calls.append(url)
        raise OSError("network is unreachable")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    for mod, kw in ((fetch, {"device": "cpu"}), (jfetch, {})):
        with pytest.raises(ConnectionError, match="HITRAN fetch failed"):
            mod.fetch(2, [1, 2], 690.0, 700.0, **kw)
        with pytest.raises(ConnectionError, match="HITRAN fetch failed"):
            mod.fetch_by_ids([1], 690.0, 700.0, pargroups=["sdvoigt"], **kw)
    assert calls[0] == calls[2] and calls[1] == calls[3]
    for reg in (hc._TABLES, hc._EXTRAS):
        reg.clear()
    with pytest.raises(ConnectionError):
        hc.fetch("t", 1, 1, 690.0, 700.0)
    assert "t" not in hc.tableList()
