"""The port's hapi drop-in (``radtxfr_tpu_torch/hapi_compat.py``) against
``radtxfr_tpu.hapi_compat`` on the CPU, both opening the same synthetic
table (``db_begin(dir, device="cpu")`` on the port's side).

Every case of ``tests/test_hapi_compat.py`` and
``tests/test_hapi_subsystems.py`` that needs no hapi oracle, held against
the JAX drop-in: the DB and table-editing verbs, the registry and its
printed listings, partition sums, the PROFILE_*/CPF families, the five
drivers (defaults, Components with abundance, IntensityThreshold,
GammaL="gamma_self", HITRAN_units=False, the Doppler LineShift quirk,
air/self diluents, the EnvDependences and partitionFunction hooks, the HT
columns and hooks, File= output), the abscoef aliases and read_hotw.
Spectra and convolutions are in ``test_torch_hapi_spectra.py``.

Tolerance: 1e-12 of the JAX result's peak in float64 (``BOUND``), every
case included. pcqsdhc cancels in PART4 beside its thresholds by up to
1.6e-8 of peak under a one-ulp change of an input (ROADMAP caveat); none of
these SD-Voigt, HT or profile cases lands there (they reach about 1e-14),
so none needs that bound. Each driver case prints the error it reaches.
"""

import numpy as np
import pytest
import torch

from radtxfr_tpu import hapi_compat as jhc
from radtxfr_tpu.lines import hapi_db as jdb
from radtxfr_tpu.lines.synthetic import synthetic_lines as jsynthetic

from radtxfr_tpu_torch import hapi_compat as hc
from radtxfr_tpu_torch.lines.store import LineStore
from port_fixtures import one_torch_thread  # noqa: F401

BOUND = 1e-12
GRID = np.arange(1000.0, 1020.0, 0.01)
COLUMNS = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
           "delta_air", "sd_air", "mol_id", "iso_row")


def _clear():
    for mod in (hc, jhc):
        for reg in (mod._TABLES, mod._EXTRAS, mod._META):
            reg.clear()


@pytest.fixture()
def db(tmp_path, monkeypatch):
    """Both drop-ins db_begin'd on one directory holding table 'syn'."""
    jdb.save_table(jsynthetic(60, 990.0, 1030.0, seed=7), str(tmp_path),
                   "syn")
    _clear()
    monkeypatch.setattr(hc, "_DEVICE", None)
    hc.db_begin(str(tmp_path), device="cpu")
    jhc.db_begin(str(tmp_path))
    yield tmp_path
    _clear()


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and isinstance(got, np.ndarray)
    peak = np.abs(want).max()
    return np.abs(got - want).max() / peak if peak else np.abs(got).max()


def _same_table(name):
    got, want = hc._get_table(name), jhc._get_table(name)
    assert isinstance(got, LineStore) and got.sw.device.type == "cpu"
    for c in COLUMNS:
        np.testing.assert_array_equal(got.host[c],
                                      np.asarray(getattr(want, c)),
                                      err_msg=f"{name}.{c}")
    assert set(hc._EXTRAS.get(name, {})) == set(jhc._EXTRAS.get(name, {}))
    for k, v in jhc._EXTRAS.get(name, {}).items():
        np.testing.assert_array_equal(hc._EXTRAS[name][k], v)


def _both(fn_name, *args, **kw):
    return (getattr(hc, fn_name)(*args, **kw),
            getattr(jhc, fn_name)(*args, **kw))


def _drivers(name, bound=BOUND, **kw):
    (nu, k), (nu_j, k_j) = _both(f"absorptionCoefficient_{name}", **kw)
    np.testing.assert_array_equal(nu, nu_j)
    err = _rel(k, k_j)
    print(f"{name}: {err:.3e} of peak")
    assert k.max() > 0 and err <= bound, (name, err)
    return k


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

def test_default_calls_need_a_card(tmp_path, monkeypatch):
    """Without a card a default call raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.setattr(hc, "_DEVICE", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hc.db_begin(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hc.PROFILE_VOIGT(1000.0, 0.005, 0.05, np.linspace(999, 1001, 11))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hc.radianceSpectrum(GRID, np.ones(GRID.size))


def test_tables_land_on_the_device_asked(db):
    store = hc._get_table("syn")
    assert store.sw.device.type == "cpu" and store.sw.dtype == torch.float64
    nu, k = hc.absorptionCoefficient_Voigt(SourceTables="syn",
                                           OmegaGrid=GRID)
    assert isinstance(nu, np.ndarray) and isinstance(k, np.ndarray)
    assert k.dtype == np.float64


# ---------------------------------------------------------------------------
# DB verbs
# ---------------------------------------------------------------------------

def test_db_verbs_match_jax(db, capsys):
    assert hc.tableList() == jhc.tableList() == ["syn"]
    assert hc.getTableList() == hc.tableList()
    a, b = _both("getColumn", "syn", "nu")
    assert a == b and len(a) == 60
    a, b = _both("getColumns", "syn", ["sw", "molec_id"])
    assert a == b
    assert hc.length("syn") == jhc.length("syn")
    cond = ("between", "nu", 1000.0, 1010.0)
    _both("select", "syn", Conditions=cond, DestinationTableName="band")
    _same_table("band")
    _both("sort", "syn", DestinationTableName="s", ParameterNames=["sw"],
          Accending=False)
    _same_table("s")
    _both("sort", "syn", DestinationTableName="s2",
          ParameterNames=["molec_id", "nu"])
    _same_table("s2")
    g, gj = _both("group", "syn", ParameterNames=[("COUNT",), ("SUM", "sw")],
                  GroupParameterNames=["molec_id"], Output=False)
    assert list(g) == list(gj)
    for k in gj:
        np.testing.assert_array_equal(g[k], gj[k])
    x, xj = _both("getStickXY", "syn")
    for a, b in zip(x, xj):
        np.testing.assert_array_equal(a, b)
    capsys.readouterr()
    hc.describeTable("syn")
    ours = capsys.readouterr().out
    jhc.describeTable("syn")
    assert ours == capsys.readouterr().out and "Number of rows: 60" in ours
    hc.describe("syn")
    assert capsys.readouterr().out == ours
    _both("filter", "syn", cond)
    _same_table("__BUFFER__")
    _both("dropTable", "band")
    assert hc.tableList() == jhc.tableList()


def test_select_output_and_file_match_jax(db, capsys):
    cond = ("<", "nu", 1000.0)
    capsys.readouterr()
    hc.select("syn", Conditions=cond, Output=True,
              ParameterNames=["molec_id", "nu", "sw"])
    ours = capsys.readouterr().out
    jhc.select("syn", Conditions=cond, Output=True,
               ParameterNames=["molec_id", "nu", "sw"])
    assert ours == capsys.readouterr().out and ours.strip()
    a, b = str(db / "a.txt"), str(db / "b.txt")
    hc.select("syn", Conditions=cond, File=a)
    jhc.select("syn", Conditions=cond, File=b)
    assert open(a).read() == open(b).read()


def test_select_into_appends_with_duplicate_centres(db):
    """selectInto appends and re-sorts stably: a row whose centre equals
    one already present keeps its arrival order, on both sides."""
    for mod in (hc, jhc):
        mod.selectInto("sel", "syn", ["nu", "sw"],
                       ("between", "nu", 1000.0, 1010.0))
        mod.selectInto("sel", "syn", ["nu", "sw"],
                       ("between", "nu", 1005.0, 1020.0))
    _same_table("sel")
    nu = hc._get_table("sel").host["nu0"]
    assert (np.diff(nu) >= 0).all() and (np.diff(nu) == 0).any()


def test_db_commit_and_cache_roundtrip(db):
    _both("select", "syn", Conditions=("between", "nu", 1000.0, 1010.0))
    hc.saveCache()
    assert "__BUFFER__" not in hc.tableList()
    hc._TABLES.clear()
    hc.loadCache()
    assert hc.tableList() == ["syn"]
    assert hc._get_table("syn").sw.device.type == "cpu"
    _same_table("syn")
    hc.databaseCommit()
    hc.databaseBegin(str(db), device="cpu")
    _same_table("syn")


# ---------------------------------------------------------------------------
# table editing
# ---------------------------------------------------------------------------

def test_column_verbs_match_jax(db):
    for mod in (hc, jhc):
        col = mod.addColumn("syn", "tag", Expression=("*", "nu", 2.0))
        mod.addColumn("syn", "flag", Type=int, Default=3)
        mod.addColumn("syn", "w", Before="flag")
        mod.addColumn("syn", "ln", Expression=("+", "LineNumber", 1))
    np.testing.assert_array_equal(hc._EXTRAS["syn"]["tag"],
                                  jhc._EXTRAS["syn"]["tag"])
    assert hc._META["syn"] == jhc._META["syn"]
    _same_table("syn")
    for mod in (hc, jhc):
        mod.renameColumn("syn", "tag", "nu2")
        mod.deleteColumns("syn", ["flag", "w"])
        with pytest.raises(ValueError):
            mod.deleteColumn("syn", "nu")
        with pytest.raises(ValueError):
            mod.renameColumn("syn", "sw", "s")
        with pytest.raises(ValueError):
            mod.addColumn("syn", "nu2")
        with pytest.raises(KeyError):
            mod.deleteColumn("syn", "missing")
    assert hc._META["syn"] == jhc._META["syn"]
    _same_table("syn")


def test_row_verbs_match_jax(db):
    for mod in (hc, jhc):
        mod.addColumn("syn", "twice_nu", Expression=("*", "nu", 2.0))
        mod.deleteRows("syn", Conditions=(">", "nu", 1015.0))
        mod.arrangeTable("syn", DestinationTableName="arr",
                         RowIDList=[5, 1, 3, 3])
        assert mod.deleteRows("syn") is mod._get_table("syn")
    _same_table("syn")
    _same_table("arr")
    np.testing.assert_array_equal(hc._EXTRAS["syn"]["twice_nu"],
                                  2.0 * hc._get_table("syn").host["nu0"])


def test_create_table_insert_row_match_jax(db):
    spec = [("molec_id", 1, "%2d"), ("local_iso_id", 1, "%1d"),
            ("nu", 0.0, "%12.6f"), ("sw", 0.0, "%10.3E"),
            ("elower", 0.0, "%10.4f"), ("gamma_air", 0.05, "%6.4f"),
            ("gamma_self", 0.3, "%6.4f"), ("n_air", 0.5, "%7.4f"),
            ("delta_air", 0.0, "%9.6f"), ("note", 0.0, "%5.1f")]
    for mod in (hc, jhc):
        mod.createTable("fresh", spec)
        assert mod.length("fresh") == 0
        mod.insertRow("fresh", {"nu": 1000.5, "sw": 1e-21, "note": 7.0})
        mod.insertRow("fresh", {"nu": 999.5, "sw": 2e-21}, molec_id=2)
        mod.insertRow("fresh", nu=999.5, sw=3e-21)   # a duplicate centre
        assert mod.insertRow() is None
    _same_table("fresh")
    assert hc._get_table("fresh").sw.device.type == "cpu"


def test_split_and_extract_columns_match_jax(db):
    n = hc.length("syn")
    for mod in (hc, jhc):
        mod._EXTRAS["syn"]["pair"] = np.asarray(
            [f"{i}|{i * 10}|x{i}" for i in range(n)], dtype=object)
        mod._EXTRAS["syn"]["raw"] = [f"{i:3d}{i * 0.5:6.2f}" for i in range(n)]
    got = hc.splitColumn("syn", "pair", ["a", "b", "c"], "|")
    want = jhc.splitColumn("syn", "pair", ["a", "b", "c"], "|")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    got = hc.extractColumns("syn", "raw", ["%3d", "%6f"], ["i", "h"],
                            FixCol=True)
    want = jhc.extractColumns("syn", "raw", ["%3d", "%6f"], ["i", "h"],
                              FixCol=True)
    for k in ("i", "h"):
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(KeyError):
        hc.splitColumn("syn", "absent", ["a"], "|")


# ---------------------------------------------------------------------------
# registry, partition sums, TIPS internals
# ---------------------------------------------------------------------------

def test_registry_matches_jax(capsys):
    for m, i in ((1, 1), (2, 1), (3, 1), (6, 3), (22, 1)):
        for name in ("abundance", "molecularMass", "isotopologueName"):
            a, b = _both(name, m, i)
            assert a == b
        a, b = _both("moleculeName", m)
        assert a == b
    # repr: the registry's NaN abundances of atoms compare unequal
    assert repr(hc.ISO) == repr(jhc.ISO)
    assert repr(hc.ISO_ID) == repr(jhc.ISO_ID)
    with pytest.raises(AttributeError):
        hc.NOT_A_NAME  # noqa: B018
    capsys.readouterr()
    for fn in ("print_iso", "print_iso_id"):
        getattr(hc, fn)()
        ours = capsys.readouterr().out
        getattr(jhc, fn)()
        assert ours == capsys.readouterr().out and len(ours) > 1000


def test_partition_sums_match_jax():
    for m, i, T in ((1, 1, 250.0), (2, 1, 296.0), (3, 1, 71.0),
                    (2, 2, 2999.0), (6, 1, 1234.5)):
        a, b = _both("partitionSum", m, i, T)
        assert isinstance(a, float) and abs(a - b) <= 1e-13 * abs(b)
        a, b = _both("PYTIPS", m, i, T)
        assert abs(a - b) <= 1e-13 * abs(b)
    a, b = _both("partitionSum", 2, 1, [250.0, 300.0])
    np.testing.assert_allclose(a, b, rtol=1e-13)
    (tt, q), (tt_j, q_j) = _both("partitionSum", 1, 1, [250.0, 260.0],
                                 step=2.0)
    np.testing.assert_array_equal(tt, tt_j)
    np.testing.assert_allclose(q, q_j, rtol=1e-13)


def test_tips_internals_match_jax():
    from radtxfr_tpu_torch.lines.tips import load_tips_tables

    _m, _i, _g, q = load_tips_tables()
    A = 60.0 + 25.0 * np.arange(q.shape[1])
    B = q[3]
    ts = np.array([70.5, 120.0, 296.0, 1234.5, 2999.0, 61.0])
    np.testing.assert_array_equal(hc.AtoB(ts, A, B, len(A)),
                                  jhc.AtoB(ts, A, B, len(A)))
    assert hc.AtoB(296.0, A, B, len(A)) == jhc.AtoB(296.0, A, B, len(A))
    (gi, qq), (gi_j, qq_j) = _both("BD_TIPS_2011_PYTHON", 2, 1, 296.0)
    assert gi == gi_j and abs(qq - qq_j) <= 1e-13 * qq_j
    for mod in (hc, jhc):
        with pytest.raises(Exception, match="70K"):
            mod.BD_TIPS_2011_PYTHON(2, 1, 50.0)
        with pytest.raises(Exception, match="no data"):
            mod.BD_TIPS_2011_PYTHON(99, 9, 296.0)


def test_environment_dependences_match_jax():
    rng = np.random.default_rng(3)
    a, b = rng.uniform(0.01, 0.1, 8), rng.uniform(900.0, 1100.0, 8)
    cases = [
        ("EnvironmentDependency_Intensity", (a, 280.0, 296.0, 170.0, 174.0,
                                             b, b)),
        ("EnvironmentDependency_GammaD", (a, 280.0, 296.0)),
        ("EnvironmentDependency_Gamma0", (a, 280.0, 296.0, 0.8, 1.0, 0.7)),
        ("EnvironmentDependency_Gamma2", (a, 280.0, 296.0, 0.8, 1.0, 0.7)),
        ("EnvironmentDependency_Delta0", (a, 0.8, 1.0)),
        ("EnvironmentDependency_Delta2", (a, 0.8, 1.0)),
        ("EnvironmentDependency_anuVC", (a, 280.0, 296.0, 0.8, 1.0)),
        ("volumeConcentration", (0.7, 250.0)),
    ]
    for name, args in cases:
        x, y = _both(name, *args)
        np.testing.assert_array_equal(x, y, err_msg=name)
    np.testing.assert_array_equal(hc.arange_(1000.0, 1020.0, 0.01),
                                  jhc.arange_(1000.0, 1020.0, 0.01))


# ---------------------------------------------------------------------------
# profiles / CPF
# ---------------------------------------------------------------------------

SG = np.arange(999.0, 1001.0, 0.001)
PROFILES = [
    ("PROFILE_HT", (1000.0, 0.005, 0.05, 0.01, 0.002, 0.0005, 0.01, 0.1)),
    ("PROFILE_HTP", (1000.0, 0.005, 0.05, 0.01, 0.002, 0.0005, 0.01, 0.1)),
    ("pcqsdhc", (1000.0, 0.005, 0.05, 0.01, 0.002, 0.0005, 0.01, 0.1)),
    ("PROFILE_SDRAUTIAN", (1000.0, 0.005, 0.05, 0.01, 0.002, 0.0005, 0.01)),
    ("PROFILE_RAUTIAN", (1000.0, 0.005, 0.05, 0.002, 0.01, 0.1)),
    ("PROFILE_SDVOIGT", (1000.0, 0.005, 0.05, 0.01, 0.002, 0.0005)),
    ("PROFILE_VOIGT", (1000.0, 0.005, 0.05)),
    ("PROFILE_LORENTZ", (1000.0, 0.05)),
    ("PROFILE_DOPPLER", (1000.0, 0.005)),
]


@pytest.mark.parametrize("name,args", PROFILES, ids=[p[0] for p in PROFILES])
def test_profiles_match_jax(name, args):
    got = getattr(hc, name)(*args, torch.as_tensor(SG))
    want = getattr(jhc, name)(*args, SG)
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == 2
        pairs = zip(got, want)
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        err = _rel(g, w)
        print(f"{name}: {err:.3e} of peak")
        assert err <= BOUND and g.dtype == np.float64


def test_profiles_per_line_parameters_match_jax():
    """Array-valued line parameters broadcast against the axis."""
    g0 = np.linspace(0.01, 0.1, SG.size)
    got = hc.PROFILE_VOIGT(1000.0, 0.005, torch.as_tensor(g0),
                           torch.as_tensor(SG))
    want = jhc.PROFILE_VOIGT(1000.0, 0.005, g0, SG)
    assert _rel(got[0], want[0]) <= BOUND


@pytest.mark.parametrize("name", ["cpf", "cpf3", "hum1_wei", "cef"])
def test_cpf_family_matches_jax(name):
    x = np.linspace(-14.0, 14.0, 401)
    y = np.full_like(x, 0.5)
    if name == "cpf3":
        x, y = np.linspace(10.0, 40.0, 101), np.full(101, 2.0)
    args = (24,) if name in ("hum1_wei", "cef") else ()
    got = getattr(hc, name)(torch.as_tensor(x), torch.as_tensor(y), *args)
    want = getattr(jhc, name)(x, y, *args)
    if name == "cef":
        assert got.dtype == np.complex128
        assert _rel(got, want) <= BOUND
        return
    for g, w in zip(got, want):
        assert _rel(g, w) <= BOUND, name


# ---------------------------------------------------------------------------
# absorption drivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["Voigt", "Lorentz", "Doppler"])
def test_drivers_defaults_match_jax(db, name):
    _drivers(name, SourceTables="syn", OmegaGrid=GRID,
             Environment={"T": 290.0, "p": 0.9})


@pytest.mark.parametrize("name", ["SDVoigt", "HT"])
def test_sd_and_ht_drivers_match_jax(db, name):
    _drivers(name, SourceTables="syn", OmegaGrid=GRID,
             Environment={"T": 290.0, "p": 0.9})


def test_driver_default_grid_and_range(db):
    _drivers("Voigt", SourceTables="syn", WavenumberRange=(1000.0, 1020.0),
             WavenumberStep=0.02)
    _drivers("Lorentz", SourceTables=["syn"], OmegaStep=0.05,
             OmegaWing=1.0, OmegaWingHW=20.0)


def test_driver_gamma_self_and_units(db):
    _drivers("Voigt", SourceTables="syn", OmegaGrid=GRID,
             GammaL="gamma_self", HITRAN_units=False,
             Environment={"T": 296.0, "p": 1.0})
    for mod in (hc, jhc):
        with pytest.raises(ValueError, match="GammaL"):
            mod.absorptionCoefficient_Voigt(SourceTables="syn",
                                            OmegaGrid=GRID, GammaL="bad")


def test_driver_components_and_abundance(db):
    _drivers("Voigt", Components=[(1, 1, 0.5)], SourceTables="syn",
             OmegaGrid=GRID)
    _drivers("Lorentz", Components=[(2, 1)], SourceTables="syn",
             OmegaGrid=GRID)
    _drivers("HT", Components=[(1, 1, 0.5), (3, 1)],
             SourceTables="syn", OmegaGrid=GRID)


def test_driver_intensity_threshold(db):
    k = _drivers("Voigt", SourceTables="syn", OmegaGrid=GRID,
                 IntensityThreshold=1e-23,
                 Environment={"T": 310.0, "p": 1.2})
    _, k_all = hc.absorptionCoefficient_Voigt(
        SourceTables="syn", OmegaGrid=GRID,
        Environment={"T": 310.0, "p": 1.2})
    assert np.abs(k - k_all).max() > 0     # the threshold cut some lines


def test_threshold_mask_matches_jax(db):
    """Thresholds between neighbouring scaled intensities cut the same
    lines as the JAX mask; the one at a line's own scaled intensity keeps
    that line (the host float64 mask is the same on every device)."""
    store, jstore = hc._get_table("syn"), jhc._get_table("syn")
    T = 275.0
    keep_all = hc._threshold_mask(store, T, 1e-300)
    assert keep_all.all()
    levels = np.sort(np.unique(store.host["sw"]))
    for t in np.sqrt(levels[:-1] * levels[1:])[::7]:
        np.testing.assert_array_equal(hc._threshold_mask(store, T, t),
                                      jhc._threshold_mask(jstore, T, t))
    np.testing.assert_array_equal(hc._threshold_mask(store, T, 0.0),
                                  np.ones(store.n_lines, dtype=bool))


def test_doppler_line_shift_quirk(db):
    _drivers("Doppler", SourceTables="syn", OmegaGrid=GRID, LineShift=False,
             Environment={"T": 296.0, "p": 1.0})
    # the other drivers accept LineShift and ignore it
    (_, k), (_, k0) = (hc.absorptionCoefficient_Voigt(
        SourceTables="syn", OmegaGrid=GRID, LineShift=ls) for ls in
        (False, True))
    np.testing.assert_array_equal(k, k0)


def test_driver_diluent_mix_and_exotic(db):
    _drivers("Voigt", SourceTables="syn", OmegaGrid=GRID,
             Diluent={"air": 0.7, "self": 0.3},
             Environment={"T": 290.0, "p": 0.9})
    # an exotic diluent routes the Voigt driver to the HT engine
    _drivers("Voigt", SourceTables="syn",
             OmegaGrid=GRID, Diluent={"air": 0.8, "co2": 0.2})
    for mod in (hc, jhc):
        with pytest.raises(NotImplementedError, match="co2"):
            mod.absorptionCoefficient_Lorentz(
                SourceTables="syn", OmegaGrid=GRID,
                Diluent={"air": 0.8, "co2": 0.2})


def _env_dep_voigt(Env, Line):
    out = {"gamma_air": 0.08 * (Env["p"] / Env["pref"])
           * (Env["Tref"] / Env["T"]) ** 0.6}
    if Line["nu"] > 1010.0:
        out["sw"] = Line["sw"] * 1.5   # raw-sw override, no T scaling
    return out


def _pf(M, I, T):
    return float(hc.PYTIPS(M, I, T)) * (T / 296.0)


def test_voigt_driver_hooks_match_jax(db):
    _drivers("Voigt", SourceTables="syn", OmegaGrid=GRID,
             Environment={"T": 280.0, "p": 0.8},
             EnvDependences=_env_dep_voigt)
    k = _drivers("Voigt", SourceTables="syn", OmegaGrid=GRID,
                 Environment={"T": 260.0, "p": 1.0}, partitionFunction=_pf,
                 IntensityThreshold=1e-24)
    _, k0 = hc.absorptionCoefficient_Voigt(
        SourceTables="syn", OmegaGrid=GRID,
        Environment={"T": 260.0, "p": 1.0})
    assert np.abs(k - k0).max() > 1e-3 * k0.max()
    # the Lorentz driver through the same hook path
    _drivers("Lorentz", SourceTables="syn", OmegaGrid=GRID,
             EnvDependences=_env_dep_voigt, HITRAN_units=False)


def test_sdvoigt_driver_hooks_with_self_diluent(db):
    def env_dep(Env, Line):
        return {"SD_self": 0.12 * Env["p"], "delta_air": 0.001}

    def pf(M, I, T):
        return float(hc.PYTIPS(M, I, T)) * (1.0 + T / 1000.0)

    _drivers("SDVoigt", SourceTables="syn",
             OmegaGrid=GRID, Environment={"T": 290.0, "p": 0.9},
             Diluent={"air": 0.7, "self": 0.3}, EnvDependences=env_dep,
             partitionFunction=pf)


def test_doppler_driver_ignores_env_dependences(db):
    def env_dep(Env, Line):
        raise AssertionError("must never be called")

    kw = dict(SourceTables="syn", Environment={"T": 280.0, "p": 0.8},
              OmegaGrid=GRID)
    _, k0 = hc.absorptionCoefficient_Doppler(**kw)
    k = _drivers("Doppler", EnvDependences=env_dep, **kw)
    np.testing.assert_array_equal(k, k0)
    # a custom partition function does take the hooked path there
    _drivers("Doppler", partitionFunction=_pf, LineShift=False, **kw)


def _ht_extras(store, rng):
    """HT parameter columns for every line (``test_hapi_subsystems``')."""
    n = store.n_lines
    g = store.host["gamma_air"]
    return {
        "gamma_HT_0_air_296": g * rng.uniform(0.9, 1.1, n),
        "n_HT_air_296": rng.uniform(0.4, 0.8, n),
        "delta_HT_0_air_296": rng.normal(0.0, 0.005, n),
        "deltap_HT_air_296": rng.normal(0.0, 1e-5, n),
        "gamma_HT_2_air_296": g * rng.uniform(0.05, 0.15, n),
        "delta_HT_2_air_296": rng.normal(0.0, 5e-4, n),
        "nu_HT_air": rng.uniform(0.0, 0.05, n),
        "kappa_HT_air": rng.uniform(0.0, 1.0, n),
        "eta_HT_air": rng.uniform(0.0, 0.3, n),
    }


def test_ht_driver_with_extras_and_hooks(db):
    extras = _ht_extras(hc._get_table("syn"), np.random.default_rng(91))
    for mod in (hc, jhc):
        mod._EXTRAS["syn"] = {k: v.copy() for k, v in extras.items()}
    kw = dict(SourceTables="syn", OmegaGrid=GRID,
              Environment={"T": 280.0, "p": 0.8})
    _drivers("HT", **kw)

    def env_dep(Env, Line):
        out = {"gamma_HT_2_air_296": 0.004 * Env["p"]}
        if Line["nu"] > 1010.0:
            out["deltap_air"] = -0.002 * Env["p"]       # Shift0T override
        return out

    def pf(M, I, T):
        return float(hc.PYTIPS(M, I, T)) * (T / 296.0) ** 0.5

    _drivers("HT", EnvDependences=env_dep,
             partitionFunction=pf, **kw)
    _drivers("HT", Diluent={"air": 0.6, "self": 0.4},
             EnvDependences=env_dep, **kw)


def test_driver_file_output(db):
    a, b = str(db / "a.txt"), str(db / "b.txt")
    hc.absorptionCoefficient_Voigt(SourceTables="syn", OmegaGrid=GRID,
                                   File=a)
    jhc.absorptionCoefficient_Voigt(SourceTables="syn", OmegaGrid=GRID,
                                    File=b)
    got, want = np.loadtxt(a), np.loadtxt(b)
    assert got.shape == (GRID.size, 2)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert _rel(got[:, 1], want[:, 1]) <= 1e-6     # the "%e" print's digits
    hc.absorptionCoefficient_Lorentz(SourceTables="syn", OmegaGrid=GRID,
                                     File=a, Format="%.4f %.10e")
    assert open(a).readline().startswith("1000.0000 ")


def test_abscoef_aliases_match_jax(db):
    for alias, driver in (("abscoef", "absorptionCoefficient_Lorentz"),
                          ("abscoef_Voigt", "absorptionCoefficient_Voigt"),
                          ("abscoef_Lorentz",
                           "absorptionCoefficient_Lorentz"),
                          ("abscoef_Doppler",
                           "absorptionCoefficient_Doppler")):
        _, k = getattr(hc, alias)(table="syn", grid=GRID)
        _, k0 = getattr(hc, driver)(SourceTables="syn", OmegaGrid=GRID)
        np.testing.assert_array_equal(k, k0)
        _, kj = getattr(jhc, alias)(table="syn", grid=GRID)
        assert _rel(k, kj) <= BOUND, alias
    _, k = hc.abscoef_HT(table="syn", grid=GRID,
                         env={"T": 300.0, "p": 1.0})
    _, kj = jhc.abscoef_HT(table="syn", grid=GRID,
                           env={"T": 300.0, "p": 1.0})
    assert _rel(k, kj) <= BOUND
    assert hc.abscoef_Gauss is hc.abscoef_Doppler
    assert hc.absorptionCoefficient_Gauss is hc.absorptionCoefficient_Doppler


def test_read_hotw_matches_jax(tmp_path):
    p = tmp_path / "xs.txt"
    p.write_text("# header line\n100.0 1.5e-20\n100.5 2.5e-20\nbad line\n"
                 "101.0\n")
    for a, b in zip(hc.read_hotw(str(p)), jhc.read_hotw(str(p))):
        np.testing.assert_array_equal(a, b)
    assert hc.read_xsect is hc.read_hotw
    q = tmp_path / "cols.txt"
    hc.save_to_file(str(q), "%.3f %.3e", [1.0, 2.0], [3.0, 4.0])
    assert q.read_text() == "1.000 3.000e+00\n2.000 4.000e+00\n"


def test_help_and_printers(capsys):
    capsys.readouterr()
    hc.getHelp()
    out = capsys.readouterr().out
    assert "radtxfr_tpu_torch.kernels" in out and "convolve_spectrum" in out
    hc.getHelp("planckian")
    assert "planckian" in capsys.readouterr().out
    for fn in ("print_slit_functions", "print_data_tutorial",
               "print_spectra_tutorial", "print_plotting_tutorial"):
        getattr(hc, fn)()
        ours = capsys.readouterr().out
        getattr(jhc, fn)()
        assert ours == capsys.readouterr().out, fn
    hc.print_profiles()
    ours = capsys.readouterr().out.splitlines()
    jhc.print_profiles()
    theirs = capsys.readouterr().out.splitlines()
    assert ours[2:] == theirs[2:]        # the names; the title differs
    hc.print_python_tutorial()
    assert "numpy arrays" in capsys.readouterr().out
    assert set(hc.__all__) == set(jhc.__all__)
