"""The port's host-side entry points on card tensors, the builders' work
report, and JAX's public signatures, against radtxfr_tpu.

Card tensors. A CUDA tensor refuses ``np.asarray`` (its ``__array__``
raises), where a ``jax.Array`` on a device converts. :func:`card_like`
makes every tensor refuse it the same way, so that on the CPU each entry
point that takes a tensor a user may hand it (the port's own products,
which live on the card) is held to copying through
``radtxfr_tpu_torch.as_numpy``. Under it, each entry point takes tensors
made from NumPy-seeded float64 inputs and its result is held against
JAX's on the same NumPy inputs (1e-12 relative; ``make_tud_fn``'s K2 is
float32 in both packages, 5e-6 of peak as ``tests/test_pallas_tud.py:64``)
and bit for bit against the port's own call on the host copies. The files
(``write_h5``, ``write_batch``, ``write_tile``, ``xs_write``) are read
back and held bit for bit against JAX's files of the same arrays, and the
HDF5 and AFIT_XS bytes are compared whole (``np.savez`` stamps the time
into its zip entries, so the ``.npz`` files compare by their arrays).

Work reports. Each builder's ``work_report`` lists the plan work of its
passes as JAX's lists its Pallas calls, entry for entry and integer-exact
(planning is host-only in both packages: no kernel runs).
"""

import contextlib
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radtxfr_tpu.atmos.far_wing as j_far_wing
import radtxfr_tpu.atmos.regrid as j_regrid
import radtxfr_tpu.dist.checkpoint as j_ckpt
import radtxfr_tpu.io.afit_xs as j_afit
import radtxfr_tpu.io.h5 as j_h5
import radtxfr_tpu.kernels.pallas_xsect as j_px
import radtxfr_tpu.products.od as j_od
import radtxfr_tpu.scene.emissivity as j_emis
import radtxfr_tpu.sensor.ils as j_ils
import radtxfr_tpu.sensor.resolution as j_res
from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
from radtxfr_tpu.atmos.profile import AtmosphericState as JState
from radtxfr_tpu.kernels.ht_driver import resolve_ht_columns as j_resolve
from radtxfr_tpu.kernels.lineparams import LineParams as JLineParams
from radtxfr_tpu.kernels.linemixing_data import \
    y_air_for_store as j_y_air_for_store
from radtxfr_tpu.lines.derived import derived_lwir_linelist as j_derived
from radtxfr_tpu.lines.store import from_arrays as j_from_arrays
from radtxfr_tpu.lines.synthetic import synthetic_lines as j_synthetic
from radtxfr_tpu.products.tud import make_tud_pallas_fn

from radtxfr_tpu_torch import as_numpy
from radtxfr_tpu_torch.atmos import far_wing, regrid
from radtxfr_tpu_torch.atmos.profile import (AtmosphericState,
                                             std_atmosphere)
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.dist import checkpoint
from radtxfr_tpu_torch.io import afit_xs, h5
from radtxfr_tpu_torch.kernels import fused_xsect
from radtxfr_tpu_torch.kernels.ht_driver import resolve_ht_columns
from radtxfr_tpu_torch.kernels.htp_real import (ht_line_constants,
                                                pcqsdhc_real)
from radtxfr_tpu_torch.kernels.faddeeva import weideman_coeffs
from radtxfr_tpu_torch.kernels.lineparams import LineParams
from radtxfr_tpu_torch.kernels.linemixing_data import y_air_for_store
from radtxfr_tpu_torch.lines.derived import derived_lwir_linelist
from radtxfr_tpu_torch.lines.store import IsoTables, from_arrays
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
from radtxfr_tpu_torch.products import od
from radtxfr_tpu_torch.products.tud import make_tud_fn
from radtxfr_tpu_torch.scene import emissivity
from radtxfr_tpu_torch.sensor import ils, resolution
from port_fixtures import one_torch_thread  # noqa: F401

F64 = dict(device="cpu", dtype=torch.float64)
#: float64 agreement with JAX's NumPy and float64 code
REL = 1e-12
#: K2 (float32 in both packages) against JAX's, of peak
K2_BOUND = 5e-6


@contextlib.contextmanager
def card_like():
    """Every tensor refuses ``np.asarray`` while the block runs, as a CUDA
    tensor does (``as_numpy`` copies through ``.cpu().numpy()``, which
    still works)."""
    def refuse(self, *args, **kwargs):
        raise TypeError(f"can't convert {self.device} tensor to numpy "
                        "(a card tensor's refusal, imitated)")

    orig = torch.Tensor.__array__
    torch.Tensor.__array__ = refuse
    try:
        yield
    finally:
        torch.Tensor.__array__ = orig


def t64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def assert_rel(got, want, bound=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= bound, err


def assert_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def test_card_like_refuses_np_asarray_and_as_numpy_copies():
    t = t64([1.0, 2.0])
    with card_like():
        with pytest.raises(TypeError):
            np.asarray(t)
        assert_bits(as_numpy(t), np.array([1.0, 2.0]))
        assert as_numpy(t, np.float32).dtype == np.float32
    assert_bits(np.asarray(t), np.array([1.0, 2.0]))


# ---------------------------------------------------------------------------
# (a) the host-side entry points on card-like tensors
# ---------------------------------------------------------------------------

def _lines(n=80, lo=795.0, hi=835.0, seed=11, frac=0.3):
    kw = dict(nu_min=lo, nu_max=hi, seed=seed, sd_zero_frac=frac)
    return j_synthetic(n, **kw), synthetic_lines(n, **kw, **F64)


def _spectrum(n=2401, lo=700.0, hi=1340.0, seed=0, cols=3):
    rng = np.random.default_rng(seed)
    X = np.linspace(lo, hi, n)
    Y = (1.0 + 0.5 * np.sin(X[:, None] / (3.0 + np.arange(cols)))
         + 0.1 * rng.random((n, cols)))
    return X, Y


def case_make_tud_fn():
    rng = np.random.default_rng(1)
    n_lay, n_x = 8, 512
    z0 = np.linspace(0.0, 40.0, n_lay)
    alts, mu = np.array([0.5, 6.0, 500.0]), np.array([1.0, 1.4])
    T = (230.0 + 60.0 * rng.random(n_lay)).astype(np.float32)
    od_ = (0.2 * rng.random((n_lay, n_x))).astype(np.float32)
    x = np.linspace(800.0, 900.0, n_x)
    args = (torch.as_tensor(x), torch.as_tensor(od_), torch.as_tensor(T))
    kw = dict(n_angles=6, device="cpu")
    with card_like():
        got = make_tud_fn(t64(z0), t64(alts), mu=t64(mu), **kw)(*args)
    host = make_tud_fn(z0, alts, mu=mu, **kw)(*args)
    want = make_tud_pallas_fn(z0, alts, mu=mu, n_angles=6,
                              interpret=True)(x, od_, T)
    for name in ("tau", "Lu", "Ld"):
        assert_bits(getattr(got, name), getattr(host, name))
        assert_rel(getattr(got, name), getattr(want, name), K2_BOUND)


def case_reduce_resolution():
    X, Y = _spectrum()
    with card_like():
        x_out, got = resolution.reduce_resolution(t64(X), t64(Y), 1.0)
    jx, want = j_res.reduce_resolution(X, jnp.asarray(Y), 1.0)
    assert_rel(x_out, jx)
    assert_rel(got, want)
    assert_bits(got, resolution.reduce_resolution(X, t64(Y), 1.0)[1])


def case_reduce_operator():
    X, Y = _spectrum()
    with card_like():
        op = resolution.reduce_operator(t64(X), 1.0, device="cpu")
        got = op(t64(Y))
    j_op = j_res.reduce_operator(X, 1.0)
    assert_rel(op.x_out, j_op.x_out)
    assert_rel(got, j_op(jnp.asarray(Y)))
    assert_bits(got, resolution.reduce_operator(X, 1.0, device="cpu")(
        t64(Y)))


def case_ils_mako():
    X, Y = _spectrum()
    with card_like():
        x_out, got = ils.ils_mako(t64(X), t64(Y))
        simple_x, simple = ils.ils_mako_simple(t64(X), t64(Y))
    jx, want = j_ils.ils_mako(X, jnp.asarray(Y))
    assert_rel(x_out, jx)
    assert_rel(got, want)
    assert_rel(simple, j_ils.ils_mako_simple(X, jnp.asarray(Y))[1])
    assert_bits(got, ils.ils_mako(X, t64(Y))[1])


def case_write_h5(tmp_path):
    X, Y = _spectrum(n=300)
    with card_like():
        h5.write_h5(str(tmp_path / "p.h5"), {
            "X": t64(X), "Y": h5.Var(t64(Y), units="W", name="radiance"),
            "n": torch.arange(5, dtype=torch.int32)}, attrs={"run": "a"})
    j_h5.write_h5(str(tmp_path / "j.h5"), {
        "X": X, "Y": j_h5.Var(Y, units="W", name="radiance"),
        "n": np.arange(5, dtype=np.int32)}, attrs={"run": "a"})
    got, want = h5.read_h5(str(tmp_path / "p.h5")), j_h5.read_h5(
        str(tmp_path / "j.h5"))
    assert set(got) == set(want) == {"X", "Y", "n"}
    for k in got:
        assert_bits(got[k].data, want[k].data)
        assert (got[k].units, got[k].name) == (want[k].units, want[k].name)
    assert (tmp_path / "p.h5").read_bytes() == (tmp_path / "j.h5").read_bytes()


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {"tau": rng.random((2, 40, 3)),
            "Ld": rng.random((2, 40)).astype(np.float32),
            "idx": np.arange(2, dtype=np.int64)}


def case_write_batch(tmp_path):
    arrays = _arrays(2)
    ck = checkpoint.EnsembleCheckpoint(str(tmp_path / "p"), 4, 2)
    jck = j_ckpt.EnsembleCheckpoint(str(tmp_path / "j"), 4, 2)
    with card_like():
        ck.write_batch(1, {k: torch.as_tensor(v) for k, v in arrays.items()})
    jck.write_batch(1, arrays)
    got, want = ck.read_batch(1), jck.read_batch(1)
    # JAX's checkpoint reads the port's file
    cross = j_ckpt.EnsembleCheckpoint(str(tmp_path / "p"), 4, 2).read_batch(1)
    assert set(got) == set(want) == set(cross) == set(arrays)
    for k in arrays:
        assert_bits(got[k], want[k])
        assert_bits(cross[k], arrays[k])
    assert ck.pending == [0]


def case_write_tile(tmp_path):
    arrays = _arrays(3)
    ck = checkpoint.TiledCheckpoint(str(tmp_path / "p"), 4, 2, 2)
    jck = j_ckpt.TiledCheckpoint(str(tmp_path / "j"), 4, 2, 2)
    with card_like():
        ck.write_tile(0, 1, {k: torch.as_tensor(v)
                             for k, v in arrays.items()})
    jck.write_tile(0, 1, arrays)
    got, want = ck.read_tile(0, 1), jck.read_tile(0, 1)
    assert set(got) == set(want) == set(arrays)
    for k in arrays:
        assert_bits(got[k], want[k])
    assert ck.pending == [(0, 0), (1, 0), (1, 1)]


def case_xs_write(tmp_path):
    X = np.linspace(800.0, 810.0, 1001)
    Y = np.random.default_rng(4).random(1001) * 1e-20
    with card_like():
        p = afit_xs.xs_write(t64(X), t64(Y), torch.tensor(280.0),
                             torch.tensor(101325.0), torch.tensor(2),
                             "HITRAN", fname=str(tmp_path / "p.bin"))
    j = j_afit.xs_write(X, Y, 280.0, 101325.0, 2, "HITRAN",
                        fname=str(tmp_path / "j.bin"))
    with open(p, "rb") as f, open(j, "rb") as g:
        assert f.read() == g.read()
    gx, gy, gm = afit_xs.xs_read(p)
    jx, jy, jm = j_afit.xs_read(j)
    assert_bits(gx, jx)
    assert_bits(gy, jy)
    assert gm == jm


def case_regrid_profiles():
    rng = np.random.default_rng(5)
    z_src = np.linspace(0.0, 60.0, 30)
    T = 220.0 + 60.0 * rng.random((3, 30))
    h2o = 1e-3 * rng.random((3, 30))
    o3 = 1e-6 * rng.random((3, 30))
    with card_like():
        got = regrid.regrid_profiles(t64(z_src), T=t64(T), h2o=t64(h2o),
                                     o3=t64(o3), **F64)
    want = j_regrid.regrid_profiles(z_src, T=T, h2o=h2o, o3=o3,
                                    dtype=jnp.float64)
    for f in ("z0", "pl", "p", "T", "vmr"):
        assert_rel(getattr(got, f), getattr(want, f))


def case_emissivity_resample():
    X_new = np.linspace(700.5, 1400.5, 350)
    db = emissivity.synthetic_db(6, seed=3, **F64)
    with card_like():
        got = db.resample(t64(X_new))
    want = j_emis.synthetic_db(6, seed=3).resample(X_new)
    assert_rel(got.X, want.X)
    assert_rel(got.emis, want.emis)
    assert_bits(got.emis, db.resample(X_new).emis)


def case_od_bounds(iso_tables):
    """wing_bound_matrix, core_wing_per_line, core_y_matrix and
    sdvoigt_core_bound (through ``_gd_coeff``) on the port's own (tensor)
    lines, isotopologue tables and state."""
    j_store, store = _lines()
    iso = IsoTables.load(**F64)
    j_atm, atm = j_std_atmosphere(), std_atmosphere(**F64)
    with card_like():
        got = [od.wing_bound_matrix(store, iso, atm, wing_abs=1.0),
               od.wing_bound_matrix(store, iso, atm, vmr_margin=None),
               od.core_wing_per_line(store, iso, atm),
               od.core_y_matrix(store, iso, atm),
               od.sdvoigt_core_bound(store, iso, atm)]
    want = [j_od.wing_bound_matrix(j_store, iso_tables, j_atm, wing_abs=1.0),
            j_od.wing_bound_matrix(j_store, iso_tables, j_atm,
                                   vmr_margin=None),
            j_od.core_wing_per_line(j_store, iso_tables, j_atm),
            j_od.core_y_matrix(j_store, iso_tables, j_atm),
            j_od.sdvoigt_core_bound(j_store, iso_tables, j_atm)]
    for g, w in zip(got, want):
        assert_rel(g, w)


def case_ht_wing_bounds(iso_tables):
    j_store, store = _lines()
    extras = {"eta_HT_air": np.full(len(store), 0.2)}
    diluent = {"air": 0.8, "self": 0.2}
    T, p = np.array([220.0, 260.0, 300.0]), np.array([0.1, 0.5, 1.0])
    iso = IsoTables.load(**F64)
    with card_like():
        got = od.ht_wing_bounds(resolve_ht_columns(store, extras, diluent),
                                store, iso, t64(T), t64(p), wing_hw=40.0)
    want = j_od.ht_wing_bounds(j_resolve(j_store, extras, diluent),
                               j_store.host_view(), iso_tables, T, p,
                               wing_hw=40.0)
    assert_rel(got, want)


def case_sweep_constructors():
    """Sites the sweep repaired beyond the named entry points: the line
    store from columns, the state and isotopologue tables from fields, and
    the mixing coefficients aligned with a store."""
    j_store, store = _lines()
    h = store.host_view()
    cols = dict(nu0=h.nu0, sw=h.sw, elower=h.elower,
                gamma_air=h.gamma_air, gamma_self=h.gamma_self,
                n_air=h.n_air, delta_air=h.delta_air,
                mol_id=h.mol_id, local_iso_id=np.ones(len(store), np.int64))
    with card_like():
        got = from_arrays(**{k: torch.as_tensor(v) for k, v in cols.items()},
                          **F64)
        atm = AtmosphericState.from_numpy(
            **{f: getattr(std_atmosphere(**F64), f)
               for f in ("z0", "z1", "pl", "p", "T", "vmr")}, **F64)
        y = y_air_for_store(store)
    want = j_from_arrays(**cols)
    for f in ("nu0", "sw", "gamma_air", "iso_row", "mol_id"):
        assert_bits(as_numpy(getattr(got, f)).astype(np.float64),
                    np.asarray(getattr(want, f), np.float64))
    assert_bits(as_numpy(atm.T), as_numpy(std_atmosphere(**F64).T))
    assert_rel(y, j_y_air_for_store(j_store))
    # a float32 store (as on the card) matches the Q-branch lines by its
    # float64 host centres
    der = derived_lwir_linelist(715.0, 730.0, device="cpu",
                                dtype=torch.float32)
    with card_like():
        y32 = y_air_for_store(der)
    assert np.count_nonzero(y32) > 0
    assert_rel(y32, j_y_air_for_store(j_derived(715.0, 730.0)))


CARD_CASES = {
    "make_tud_fn": case_make_tud_fn,
    "reduce_resolution": case_reduce_resolution,
    "reduce_operator": case_reduce_operator,
    "ils_mako": case_ils_mako,
    "write_h5": case_write_h5,
    "write_batch": case_write_batch,
    "write_tile": case_write_tile,
    "xs_write": case_xs_write,
    "regrid_profiles": case_regrid_profiles,
    "emissivity_resample": case_emissivity_resample,
    "od_bounds": case_od_bounds,
    "ht_wing_bounds": case_ht_wing_bounds,
    "sweep_constructors": case_sweep_constructors,
}


@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_entry_point_takes_card_tensors(name, tmp_path, iso_tables):
    case = CARD_CASES[name]
    wants = inspect.signature(case).parameters
    case(**{k: v for k, v in (("tmp_path", tmp_path),
                              ("iso_tables", iso_tables)) if k in wants})


# ---------------------------------------------------------------------------
# (b) the builders' work reports against JAX's
# ---------------------------------------------------------------------------

def _od_case(config, iso_tables):
    """(JAX builder, port builder) of make_od_fn in ``config``."""
    if config == "coarse_far":
        j_store, store = _lines(400, 500.0, 700.0, seed=4, frac=0.3)
        axis = arange_drift_free(480.0, 720.0, 0.01)
        kw = dict(wing_abs=25.0, far_method="coarse", coarse_r=16)
    else:
        j_store, store = _lines(300, 795.0, 835.0, seed=12)
        axis = arange_drift_free(800.0, 830.0, 0.005)
        kw = {}
        if config == "mixing":
            y = np.zeros(len(store))
            y[::4] = np.random.default_rng(6).uniform(-0.02, 0.02,
                                                      y[::4].size)
            kw = dict(line_mixing={"y_air": y})
        elif config == "sdvoigt":
            kw = dict(profile="sdvoigt")
    j_fn = j_od.make_od_pallas_fn(j_store, iso_tables, axis,
                                  j_std_atmosphere(), **kw)
    fn = od.make_od_fn(store, IsoTables.load(**F64), axis,
                       std_atmosphere(**F64), **kw)
    return j_fn, fn


@pytest.mark.parametrize("config", ["two_pass", "mixing", "coarse_far",
                                    "sdvoigt"])
def test_make_od_fn_work_report_matches_jax(config, iso_tables):
    j_fn, fn = _od_case(config, iso_tables)
    assert fn.work_report == j_fn.work_report
    modes = {r["mode"] for r in fn.work_report}
    want = {"two_pass": {"asym", "core"}, "mixing": {"mix"},
            "coarse_far": {"corr:16:voigt"}, "sdvoigt": {"sdvoigt_core"}}
    assert want[config] <= modes, modes
    # one entry per pass, in JAX's order: classic, coarse, correction
    assert [r["mode"] for r in fn.work_report] == [
        c[2] for c in (*fn.calls, *fn.coarse_calls, *fn.corr_calls)]


@pytest.mark.parametrize("far_method", ["classic", "coarse"])
def test_make_xsect_fn_work_report_matches_jax(far_method, iso_tables):
    j_store, store = _lines(300, 500.0, 700.0, seed=8)
    axis = arange_drift_free(560.0, 640.0, 0.01)
    T, p = [260.0, 296.0, 320.0], [0.8, 1.0, 0.9]
    kw = dict(profile="sdvoigt", wing_abs=30.0, far_method=far_method,
              coarse_r=16)
    j_fn = j_od.make_xsect_pallas_fn(j_store, iso_tables, axis, T, p, **kw)
    with card_like():
        fn = od.make_xsect_fn(store, IsoTables.load(**F64), axis, t64(T),
                              t64(p), **kw)
    assert fn.work_report == j_fn.work_report
    assert any(r["mode"].startswith("corr:") for r in fn.work_report) == \
        (far_method == "coarse")


def _ht_extras(n, seed=7):
    rng = np.random.default_rng(seed)
    on = np.arange(n) < n // 3
    return {"nu_HT_air": rng.uniform(0.01, 0.05, n) * on,
            "eta_HT_air": rng.uniform(0.1, 0.3, n) * on}


@pytest.mark.parametrize("far_method", ["classic", "coarse"])
def test_make_ht_fn_work_report_matches_jax(far_method, iso_tables):
    j_store, store = _lines(90, 520.0, 680.0, seed=31, frac=0.4)
    axis = arange_drift_free(560.0, 640.0, 0.01)
    T, p = [260.0, 296.0], [0.8, 1.0]
    kw = dict(extras=_ht_extras(90), far_method=far_method, coarse_r=16,
              wing_abs=30.0)
    j_fn = j_od.make_ht_pallas_fn(j_store, iso_tables, axis, T, p, **kw)
    fn = od.make_ht_fn(store, IsoTables.load(**F64), axis, T, p, **kw)
    assert fn.work_report == j_fn.work_report
    assert "ht" in {r["mode"] for r in fn.work_report}


@pytest.mark.parametrize("differentiable", [False, True])
def test_make_od_ht_fn_work_report_matches_jax(differentiable, iso_tables):
    j_store, store = _lines(120, 795.0, 835.0, seed=41, frac=0.3)
    axis = arange_drift_free(800.0, 830.0, 0.005)
    idx = np.linspace(0, 60, 5).astype(int)
    j_atm = j_std_atmosphere()
    cols = {f: np.asarray(getattr(j_atm, f))[idx]
            for f in ("z0", "z1", "pl", "p", "T", "vmr")}
    kw = dict(extras=_ht_extras(120), tile=128,
              differentiable=differentiable)
    j_fn = j_od.make_od_ht_pallas_fn(
        j_store, iso_tables, axis,
        JState(**{f: jnp.asarray(v) for f, v in cols.items()}), **kw)
    fn = od.make_od_ht_fn(store, IsoTables.load(**F64), axis,
                          AtmosphericState.from_numpy(**cols, **F64), **kw)
    assert fn.work_report == j_fn.work_report
    assert {"ht", "sdvoigt", "full"} <= {r["mode"] for r in fn.work_report}


def test_work_report_is_a_plain_attribute_set_at_build_time(iso_tables):
    """Built once with the builder, as JAX's function attribute: the same
    list object on every read, and no attribute on the per-shard OD
    (JAX's ``make_od_pallas_local_fn`` attaches none)."""
    _, fn = _od_case("two_pass", iso_tables)
    assert "work_report" in vars(fn)
    assert fn.work_report is fn.work_report
    _, store = _lines(60, 800.0, 830.0)
    local, _, _ = od.make_od_local_fn(store, IsoTables.load(**F64),
                                      arange_drift_free(800.0, 830.0, 0.01),
                                      std_atmosphere(**F64), 2)
    assert not hasattr(local, "work_report")


# ---------------------------------------------------------------------------
# (c) plan_executed_evals and _ops_per_eval against JAX's
# ---------------------------------------------------------------------------

OP_MODES = (list(fused_xsect.MODES) + ["ht"]
            + [f"corr:{r}:{v}" for r in (16, 64)
               for v in fused_xsect.CORR_VARIANTS])


@pytest.mark.parametrize("n_wei", [16, 24])
@pytest.mark.parametrize("mode", OP_MODES)
def test_ops_per_eval_matches_jax(mode, n_wei):
    assert fused_xsect._ops_per_eval(n_wei, mode) == \
        j_px._ops_per_eval(n_wei, mode)


def test_ops_per_eval_has_one_home_and_refuses_unknown_modes():
    assert od._ops_per_eval is fused_xsect._ops_per_eval
    for bad in ("voigt", "corr:16:lorentz"):
        with pytest.raises(ValueError):
            fused_xsect._ops_per_eval(16, bad)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n_lay", [1, 7])
def test_plan_executed_evals_matches_jax(packed, n_lay):
    rng = np.random.default_rng(9)
    nu0 = np.sort(rng.uniform(800.0, 840.0, 500))
    axis = arange_drift_free(800.0, 840.0, 0.005)
    if packed:
        w = rng.uniform(0.05, 2.0, nu0.size)
        args = dict(tile=256, block="auto")
        j_plan = j_px.plan_buckets_packed(nu0, j_px.UniformGrid.from_axis(
            axis), w, **args)
        plan = fused_xsect.plan_buckets_packed(
            t64(nu0), fused_xsect.UniformGrid.from_axis(axis), t64(w), **args)
    else:
        j_plan = j_px.plan_buckets(nu0, j_px.UniformGrid.from_axis(axis), 1.5,
                                   tile=512, block=64)
        plan = fused_xsect.plan_buckets(
            t64(nu0), fused_xsect.UniformGrid.from_axis(axis), 1.5,
            tile=512, block=64)
    got = fused_xsect.plan_executed_evals(plan, n_lay)
    assert isinstance(got, int)
    assert got == j_px.plan_executed_evals(j_plan, n_lay) > 0
    # the same plan on the device, its counts a tensor (card-like: one
    # that refuses np.asarray)
    dplan = fused_xsect.device_plan(plan, np.arange(nu0.size), nu0,
                                    device="cpu")
    with card_like():
        assert fused_xsect.plan_executed_evals(dplan, n_lay) == got


# ---------------------------------------------------------------------------
# (d)-(f) signatures
# ---------------------------------------------------------------------------

def test_line_params_positional_fields_match_jax():
    rng = np.random.default_rng(10)
    arrs = [rng.random(7) for _ in dataclasses.fields(JLineParams)]
    got = LineParams(*(torch.as_tensor(a) for a in arrs))
    want = JLineParams(*(jnp.asarray(a) for a in arrs))
    assert [f.name for f in dataclasses.fields(LineParams)] == \
        [f.name for f in dataclasses.fields(JLineParams)]
    for f in dataclasses.fields(JLineParams):
        assert_bits(as_numpy(getattr(got, f.name)),
                    np.asarray(getattr(want, f.name)))


CIA = ["cia_n2_rototranslational", "cia_o2_fundamental"]


@pytest.mark.parametrize("T", [None, 250.0])
@pytest.mark.parametrize("name", CIA)
def test_cia_numpy_route_matches_jax(name, T):
    """``xp=np`` (the default) takes and returns NumPy as JAX's does, at
    the default T_REF and another T; ``xp=torch`` gives the same values as
    tensors."""
    nu = np.linspace(-50.0, 2500.0, 4001)
    kw = {} if T is None else {"T": T}
    got = getattr(far_wing, name)(nu, **kw)
    want = getattr(j_far_wing, name)(nu, **kw)
    assert isinstance(got, np.ndarray)
    assert_rel(got, want)
    with card_like():
        tens = getattr(far_wing, name)(t64(nu), xp=torch, **kw)
        on_np = getattr(far_wing, name)(t64(nu), **kw)
    assert isinstance(tens, torch.Tensor)
    assert_rel(tens, want)
    assert_rel(on_np, want)


def test_pcqsdhc_real_fast_raises_and_keeps_jax_names():
    k = ht_line_constants(*(torch.full((2, 1), v, dtype=torch.float64)
                            for v in (1e-3, 0.07, 0.007, 0.0, 0.0, 0.02,
                                      0.1, 0.0)))
    L, a = weideman_coeffs(16)
    dnu = torch.linspace(-0.5, 0.5, 11, dtype=torch.float64)
    plain = pcqsdhc_real(dnu, k, a, L)
    assert torch.equal(plain, pcqsdhc_real(dnu, k, wei_a=a, wei_L=L))
    with pytest.raises(NotImplementedError):
        pcqsdhc_real(dnu, k, a, L, fast=True)
