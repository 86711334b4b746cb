"""The port's reference-signature layer (``radtxfr_tpu_torch/compat.py``)
against ``radtxfr_tpu.compat`` on the CPU: ``tests/test_compat.py``'s
cases, both packages on the same seeded line list.

* Constants, ``StdAtmos``, the Planck trio (with the wavelength heuristic
  and ``spectral_dim``), the reshapes, ``ILS_MAKO``, ``reduceResolution``
  and ``compute_LWIR_apparent_radiance`` within 1e-12 of peak.
* ``compute_OD``/``compute_TUD``/``run_LBLRTM`` with ``engine="jnp"``
  (float64) within 1e-12 of peak.
* ``engine="pallas"``: the port's kernels' plain versions (float32) against
  the JAX package's Pallas kernels in interpret mode: the line OD within
  2e-6 of peak (the kernels' float32 bound). The JAX drop-in's float32 TUD
  does not run under x64 (its scan carry mixes float32 and float64), so the
  port's TUD is held against JAX's float64 ``tud_from_od`` composing the
  JAX Pallas OD: tau, Lu and Ld within ``TUD_F32_BOUND`` of peak (the line
  OD's bound carried through; the composition alone is 6e-7).
* ``options`` unmutated by a call with kwargs; TAPE5 and TAPE12 files
  byte-identical to JAX's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import radtxfr_tpu.compat as jrt
from radtxfr_tpu.atmos.profile import AtmosphericState as JAtmos
from radtxfr_tpu.core.planck import planckian as jplanckian
from radtxfr_tpu.io.lblrtm import write_tape12 as jwrite_tape12
from radtxfr_tpu.lines.synthetic import synthetic_lines as jsynthetic
from radtxfr_tpu.products.od import compute_od_layers as jcompute_od_layers
from radtxfr_tpu.products.tud import tud_from_od as jtud_from_od

import radtxfr_tpu_torch.compat as rt
from radtxfr_tpu_torch.io.lblrtm import write_tape12
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
from port_fixtures import one_torch_thread  # noqa: F401

BOUND = 1e-12
OD_F32_BOUND = 2e-6
TUD_F32_BOUND = 2e-6
LAYER = dict(T=280.0, P=90000.0, PL=0.5, MF_ID=np.array([1, 2, 3]),
             MF_VAL=np.array([7000.0, 380.0, 0.03]))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _lines(n=60, lo=795.0, hi=815.0, seed=71):
    return (synthetic_lines(n, nu_min=lo, nu_max=hi, seed=seed,
                            device="cpu", dtype=torch.float64),
            jsynthetic(n, nu_min=lo, nu_max=hi, seed=seed))


def test_constants_and_stdatmos():
    assert (rt.c1, rt.c2) == (jrt.c1, jrt.c2)
    np.testing.assert_array_equal(rt.StdAtmos, jrt.StdAtmos)
    assert set(rt.DEFAULT_OPTIONS) == set(jrt.DEFAULT_OPTIONS)
    for k, v in jrt.DEFAULT_OPTIONS.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(rt.DEFAULT_OPTIONS[k], v)
        else:
            assert rt.DEFAULT_OPTIONS[k] == v, k
    assert rt.options is rt.DEFAULT_OPTIONS
    assert set(rt.__all__) == set(jrt.__all__)


def test_planck_trio_matches_jax():
    lam = np.linspace(8.0, 12.0, 16)
    got = rt.planckian(torch.as_tensor(lam), torch.as_tensor(296.0))
    assert isinstance(got, np.ndarray)
    assert _rel(got, jrt.planckian(lam, 296.0)) <= BOUND
    assert _rel(got, rt.planckian(torch.as_tensor(lam), 296.0 * torch.ones(
        ()), wavelength=True)) == 0.0
    X = np.linspace(600, 1400, 32)
    T = np.full((4, 32), 300.0) + np.arange(4.0)[:, None]
    L = rt.BT2L(torch.as_tensor(X), torch.as_tensor(T), spectral_dim=1)
    assert L.shape == (4, 32)
    assert _rel(L, jrt.BT2L(X, T, spectral_dim=1)) <= BOUND
    Tb = rt.brightnessTemperature(torch.as_tensor(X), torch.as_tensor(L),
                                  spectral_dim=1)
    assert _rel(Tb, jrt.brightnessTemperature(X, L, spectral_dim=1)) <= BOUND
    np.testing.assert_allclose(Tb, T, rtol=1e-10)
    bad = rt.brightnessTemperature(torch.as_tensor(X[:2]),
                                   torch.tensor([-1.0, 1.0]))
    assert np.isnan(bad[0]) and np.isfinite(bad[1])


def test_rs_round_trip():
    y = torch.arange(24.0, dtype=torch.float64).reshape(2, 3, 4)
    y1, dims = rt.rs1D(y)
    assert y1.shape == (24,) and dims == jrt.rs1D(y.numpy())[1]
    y2, dims2 = rt.rs2D(y)
    np.testing.assert_array_equal(y2, jrt.rs2D(y.numpy())[0])
    np.testing.assert_array_equal(rt.rsND(torch.as_tensor(y2), dims2), y)
    np.testing.assert_array_equal(rt.make_spectral_axis(800.0, 810.0, 0.3),
                                  jrt.make_spectral_axis(800.0, 810.0, 0.3))


def test_compute_od_requires_lines():
    with pytest.raises(ValueError, match="line database"):
        rt.compute_OD(800.0, 810.0)


def test_compute_od_and_run_lblrtm_match_jax():
    lines, jlines = _lines()
    X, od = rt.compute_OD(800.0, 810.0, lines=lines, DVOUT=0.01, **LAYER)
    Xj, odj = jrt.compute_OD(800.0, 810.0, lines=jlines, DVOUT=0.01, **LAYER)
    np.testing.assert_array_equal(X, Xj)
    assert isinstance(od, np.ndarray) and od.dtype == np.float64
    assert (od >= 0).all() and _rel(od, odj) <= BOUND
    nu2, od2 = rt.run_LBLRTM(800.0, 810.0, lines=lines, DVOUT=0.01, **LAYER)
    np.testing.assert_array_equal(nu2, X)
    np.testing.assert_array_equal(od2, od)
    for profile in ("lorentz", "sdvoigt"):
        _, od = rt.compute_OD(800.0, 810.0, lines=lines, DVOUT=0.02,
                              profile=profile, continuum="mt_ckd", **LAYER)
        _, odj = jrt.compute_OD(800.0, 810.0, lines=jlines, DVOUT=0.02,
                                profile=profile, continuum="mt_ckd", **LAYER)
        assert _rel(od, odj) <= BOUND, profile


def test_compute_tud_matches_jax_and_keeps_options():
    lines, jlines = _lines()
    kw = dict(DVOUT=0.05, N_angle=8, Altitudes=np.array([500.0]))
    X, tau, Lu, Ld = rt.compute_TUD(800.0, 810.0, lines=lines, **kw)
    Xj, tauj, Luj, Ldj = jrt.compute_TUD(800.0, 810.0, lines=jlines, **kw)
    np.testing.assert_array_equal(X, Xj)
    # reference squeeze: scalar altitude & mu -> 1-D outputs
    assert tau.shape == Lu.shape == Ld.shape == X.shape
    assert (tau >= 0).all() and (tau <= 1).all()
    for a, b in ((tau, tauj), (Lu, Luj), (Ld, Ldj)):
        assert _rel(a, b) <= BOUND
    # two altitudes, two slant angles through opts: the unsqueezed shapes
    opts = {"Altitudes": np.array([1.0, 500.0]), "theta_r": 0.3,
            "returnOD": True}
    got = rt.compute_TUD(800.0, 810.0, opts=opts, lines=lines, DVOUT=0.1)
    want = jrt.compute_TUD(800.0, 810.0, opts=opts, lines=jlines, DVOUT=0.1)
    for a, b in zip(got[1:], want[1:]):
        assert a.shape == b.shape and _rel(a, b) <= BOUND
    # defaults are not mutated across calls (by design)
    assert rt.DEFAULT_OPTIONS["DVOUT"] == 0.0005
    assert rt.DEFAULT_OPTIONS["lines"] is None
    assert rt.DEFAULT_OPTIONS["iso"] is None
    assert "returnOD" in opts and len(opts) == 3


def test_compute_od_pallas_engine_matches_jax_interpret():
    lines, jlines = _lines()
    kw = dict(DVOUT=0.01, engine="pallas", **LAYER)
    X, od = rt.compute_OD(800.0, 810.0, lines=lines, **kw)
    Xj, odj = jrt.compute_OD(800.0, 810.0, lines=jlines, **kw)
    assert od.dtype == np.float32 and odj.dtype == np.float32
    err = _rel(od, odj)
    print(f"compute_OD pallas: {err:.3e} of peak")
    assert err <= OD_F32_BOUND
    # the float64 reference engine agrees within the same bound
    assert _rel(od, rt.compute_OD(800.0, 810.0, lines=lines, DVOUT=0.01,
                                  **LAYER)[1]) <= OD_F32_BOUND
    # float64 tables given with iso= are cast to the kernels' float32
    from radtxfr_tpu_torch.lines.store import IsoTables

    iso64 = IsoTables.load(device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(
        rt.compute_OD(800.0, 810.0, lines=lines, iso=iso64, **kw)[1], od)


def test_compute_tud_pallas_engine_matches_jax_interpret():
    lines, jlines = _lines()
    X, tau, Lu, Ld = rt.compute_TUD(800.0, 810.0, lines=lines, DVOUT=0.05,
                                    N_angle=8, engine="pallas")
    assert tau.dtype == np.float32 and (tau >= 0).all() and (tau <= 1).all()
    o = jrt.DEFAULT_OPTIONS
    z0 = np.asarray(o["Zs"], dtype=np.float64)
    atm = JAtmos(z0=jnp.asarray(z0), z1=jnp.asarray(z0),
                 pl=jnp.asarray(o["PLs"]), p=jnp.asarray(o["Ps"]),
                 T=jnp.asarray(o["Ts"]),
                 vmr=jnp.asarray(o["MFs_VAL"] * 1e-6),
                 mol_ids=tuple(int(m) for m in o["MFs_ID"]))
    from radtxfr_tpu.lines.store import IsoTables as JIso

    od = jcompute_od_layers(jlines, JIso.load(), jnp.asarray(X), atm,
                            engine="pallas").astype(jnp.float64)
    B = jnp.swapaxes(jplanckian(X, atm.T), 0, 1)
    want = jtud_from_od(jnp.asarray(X), od, B, atm.z0, jnp.asarray([500.0]),
                        n_angles=8).squeezed()
    for name, got in (("tau", tau), ("Lu", Lu), ("Ld", Ld)):
        err = _rel(got, np.asarray(getattr(want, name)))
        print(f"compute_TUD pallas {name}: {err:.3e} of peak")
        assert err <= TUD_F32_BOUND, name


def test_apparent_radiance_matches_jax():
    rng = np.random.default_rng(4)
    X = np.linspace(800.0, 1200.0, 50)
    emis = rng.uniform(0.8, 1.0, (50, 3))
    Ts = np.array([290.0, 300.0])
    tau, La, Ld = (rng.uniform(0.1, 1.0, (50, 2)) for _ in range(3))
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    for kw in ({}, {"dT": np.array([-1.0, 0.0, 2.0])}):
        got = rt.compute_LWIR_apparent_radiance(
            t(X), t(emis), t(Ts), t(tau), t(La), t(Ld), **kw)
        want = jrt.compute_LWIR_apparent_radiance(X, emis, Ts, tau, La, Ld,
                                                  **kw)
        assert _rel(got, want) <= BOUND
    L, Ls = rt.compute_LWIR_apparent_radiance(
        t(X), t(emis), t(Ts), t(tau), t(La), t(Ld), return_Ls=True)
    Lj, Lsj = jrt.compute_LWIR_apparent_radiance(X, emis, Ts, tau, La, Ld,
                                                 return_Ls=True)
    assert _rel(L, Lj) <= BOUND and _rel(Ls, Lsj) <= BOUND


def test_ils_mako_and_reduce_resolution_match_jax():
    X = np.linspace(700.0, 1400.0, 2000)
    Y = 1.0 + 0.1 * np.sin(X / 7.0)
    x_out, y = rt.ILS_MAKO(X, torch.as_tensor(Y))
    xj, yj = jrt.ILS_MAKO(X, Y)
    np.testing.assert_array_equal(x_out, xj)
    assert isinstance(y, np.ndarray) and _rel(y, yj) <= BOUND
    y_only = rt.ILS_MAKO(X, torch.as_tensor(Y), returnX=False)
    np.testing.assert_array_equal(y_only, y)
    xo, yo = rt.reduceResolution(X, torch.as_tensor(Y), 2.0)
    xoj, yoj = jrt.reduceResolution(X, Y, 2.0)
    np.testing.assert_allclose(xo, xoj, rtol=1e-14)
    assert _rel(yo, yoj) <= BOUND
    got = rt.reduceResolution(X, torch.as_tensor(Y), 2.0, X_out=xoj[1:-1])
    assert _rel(got, jrt.reduceResolution(X, Y, 2.0, X_out=xoj[1:-1])) \
        <= BOUND
    s = rt.smooth(torch.as_tensor(Y), 11)
    assert s.shape == (2000,)


def test_get_help(capsys):
    rt.getHelp()
    out = capsys.readouterr().out
    assert "radtxfr_tpu_torch.core" in out and "radtxfr_tpu_torch.kernels" in out
    rt.getHelp("planckian")
    out = capsys.readouterr().out
    assert "planckian" in out and "radiance" in out.lower()
    rt.getHelp(rt.compute_TUD)
    assert "compute_TUD" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no such name"):
        rt.getHelp("definitely_not_a_thing")


def test_tape5_and_tape12_bytes_match_jax(tmp_path):
    kw = dict(V1=690.0, V2=1410.0, T=280.0, P=90000.0, PL=0.5,
              MF_ID=np.array([1, 2]), MF_VAL=np.array([10000.0, 400.0]),
              DVOUT=0.0025)
    a, b = str(tmp_path / "TAPE5_p"), str(tmp_path / "TAPE5_j")
    rt.write_tape5(a, **kw)
    jrt.write_tape5(b, **kw)
    assert open(a, "rb").read() == open(b, "rb").read()
    text = open(a).read()
    assert "HI=1" in text and "CN=6" in text and "690.000" in text
    nu = np.linspace(690.0, 700.0, 4001)
    od = np.random.default_rng(3).gamma(1.0, 0.5, nu.size).astype(np.float32)
    f, g = str(tmp_path / "TAPE12_p"), str(tmp_path / "TAPE12_j")
    write_tape12(f, torch.as_tensor(nu), torch.as_tensor(od),
                 panel_size=1500)
    jwrite_tape12(g, nu, od, panel_size=1500)
    assert open(f, "rb").read() == open(g, "rb").read()
    for path in (f, g):
        nu2, od2 = rt.read_tape12(path)
        nu3, od3 = jrt.read_tape12(path)
        np.testing.assert_array_equal(nu2, nu3)
        np.testing.assert_array_equal(od2, od)
        np.testing.assert_array_equal(od3, od)
