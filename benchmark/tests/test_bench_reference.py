"""The plain reference against the port's plain versions, in float64 on the
CPU: the two are written apart (the reference imports nothing of the
program), so their agreement here is evidence for both. Only this test
file imports the port beside the reference."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_tiny import ROOT  # noqa: F401  (puts the benchmark on sys.path)
from benchkit.inputs.atmosphere import Atmosphere
from benchkit.inputs.derived_lines import derived_lwir_columns
from benchkit.inputs.grid import axis
from benchkit.reference import lbl
from benchkit.reference.continuum import mt_ckd_od
from benchkit.reference.radiative import Reduction, compose, table_od

F64 = torch.float64


def test_hum1_wei_matches_the_port():
    from radtxfr_tpu_torch.kernels.faddeeva import wofz_real

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-40, 40, 4000), dtype=F64)
    y = torch.as_tensor(10 ** rng.uniform(-4, 1.5, 4000), dtype=F64)
    a = lbl.hum1_wei(x, y, 16)
    b = wofz_real(x, y, 16)
    for u, v in zip(a, b):
        assert torch.allclose(u, v, rtol=1e-12, atol=1e-15)


def test_partition_sums_match_the_port():
    from radtxfr_tpu_torch.lines.tips import partition_sum

    iso = lbl.IsoData.load()
    q = torch.as_tensor(iso.q)
    rows = torch.arange(q.shape[0])
    for T in (70.0, 80.0, 200.3, 296.0, 2990.0):
        want = partition_sum(q, rows, torch.tensor(T, dtype=F64)).numpy()
        got = lbl.partition_sum(iso.q, T)
        np.testing.assert_allclose(got, want, rtol=1e-12)


def _state():
    a = Atmosphere.standard()
    return a


def test_od_matches_the_ports_reference_engine():
    """Line OD (Voigt, line mixing and its clamp, the window caps) plus
    the continuum at 400 points, against make_od_fn's plain versions in
    float64 on the CPU."""
    from radtxfr_tpu_torch.atmos.profile import AtmosphericState
    from radtxfr_tpu_torch.kernels.linemixing_data import y_air_for_store
    from radtxfr_tpu_torch.lines.store import IsoTables, from_arrays
    from radtxfr_tpu_torch.products.od import make_od_fn

    cols = derived_lwir_columns(1000.0 - 25, 1000.2 + 25)
    order = np.argsort(cols["nu0"], kind="stable")
    cols = {k: np.asarray(v)[order] for k, v in cols.items()}
    X = axis(1000.0, 1000.2, 0.0005)
    store = from_arrays(cols["nu0"], cols["sw"], cols["elower"],
                        cols["gamma_air"], cols["gamma_self"], cols["n_air"],
                        cols["delta_air"], cols["mol_id"],
                        cols["local_iso_id"], sd_air=cols["sd_air"],
                        dtype=F64, device="cpu")
    y = y_air_for_store(store)
    a = _state()
    base = AtmosphericState.from_numpy(z0=a.z0, z1=a.z1, pl=a.pl, p=a.p,
                                       T=a.T, vmr=a.vmr, device="cpu",
                                       dtype=F64)
    fn = make_od_fn(store, IsoTables.load(dtype=F64, device="cpu"), X, base,
                    continuum="mt_ckd", line_mixing={"y_air": y})
    T = base.T + 3.0
    prog = fn(T, base.p, base.pl, base.vmr).numpy()

    iso = lbl.IsoData.load()
    lines = lbl.Lines.from_columns(cols, iso)
    col = {m: i for i, m in enumerate(a.mol_ids)}
    c = np.array([col[int(m)] for m in lines.mol_id])
    W = lbl.wing_bound(lines, iso, a.T, a.p / lbl.PA_PER_ATM, a.vmr[:, c])
    mix = np.nonzero(y != 0)[0]
    cap = lbl.wing_cap_matrix(W, [mix, np.setdiff1d(np.arange(y.size),
                                                     mix)])
    Tm = a.T + 3.0
    p_atm = a.p / lbl.PA_PER_ATM
    n_tot = p_atm * lbl.BARYE_PER_ATM / (lbl.K_B_CGS * Tm)
    prm = lbl.line_params(lines, iso, Tm, p_atm, x_self=a.vmr[:, c],
                          column=a.vmr[:, c] * (n_tot * a.pl * 1e5)[:, None],
                          y_air=y, wing_cap=cap)
    ref = torch.clamp(lbl.line_sum(X, prm), min=0.0).numpy()
    ref += mt_ckd_od(X, Tm, a.p, a.pl, a.vmr, a.mol_ids)
    assert np.abs(prog - ref).max() <= 1e-9 * np.abs(ref).max()


def test_sdvoigt_lattice_matches_the_port():
    from radtxfr_tpu_torch.lines.store import IsoTables, from_arrays
    from radtxfr_tpu_torch.products.od import make_xsect_fn
    from benchkit.inputs.synthetic import synthetic_columns

    cols = synthetic_columns(200, 1000.0 - 350, 1004.0 + 350,
                             species=((1, 1),), seed=3)
    order = np.argsort(cols["nu0"], kind="stable")
    cols = {k: np.asarray(v)[order] for k, v in cols.items()}
    X = axis(1000.0, 1004.0, 0.0025)
    TT, PP = np.array([275.0, 300.0]), np.array([0.85, 1.05])
    store = from_arrays(cols["nu0"], cols["sw"], cols["elower"],
                        cols["gamma_air"], cols["gamma_self"], cols["n_air"],
                        cols["delta_air"], cols["mol_id"],
                        cols["local_iso_id"], sd_air=cols["sd_air"],
                        dtype=F64, device="cpu")
    fn = make_xsect_fn(store, IsoTables.load(dtype=F64, device="cpu"), X, TT,
                       PP, profile="sdvoigt", wing_abs=350.0,
                       far_method="classic")
    prog = fn(torch.as_tensor(TT), torch.as_tensor(PP)).numpy()
    iso = lbl.IsoData.load()
    lines = lbl.Lines.from_columns(cols, iso)
    prm = lbl.line_params(lines, iso, TT, PP, wing_abs=350.0)
    ref = lbl.line_sum(X, prm, profile="sdvoigt").numpy()
    assert np.abs(prog - ref).max() <= 1e-9 * np.abs(ref).max()


def test_composition_matches_the_port():
    from radtxfr_tpu_torch.products.tud import tud_from_od
    from radtxfr_tpu_torch.core.planck import planckian

    rng = np.random.default_rng(1)
    a = _state()
    nu = torch.as_tensor(np.linspace(700, 1400, 50), dtype=F64)
    od = torch.as_tensor(rng.uniform(0, 0.3, (66, 50)), dtype=F64)
    T = torch.as_tensor(a.T)
    alts = [0.061, 1.524, 500.0]
    B = planckian(nu, T).transpose(0, 1)
    tud = tud_from_od(nu, od, B, torch.as_tensor(a.z0),
                      torch.as_tensor(alts), n_angles=30)
    tau, Lu, Ld = compose(od, nu, T, a.z0, alts, 30)
    assert torch.allclose(tau.T, tud.tau[:, :, 0], rtol=1e-10)
    assert torch.allclose(Lu.T, tud.Lu[:, :, 0], rtol=1e-7)
    assert torch.allclose(Ld, tud.Ld, rtol=1e-7)


@pytest.mark.parametrize("dv,dX", [(0.0005, 0.25), (0.0025, 0.25)])
def test_reduction_matches_the_ports_operator(dv, dX):
    from radtxfr_tpu_torch.sensor.resolution import reduce_operator

    X = axis(1000.0, 1006.0, dv)
    op = reduce_operator(X, dX, device="cpu")
    red = Reduction(X, dX)
    assert red.n_out == op.n_out
    np.testing.assert_array_equal(red.x_out, op.x_out)
    y = torch.as_tensor(np.sin(X * 7.0) + X * 1e-3, dtype=F64)
    want = op(y).numpy()
    for i in (0, red.n_out // 2, red.n_out - 1):
        lo, hi = red.support(i)
        got = float(red.apply(i, y[lo:hi], lo))
        assert got == pytest.approx(want[i], rel=1e-12, abs=1e-12)


def test_table_lookup_matches_the_port():
    from radtxfr_tpu_torch.atmos.profile import AtmosphericState
    from radtxfr_tpu_torch.products.od_from_xs import XsTable, od_from_xs

    rng = np.random.default_rng(2)
    T_grid = np.arange(275.0, 321.0, 5.0)
    p_grid = np.arange(0.85, 1.06, 0.05)
    sigma = 10 ** rng.uniform(-23, -21, (2, T_grid.size, p_grid.size, 40))
    table = XsTable.from_numpy(sigma, T_grid, np.log(p_grid),
                               np.arange(40.0), (1, 2), device="cpu",
                               dtype=F64)
    a = _state()
    st = AtmosphericState.from_numpy(z0=a.z0, z1=a.z1, pl=a.pl, p=a.p,
                                     T=a.T + 20.0, vmr=a.vmr, device="cpu",
                                     dtype=F64)
    prog = od_from_xs(table, st).numpy()
    ref = table_od(torch.as_tensor(sigma), T_grid, np.log(p_grid),
                   a.T + 20.0, a.p, a.pl, a.vmr[:, [0, 1]]).numpy()
    np.testing.assert_allclose(ref, prog, rtol=1e-10)
