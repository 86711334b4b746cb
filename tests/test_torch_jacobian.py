"""The port's Jacobian path (``tud --jacobian``) against radtxfr_tpu.

The JAX side runs ``make_od_pallas_fn(differentiable=True)`` (K1 ``full``
as the primal, K3 as its custom JVP) in interpret mode, as the JAX
package's own tests run it on the CPU; the port side runs the same
builder on CPU tensors, i.e. the kernels' plain versions
(``xsect_fused_plain``, ``xsect_fused_jvp_plain``) through the same
``torch.autograd.Function`` (``engine='pallas'``, named explicitly: the
default of ``tud_with_jacobian`` is the reference engine,
``tests/test_torch_jnp_engine.py``). Sizes follow
``tests/test_products.py``: 40 synthetic lines, the first 5 StdAtmos
layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
from radtxfr_tpu.kernels.pallas_xsect import UniformGrid as JGrid
from radtxfr_tpu.lines.synthetic import synthetic_lines
from radtxfr_tpu.products.jacobian import tud_with_jacobian as j_jacobian
from radtxfr_tpu.products.od import _build_od_calls as j_build_od_calls
from radtxfr_tpu.products.od import _host_planning_views as j_host_views
from radtxfr_tpu.products.od import make_od_pallas_fn
from radtxfr_tpu_torch.atmos.profile import AtmosphericState
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.core.planck import planckian
from radtxfr_tpu_torch.kernels.fused_xsect import UniformGrid
from radtxfr_tpu_torch.lines.store import IsoTables, LineStore
from radtxfr_tpu_torch.products.jacobian import tud_with_jacobian
from radtxfr_tpu_torch.products.od import (_build_od_calls,
                                           _host_planning_views, make_od_fn)
from radtxfr_tpu_torch.products.tud import tud_from_od
from port_fixtures import one_torch_thread  # noqa: F401

FIELDS = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
          "delta_air", "sd_air", "iso_row", "mol_id")
STATE = ("z0", "z1", "pl", "p", "T", "vmr")
AXIS = arange_drift_free(800.0, 810.0, 0.02)         # 501 points
ALTS = [2.0, 100.0]


@pytest.fixture(scope="module")
def case(iso_tables):
    """40 synthetic lines and the first 5 StdAtmos layers (JAX objects)."""
    full = j_std_atmosphere()
    atm = full.replace(**{f: getattr(full, f)[:5] for f in STATE})
    return synthetic_lines(40, nu_min=798.0, nu_max=812.0, seed=61), atm


def _port(case, iso_tables, dtype):
    """The JAX line list, partition tables and state as port tensors on
    the CPU, through the from_numpy converters."""
    store, atm = case
    hv = store.host_view()
    iso = jax.device_get(iso_tables)
    return (LineStore.from_numpy(**{f: getattr(hv, f) for f in FIELDS},
                                 device="cpu", dtype=dtype),
            IsoTables.from_numpy(**{f: getattr(iso, f) for f in
                                    ("q", "abundance", "molar_mass", "mol",
                                     "iso")}, device="cpu", dtype=dtype),
            AtmosphericState.from_numpy(
                **{f: np.asarray(getattr(atm, f)) for f in STATE},
                mol_ids=atm.mol_ids, device="cpu", dtype=dtype))


def test_single_pass_od_calls_match(case, iso_tables):
    """The differentiable builder's plans (``two_pass=False``: one ``full``
    pass per layer group over ``tile``-point tiles) integer-exact against
    the JAX planner's."""
    store, atm = case
    lines, iso, state = _port(case, iso_tables, torch.float64)
    want = j_build_od_calls(*j_host_views(store, iso_tables, atm),
                            JGrid.from_axis(AXIS), 0.0, 50.0, 8, 512, False,
                            None, None, 4.0, None, 16, "voigt", None)
    got = _build_od_calls(*_host_planning_views(lines, iso, state),
                          UniformGrid.from_axis(AXIS), 0.0, 50.0, 8, 512,
                          4.0, core_block=16, two_pass=False)
    assert [c[3] for c in got] == [c[3] for c in want]
    assert {c[3] for c in got} == {"full"}
    for (lay, idx, plan, _), (j_lay, j_idx, j_plan, _) in zip(got, want):
        np.testing.assert_array_equal(lay, np.asarray(j_lay))
        np.testing.assert_array_equal(idx, np.asarray(j_idx))
        assert (plan.tile, plan.block, plan.n_tiles, plan.max_blocks) == \
            (j_plan.tile, j_plan.block, j_plan.n_tiles, j_plan.max_blocks)
        for f in ("starts", "counts", "k_line", "frac0", "gather"):
            np.testing.assert_array_equal(getattr(plan, f),
                                          getattr(j_plan, f), err_msg=f)


def _direction(atm, kind):
    """A T direction over all layers or the H2O-column direction
    (``test_pallas_xsect.py:330,343``)."""
    if kind == "T":
        return np.linspace(0.5, 1.5, atm.T.shape[0])
    v = np.zeros_like(np.asarray(atm.vmr))
    v[:, 0] = np.asarray(atm.vmr)[:, 0]
    return v


@pytest.mark.parametrize("kind", ["T", "H2O"])
def test_differentiable_od_jvp_matches_pallas(case, iso_tables, kind):
    """The port's differentiable OD (K1 ``full`` + K3, plain versions,
    float32) against ``jax.jvp`` of the JAX builder (interpret mode): the
    primal within 3e-6 of peak of the ``two_pass=False`` build, the tangent
    within 2e-5 of peak (``test_pallas_xsect.py:340``)."""
    store, atm = case
    jfn = make_od_pallas_fn(store, iso_tables, AXIS, atm, differentiable=True)
    j0 = make_od_pallas_fn(store, iso_tables, AXIS, atm, two_pass=False)
    v = _direction(atm, kind)
    if kind == "T":
        _, want_t = jax.jvp(lambda T: jfn(T, atm.p, atm.pl, atm.vmr),
                            (atm.T,), (jnp.asarray(v),))
    else:
        _, want_t = jax.jvp(lambda x: jfn(atm.T, atm.p, atm.pl, x),
                            (atm.vmr,), (jnp.asarray(v),))
    want = np.asarray(j0(atm.T, atm.p, atm.pl, atm.vmr))

    lines, iso, s = _port(case, iso_tables, torch.float32)
    fn = make_od_fn(lines, iso, AXIS, s, differentiable=True)
    assert {c[2] for c in fn.calls} == {"full"}
    vt = torch.as_tensor(v, dtype=torch.float32)
    if kind == "T":
        got, got_t = torch.func.jvp(lambda T: fn(T, s.p, s.pl, s.vmr),
                                    (s.T,), (vt,))
    else:
        got, got_t = torch.func.jvp(lambda x: fn(s.T, s.p, s.pl, x),
                                    (s.vmr,), (vt,))
    assert got.shape == got_t.shape == want.shape == (5, AXIS.size)
    assert np.abs(got.numpy() - want).max() <= 3e-6 * np.abs(want).max()
    want_t = np.asarray(want_t)
    peak = np.abs(want_t).max()
    assert peak > 0.0
    assert np.abs(got_t.numpy() - want_t).max() <= 2e-5 * peak


def test_tud_with_jacobian_matches_pallas_engine(case, iso_tables):
    """``tud_with_jacobian`` on the CPU (float32) against JAX's
    ``engine='pallas'``, ``wrt=("T", 1)``, continuum 'mt_ckd': each
    Jacobian within 5e-4 of its peak, the JAX package's own bound between
    its engines (``test_pallas_xsect.py:376``); measured <= 1.4e-6."""
    store, atm = case
    tud_j, jac_j = j_jacobian(store, iso_tables, jnp.asarray(AXIS), atm,
                              jnp.asarray(ALTS), wrt=("T", 1), n_angles=6,
                              engine="pallas", continuum="mt_ckd")
    lines, iso, s = _port(case, iso_tables, torch.float32)
    tud, jac = tud_with_jacobian(lines, iso, AXIS, s, ALTS, wrt=("T", 1),
                                 n_angles=6, engine="pallas",
                                 continuum="mt_ckd")
    for k in ("tau", "Lu", "Ld"):
        ref = np.asarray(tud_j[k])
        assert tud[k].shape == ref.shape
        assert np.abs(tud[k].numpy() - ref).max() <= 5e-6 * np.abs(ref).max()
        for w in ("T", "1"):
            got, want = jac[w][k].numpy(), np.asarray(jac_j[w][k])
            assert got.shape == want.shape == ref.shape + (5,), (k, w)
            peak = np.abs(want).max()
            assert peak > 0.0
            assert np.abs(got - want).max() <= 5e-4 * peak, (k, w)


def test_jacobian_matches_finite_differences(case, iso_tables):
    """The port's float64 Jacobian against central finite differences of
    its own forward on layer 2 (``test_products.py:140-151``)."""
    lines, iso, s = _port(case, iso_tables, torch.float64)
    tud, jac = tud_with_jacobian(lines, iso, AXIS, s, [100.0], wrt=("T", 1),
                                 n_angles=8, engine="pallas")
    assert jac["T"]["tau"].shape == tud["tau"].shape + (5,)
    fn = make_od_fn(lines, iso, AXIS, s, differentiable=True)
    grid = torch.as_tensor(AXIS)

    def tau(T, vmr):
        B = planckian(grid, T).T
        return tud_from_od(grid, fn(T, s.p, s.pl, vmr), B, s.z0, [100.0],
                           n_angles=8).tau.numpy()

    k = 2
    for var, h in (("T", 1e-3), ("1", 1e-9)):
        up, dn = s.T.clone(), s.T.clone()
        vu, vd = s.vmr.clone(), s.vmr.clone()
        if var == "T":
            up[k] += h
            dn[k] -= h
        else:
            vu[k, 0] += h
            vd[k, 0] -= h
        fd = (tau(up, vu) - tau(dn, vd)) / (2 * h)
        got = jac[var]["tau"][..., k].numpy()
        np.testing.assert_allclose(got, fd, rtol=0,
                                   atol=5e-5 * (np.abs(fd).max() + 1e-30))


def test_tangent_batching_changes_no_value(case, iso_tables):
    """``tangent_batch`` streams the directions without changing values
    (``test_products.py:273``)."""
    lines, iso, s = _port(case, iso_tables, torch.float64)
    kw = dict(wrt=("T", 1), n_angles=6, engine="pallas")
    _, full = tud_with_jacobian(lines, iso, AXIS, s, ALTS, **kw)
    _, bat = tud_with_jacobian(lines, iso, AXIS, s, ALTS, tangent_batch=2,
                               **kw)
    for key in ("T", "1"):
        for prod in ("tau", "Lu", "Ld"):
            np.testing.assert_allclose(bat[key][prod].numpy(),
                                       full[key][prod].numpy(), rtol=1e-10,
                                       atol=1e-14)


@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-12),
                                         (torch.float32, 2e-5)])
def test_tud_with_jacobian_k2_composition_matches_plain(case, iso_tables,
                                                        monkeypatch, dtype,
                                                        bound):
    """``tud_with_jacobian`` with the differentiable K2 composition (what a
    CUDA float32 OD takes; forced here on the CPU, so its plain versions
    run) against its plain composition (``planckian`` and
    ``tud_from_od``), ``wrt=("T", 1)``, two secants: the products and
    every Jacobian within ``bound`` of its peak (float32: the plain
    versions' own orders of summation); nothing is launched."""
    from radtxfr_tpu_torch.kernels import fused_tud
    from radtxfr_tpu_torch.products import tud as tud_mod

    lines, iso, s = _port(case, iso_tables, dtype)
    before = dict(fused_tud.LAUNCHES)
    outs = []
    for k2 in (False, True):
        monkeypatch.setattr(tud_mod, "_k2_composes", lambda od, k2=k2: k2)
        outs.append(tud_with_jacobian(lines, iso, AXIS, s, ALTS,
                                      wrt=("T", 1), mu=[1.0, 1.4],
                                      n_angles=6, engine="pallas"))
    assert fused_tud.LAUNCHES == before
    (p0, j0), (p1, j1) = outs
    for k in ("tau", "Lu", "Ld"):
        assert p1[k].shape == p0[k].shape
        assert (p1[k] - p0[k]).abs().max() <= bound * p0[k].abs().max(), k
        for w in ("T", "1"):
            got, want = j1[w][k], j0[w][k]
            assert got.shape == want.shape == p0[k].shape + (5,)
            peak = want.abs().max()
            assert peak > 0.0
            assert (got - want).abs().max() <= bound * peak, (k, w)
