"""K2's plain version and the port's composition and resolution reduction
against radtxfr_tpu.

The JAX side runs the fused Pallas composition in interpret mode and the
XLA-scan composition; the port side runs ``make_tud_fn`` on CPU tensors,
i.e. ``tud_compose_plain`` (the CUDA kernel has no CPU mode; its comparison
with the plain version is ``chip_smoke.py`` on the card). Cases follow
``tests/test_pallas_tud.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.core.planck import planckian as j_planckian
from radtxfr_tpu.products.tud import make_tud_pallas_fn
from radtxfr_tpu.products.tud import tud_from_od as j_tud_from_od
from radtxfr_tpu.sensor.resolution import reduce_operator as j_reduce_operator
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.core.planck import planckian
from radtxfr_tpu_torch.kernels import fused_tud
from radtxfr_tpu_torch.products.tud import (_layers_below,
                                            downwelling_quadrature,
                                            make_tud_fn, tud_from_od)
from radtxfr_tpu_torch.sensor.resolution import reduce_operator
from port_fixtures import one_torch_thread  # noqa: F401


def _setup(n_x=3000, n_lay=24, seed=0):
    rng = np.random.default_rng(seed)
    z0 = np.linspace(0.0, 65.0, n_lay)
    T = (230.0 + 60.0 * rng.random(n_lay)).astype(np.float32)
    od = (0.2 * rng.random((n_lay, n_x))).astype(np.float32)
    x = np.linspace(690.0, 1410.0, n_x)
    return z0, T, od, x


def _compare(got, refs, bound):
    for name in ("tau", "Lu", "Ld"):
        g = np.asarray(getattr(got, name))
        for ref in refs:
            r = np.asarray(getattr(ref, name))
            assert g.shape == r.shape, (name, g.shape, r.shape)
            err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-30)
            assert err <= bound, (name, err)


def _jax_refs(z0, T, od, x, alts, mu, n_angles, return_od, quad):
    B = jnp.swapaxes(j_planckian(jnp.asarray(x, jnp.float32),
                                 jnp.asarray(T)), 0, 1).astype(jnp.float32)
    scan = j_tud_from_od(jnp.asarray(x, jnp.float32), jnp.asarray(od), B,
                         jnp.asarray(z0, jnp.float32),
                         jnp.asarray(alts, jnp.float32),
                         mu=jnp.asarray(mu, jnp.float32), n_angles=n_angles,
                         return_od=return_od, quadrature=quad)
    fused = make_tud_pallas_fn(z0, alts, mu=mu, n_angles=n_angles,
                               return_od=return_od, quadrature=quad,
                               interpret=True)(x, od, T)
    return scan, fused


@pytest.mark.parametrize(
    "alts,mu,n_angles,return_od,quad",
    [
        ([0.061, 1.524, 6.096, 15.24, 500.0], [1.0], 30, False, "uniform"),
        ([-1.0, 5.0, 500.0], [1.0, 1.7], 10, True, "uniform"),
        ([2.0, 500.0], [1.3], 8, False, "gauss"),
    ],
)
def test_make_tud_fn_matches_jax(alts, mu, n_angles, return_od, quad):
    z0, T, od, x = _setup()
    got = make_tud_fn(z0, alts, mu=mu, n_angles=n_angles,
                      return_od=return_od, quadrature=quad,
                      device="cpu")(x, od, T)
    # float32 against both JAX compositions: <= 5e-6 of peak
    # (test_pallas_tud.py:64)
    _compare(got, _jax_refs(z0, T, od, x, alts, mu, n_angles, return_od,
                            quad), 5e-6)


@pytest.mark.parametrize(
    "alts,mu,n_angles,return_od,quad",
    [
        ([0.061, 1.524, 6.096, 15.24, 500.0], [1.0], 30, False, "uniform"),
        ([-1.0, 5.0, 500.0], [1.0, 1.7], 10, True, "uniform"),
        ([2.0, 500.0], [1.3], 8, False, "gauss"),
    ],
)
def test_make_tud_fn_source_input_matches_jax(alts, mu, n_angles, return_od,
                                              quad):
    """planck=False: the source B (nL, nX) is an input, fn(x, od, B), against
    JAX's make_tud_pallas_fn(planck=False) in interpret mode and the scan
    composition."""
    z0, T, od, x = _setup()
    B = np.asarray(jnp.swapaxes(j_planckian(jnp.asarray(x, jnp.float32),
                                            jnp.asarray(T)), 0, 1),
                   dtype=np.float32)
    got = make_tud_fn(z0, alts, mu=mu, n_angles=n_angles,
                      return_od=return_od, quadrature=quad, planck=False,
                      device="cpu")(x, od, B)
    fused = make_tud_pallas_fn(z0, alts, mu=mu, n_angles=n_angles,
                               return_od=return_od, quadrature=quad,
                               planck=False, interpret=True)(x, od, B)
    scan, _ = _jax_refs(z0, T, od, x, alts, mu, n_angles, return_od, quad)
    # float32 against both JAX compositions: <= 5e-6 of peak
    # (test_pallas_tud.py:64)
    _compare(got, [fused, scan], 5e-6)


def test_make_tud_fn_odd_layer_count():
    z0, T, od, x = _setup(n_lay=23)
    alts = [1.0, 500.0]
    got = make_tud_fn(z0, alts, n_angles=12, device="cpu")(x, od, T)
    _compare(got, _jax_refs(z0, T, od, x, alts, [1.0], 12, False,
                            "uniform"), 5e-6)


def test_tud_from_od_matches_jax_float64():
    """The plain composition, float64, against the XLA-scan composition."""
    z0, T, od, x = _setup(n_x=800, n_lay=17)
    od = od.astype(np.float64)
    alts = [-1.0, 0.5, 9.0, 500.0]
    mu = [1.0, 1.4]
    B = planckian(torch.as_tensor(x), torch.as_tensor(T, dtype=torch.float64))
    got = tud_from_od(torch.as_tensor(x), torch.as_tensor(od), B.T.contiguous(),
                      torch.as_tensor(z0), torch.as_tensor(alts), mu=mu,
                      n_angles=20)
    Bj = jnp.swapaxes(j_planckian(jnp.asarray(x),
                                  jnp.asarray(T, jnp.float64)), 0, 1)
    want = j_tud_from_od(jnp.asarray(x), jnp.asarray(od), Bj, jnp.asarray(z0),
                         jnp.asarray(alts), mu=jnp.asarray(mu), n_angles=20)
    # float64, same recurrences: <= 1e-12 of peak
    _compare(got, [want], 1e-12)


@pytest.mark.parametrize("lo,hi,dv,dv_out",
                         [(690.0, 790.0, 0.0005, 0.25),
                          (500.0, 1500.0, 0.0025, 0.25),
                          (800.0, 900.0, 0.01, 0.5)])   # non-affine axis
def test_reduce_operator_matches_jax(lo, hi, dv, dv_out):
    X = arange_drift_free(lo, hi, dv)
    op = reduce_operator(X, dv_out, device="cpu")
    j_op = j_reduce_operator(X, dv_out)
    assert (op._affine is None) == (j_op._affine is None)
    np.testing.assert_array_equal(op.x_out, np.asarray(j_op.x_out))
    rng = np.random.default_rng(1)
    Y = rng.random((X.size, 3))
    for y in (Y, Y[:, 0]):
        got = op(torch.as_tensor(y)).numpy()
        want = np.asarray(j_op(jnp.asarray(y)))
        # float64: <= 1e-12 of peak
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("n_lay,n_zs,n_mu,error", [
    (66, 9, 1, None),                   # the production shape
    (66, 64, 1, None),
    (66, 60, 6, None),                  # 360 altitude-secant rows
    (66, 65, 1, "at most 64 sensor altitudes"),
    (66, 60, 7, "shared memory"),       # 420 rows: 232,472 bytes
    (880, 1, 1, "shared memory"),
])
def test_kernel_launch_shape_limits(n_lay, n_zs, n_mu, error):
    """The kernel's limits raise ValueError before any launch: 64 altitudes
    (a 64-bit mask a layer) and a CTA's shared memory (the source of its
    64 columns a layer and its staged tau and Lu) within the card's
    227 KB."""
    need = fused_tud.smem_bytes(n_lay, n_zs, n_mu)
    assert need == 8 * (n_lay + 1) + 256 * (n_lay + 2 * n_zs * n_mu)
    if error is None:
        assert need <= fused_tud.MAX_SMEM
        fused_tud.check_launch_shape(n_lay, n_zs, n_mu)
    else:
        with pytest.raises(ValueError, match=error):
            fused_tud.check_launch_shape(n_lay, n_zs, n_mu)


def test_plain_composition_takes_any_altitude_count():
    """CPU tensors run the plain version, which has no altitude limit."""
    z0, T, od, x = _setup(n_x=50, n_lay=5)
    n = fused_tud.MAX_ALTITUDES + 1
    snap = torch.arange(n, dtype=torch.int32) % (od.shape[0] + 1)
    sec, w = torch.tensor([1.0, 2.0]), torch.tensor([0.5, 0.5])
    od_t, x_t = torch.as_tensor(od), torch.as_tensor(x)
    tau, lu, ld = fused_tud.tud_compose(
        od_t, x_t, 1.0 / torch.as_tensor(T), torch.ones(1), snap, sec, w)
    assert tau.shape == (x.size, n, 1) and bool(torch.isfinite(lu).all())


# --------------------------------------------------------------------------
# K2's tangent mode (no JAX counterpart: JAX differentiates its scan
# composition) and the differentiable Planck mode, on the CPU: their plain
# versions against torch.func.jvp of the plain composition
# --------------------------------------------------------------------------

TANGENT_CASES = [
    ([0.061, 1.524, 6.096, 500.0], [1.0], 30, "uniform"),
    ([-1.0, 5.0, 500.0], [1.0, 1.7], 40, "uniform"),
    ([-1.0, 2.0, 500.0], [1.0, 1.3], 8, "gauss"),
]


def _tangent_setup(alts, mu, n_angles, quad, n_x=400, n_lay=17, n_dirs=3,
                   seed=5):
    """float64 (od, x, T, geometry, dod, dT) with OD from transparent to
    opaque, and n_dirs random directions."""
    f64 = torch.float64
    rng = np.random.default_rng(seed)
    z0 = np.linspace(0.0, 65.0, n_lay)
    od = torch.as_tensor(10.0 ** (4.0 * rng.random((n_lay, n_x)) - 3.0))
    x = torch.linspace(690.0, 1410.0, n_x, dtype=f64)
    T = torch.as_tensor(230.0 + 60.0 * rng.random(n_lay))
    geom = (torch.tensor(mu, dtype=f64),
            torch.as_tensor(_layers_below(z0, alts), dtype=torch.int32),
            *(torch.as_tensor(a) for a in downwelling_quadrature(n_angles,
                                                                 quad)))
    dod = torch.as_tensor(rng.standard_normal((n_dirs, n_lay, n_x))) * od
    dT = torch.as_tensor(rng.standard_normal((n_dirs, n_lay)))
    return z0, od, x, T, geom, dod, dT


def _of_peak(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("alts,mu,n_angles,quad", TANGENT_CASES)
def test_tangent_plain_matches_jvp_of_tud_from_od(alts, mu, n_angles, quad):
    """The tangent mode's plain version (the up pass's forward-mode carries,
    Ld's sensitivities) against ``torch.func.jvp`` of ``planckian`` and
    ``tud_from_od`` in float64, each direction's tangents within 1e-10 of
    their peak, and the value of ``tud_compose_diff`` (K2's plain version)
    within 1e-12 of its peak (an altitude below the ground layer, two
    secants, two angle chunks and both quadratures among the cases)."""
    z0, od, x, T, geom, dod, dT = _tangent_setup(alts, mu, n_angles, quad)

    def ref(o, t):
        B = planckian(x, t).transpose(0, 1)
        r = tud_from_od(x, o, B, torch.as_tensor(z0), torch.tensor(alts),
                        mu=geom[0], n_angles=n_angles, quadrature=quad)
        return r.tau, r.Lu, r.Ld

    got = fused_tud.tud_compose_jvp_plain(od, x, 1.0 / T, *geom, dod, dT)
    for g, r in zip(fused_tud.tud_compose_diff(od, x, T, *geom), ref(od, T)):
        assert _of_peak(g, r) <= 1e-12
    for d in range(dod.shape[0]):
        _, want = torch.func.jvp(ref, (od, T), (dod[d], dT[d]))
        for g, r in zip(got, want):
            assert g.shape[1:] == r.shape
            assert _of_peak(g[d], r) <= 1e-10


@pytest.mark.parametrize("alts,mu,n_angles,quad", TANGENT_CASES)
def test_tangent_plain_matches_jax_jvp(alts, mu, n_angles, quad):
    """The tangent mode's plain version against ``jax.jvp`` of JAX's own
    ``planckian`` and scan composition ``tud_from_od`` (float64) on the
    same (od, T) and directions: each direction's tangents within 1e-10
    of their peak."""
    z0, od, x, T, geom, dod, dT = _tangent_setup(alts, mu, n_angles, quad)
    xj = jnp.asarray(x.numpy())

    def ref(o, t):
        B = jnp.swapaxes(j_planckian(xj, t), 0, 1)
        r = j_tud_from_od(xj, o, B, jnp.asarray(z0), jnp.asarray(alts),
                          mu=jnp.asarray(mu), n_angles=n_angles,
                          quadrature=quad)
        return r.tau, r.Lu, r.Ld

    got = fused_tud.tud_compose_jvp_plain(od, x, 1.0 / T, *geom, dod, dT)
    for d in range(dod.shape[0]):
        _, want = jax.jvp(ref, (jnp.asarray(od.numpy()),
                                jnp.asarray(T.numpy())),
                          (jnp.asarray(dod[d].numpy()),
                           jnp.asarray(dT[d].numpy())))
        for g, r in zip(got, want):
            r = np.array(r)
            assert r.dtype == np.float64 and g.shape[1:] == r.shape
            assert _of_peak(g[d], torch.as_tensor(r)) <= 1e-10


@pytest.mark.parametrize("alts,mu,n_angles,quad", TANGENT_CASES[1:])
def test_diff_vmap_is_the_per_direction_loop(alts, mu, n_angles, quad):
    """``tud_compose_diff`` under ``vmap(jvp)``: the batch of directions
    equals ``jvp`` direction by direction and the tangent mode's own
    tangents; the value is K2's plain version's; on the CPU nothing is
    launched."""
    _, od, x, T, geom, dod, dT = _tangent_setup(alts, mu, n_angles, quad)
    before = dict(fused_tud.LAUNCHES)

    def f(o, t):
        return fused_tud.tud_compose_diff(o, x, t, *geom)

    batch = torch.func.vmap(lambda a, b: torch.func.jvp(
        f, (od, T), (a, b))[1])(dod, dT)
    want = fused_tud.tud_compose_jvp_plain(od, x, 1.0 / T, *geom, dod, dT)
    for g, r in zip(batch, want):
        assert torch.equal(g, r)
    for d in range(dod.shape[0]):
        value, one = torch.func.jvp(f, (od, T), (dod[d], dT[d]))
        for g, r in zip(one, batch):
            assert torch.equal(g, r[d])
    for g, r in zip(value, fused_tud.tud_compose_plain(od, x, 1.0 / T,
                                                       *geom)):
        assert torch.equal(g, r)
    assert fused_tud.LAUNCHES == before
    assert fused_tud.LAUNCHES["tud_jvp"] == 0


def test_diff_missing_tangent_is_zero():
    """A ``jvp`` in the ODs alone (the temperature's tangent missing, as in
    a direction without one) is the tangent with dT = 0, and one in the
    temperatures alone is the tangent with dod = 0."""
    _, od, x, T, geom, dod, dT = _tangent_setup(*TANGENT_CASES[0],
                                                n_dirs=1)
    _, od_only = torch.func.jvp(
        lambda o: fused_tud.tud_compose_diff(o, x, T, *geom), (od,),
        (dod[0],))
    _, t_only = torch.func.jvp(
        lambda t: fused_tud.tud_compose_diff(od, x, t, *geom), (T,),
        (dT[0],))
    zero_t = fused_tud.tud_compose_jvp_plain(od, x, 1.0 / T, *geom, dod,
                                             torch.zeros_like(dT))
    zero_od = fused_tud.tud_compose_jvp_plain(od, x, 1.0 / T, *geom,
                                              torch.zeros_like(dod), dT)
    for g, r in zip(od_only, zero_t):
        assert torch.equal(g, r[0])
    for g, r in zip(t_only, zero_od):
        assert torch.equal(g, r[0])
    assert od_only[0].abs().max() > 0 and t_only[1].abs().max() > 0


@pytest.mark.parametrize("n_lay,n_zs,n_mu,n_a,error", [
    (66, 9, 1, 30, None),               # the production shape
    (66, 64, 1, 30, None),
    (290, 64, 8, 30, None),             # altitudes x secants take none
    (290, 1, 1, 40, "shared memory"),   # a second angle chunk
    (66, 65, 1, 30, "at most 64 sensor altitudes"),
    (440, 1, 1, 30, "shared memory"),
])
def test_tangent_launch_shape_limits(n_lay, n_zs, n_mu, n_a, error):
    """The tangent mode's limits: 64 altitudes, and a CTA's shared memory
    (the prefix OD and the downwelling's sensitivities of its 64 columns
    a layer, S_B apart only beyond one chunk of 32 angles, and a chunk's 8
    temperature tangents a layer) within the card's 227 KB."""
    need = fused_tud.smem_bytes_jvp(n_lay, n_a)
    per = 3 if n_a > 32 else 2
    assert need == 8 * (n_lay + 1) + 4 * (64 * per * n_lay + 8 * n_lay)
    if error is None:
        assert need <= fused_tud.MAX_SMEM
        fused_tud.check_launch_shape(n_lay, n_zs, n_mu, jvp_angles=n_a)
    else:
        with pytest.raises(ValueError, match=error):
            fused_tud.check_launch_shape(n_lay, n_zs, n_mu, jvp_angles=n_a)
