"""The kernels' per-tile grid offset and shard-local overrides (K1, K3, K4)
against radtxfr_tpu's Pallas kernels.

A spectral shard evaluates some tiles of a plan built on the whole grid:
its ``starts``/``counts`` and, per tile, the global grid index of its
first point (``k_offset``, ``pallas_xsect.py``'s ``off_ref``), while its
output is addressed locally. The JAX side runs ``xsect_pallas`` with those
overrides in interpret mode (``fast_rcp=False``); the port runs the plain
versions of its kernels with the same overrides (CPU tensors). The shard
here is three tiles of eight in a non-contiguous order, as the weighted
partition deals them, and strong lines sit on tile edges with windows
across them. Bounds: the float32 ones of each mode's existing test; in
float64 the shard must equal the matching columns of the unsharded call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.kernels.lineparams import LineParams as JLineParams
from radtxfr_tpu.kernels.pallas_xsect import UniformGrid as JGrid
from radtxfr_tpu.kernels.pallas_xsect import plan_buckets_packed as j_packed
from radtxfr_tpu.kernels.pallas_xsect import xsect_pallas
from radtxfr_tpu_torch.kernels import fused_xsect as fx
from port_fixtures import one_torch_thread  # noqa: F401

TILE, N_PTS, N_LAY = 256, 2048, 4
#: the shard's tiles, in its local order (non-contiguous, as the weighted
#: partition deals them), and their global grid offsets
SHARD_TILES = np.array([5, 2, 7])
OFFSETS = (SHARD_TILES * TILE - np.arange(SHARD_TILES.size) * TILE
           ).astype(np.int32)
#: each mode's float32 bound against the Pallas kernel, of the peak
#: (test_torch_fused_xsect.py, test_torch_xsect.py)
MODE_BOUND = {"asym": 3e-6, "core": 3e-6, "mix": 3e-6, "full": 3e-6,
              "sdvoigt": 1e-5, "corr:64:voigt": 2e-6}
#: the tangents' float32 bound, of the peak: K3's (test_torch_jacobian.py)
#: and K4's at the OD (test_torch_ht_jacobian.py::
#: test_od_sdvoigt_jvp_matches_jax); here both packages' float32 K4 lie
#: 2.8e-4 of peak from a float64 run (measured), and 1.9e-5 from each other
#: unsharded as sharded
TANGENT_BOUND = {"full": 2e-5, "sdvoigt": 2e-5}


@pytest.fixture(scope="module")
def case():
    """41 lines over 1000-1020 cm^-1 at 0.01 (eight 256-point tiles), four
    layers, 3 cm^-1 windows (300 points: every window crosses a tile edge);
    five of the strongest lines sit exactly on tile edges."""
    rng = np.random.default_rng(12)
    g = JGrid(x0=1000.0, dx=0.01, n=N_PTS)
    edges = g.x0 + g.dx * TILE * np.array([2, 3, 5, 6, 7])
    nu0 = np.sort(np.concatenate([rng.uniform(1000.5, 1019.5, 36), edges]))
    plan = j_packed(nu0, g, 3.0, tile=TILE, block="auto")
    mk = lambda lo, hi: rng.uniform(lo, hi, (N_LAY, nu0.size))  # noqa
    prm = dict(strength=mk(0.5, 2.0), gamma_d=mk(0.01, 0.05),
               gamma_0=mk(0.01, 0.1), gamma_2=mk(0.001, 0.01),
               shift0=mk(-0.01, 0.01), wing=np.full((N_LAY, nu0.size), 3.0))
    prm["strength"][:, np.isin(nu0, edges)] *= 20.0
    y_mix = rng.normal(0.0, 0.3, (N_LAY, nu0.size))
    tans = {k: rng.normal(0.0, 1.0, (2, N_LAY, nu0.size)) * s for k, s in
            (("strength", 1.0), ("gamma_d", 0.01), ("gamma_0", 0.01),
             ("gamma_2", 0.001), ("shift0", 0.001))}
    return dict(nu0=nu0, plan=plan, prm=prm, y_mix=y_mix, tans=tans)


def _overrides(plan, as_array):
    conv = jnp.asarray if as_array == "jax" else torch.as_tensor
    return dict(starts=conv(plan.starts[SHARD_TILES]),
                counts=conv(plan.counts[SHARD_TILES]),
                k_offset=conv(OFFSETS), n_tiles=SHARD_TILES.size,
                n_out=SHARD_TILES.size * TILE)


def _j_params(c, fields=None):
    f = {k: jnp.asarray(v, dtype=jnp.float32) for k, v in c["prm"].items()}
    f.update(fields or {})
    nu = jnp.asarray(np.tile(c["nu0"], (N_LAY, 1)), dtype=jnp.float32)
    return JLineParams(**f, nu0=nu, nu0_shifted=nu)


def _pallas(c, mode, shard=True, **kw):
    params = _j_params(c)
    if mode == "mix":
        params = dataclasses.replace(
            params, gamma_2=jnp.asarray(c["y_mix"], dtype=jnp.float32))
    over = _overrides(c["plan"], "jax") if shard else {}
    return np.asarray(xsect_pallas(c["plan"], params, interpret=True,
                                   n_weideman=16, mode=mode,
                                   fused_layers=True, fast_rcp=False,
                                   **over, **kw))


def _port(c, dtype):
    dp = fx.device_plan(c["plan"], np.arange(c["nu0"].size), c["nu0"],
                        device="cpu", dtype=dtype)
    t = {k: torch.as_tensor(v, dtype=dtype) for k, v in c["prm"].items()}
    return dp, torch.arange(N_LAY, dtype=torch.int32), t


def _plain(c, mode, dtype, shard=True):
    dp, lay, t = _port(c, dtype)
    over = _overrides(c["plan"], "torch") if shard else {}
    ymix = torch.as_tensor(c["y_mix"], dtype=dtype) if mode == "mix" else None
    return fx.xsect_fused_plain(dp, lay, t["shift0"], t["strength"],
                                t["gamma_d"], t["gamma_0"], t["wing"], ymix,
                                mode, 16, gamma_2=t["gamma_2"],
                                **over).numpy()


def _plain_tangent(c, mode, dtype, shard=True):
    dp, lay, t = _port(c, dtype)
    over = _overrides(c["plan"], "torch") if shard else {}
    tan = {k: torch.as_tensor(v, dtype=dtype) for k, v in c["tans"].items()}
    if mode == "full":
        return fx.xsect_fused_jvp_plain(
            dp, lay, t["shift0"], t["strength"], t["gamma_d"], t["gamma_0"],
            t["wing"], tan["shift0"], tan["strength"], tan["gamma_d"],
            tan["gamma_0"], **over).numpy()
    return fx.xsect_sdvoigt_jvp_plain(
        dp, lay, t["shift0"], t["strength"], t["gamma_d"], t["gamma_0"],
        t["gamma_2"], t["wing"], tan["shift0"], tan["strength"],
        tan["gamma_d"], tan["gamma_0"], tan["gamma_2"], **over).numpy()


def _columns(full):
    """The shard's points of an unsharded (..., N_PTS) output, in its local
    order."""
    idx = (SHARD_TILES[:, None] * TILE + np.arange(TILE)).reshape(-1)
    return full[..., idx]


@pytest.mark.parametrize("mode", list(MODE_BOUND))
def test_offset_plain_matches_pallas(case, mode):
    """K1's plain version on the shard's tiles, with their per-tile offsets,
    against the Pallas kernel with the same overrides; the Pallas shard is
    itself the matching columns of its unsharded call."""
    want = _pallas(case, mode)
    got = _plain(case, mode, torch.float32)
    assert got.shape == want.shape == (N_LAY, SHARD_TILES.size * TILE)
    ref = _pallas(case, "full") if mode == "core" else want
    peak = np.abs(ref).max()
    assert peak > 0.0 and np.abs(want).max() > 0.0
    assert np.abs(got - want).max() <= MODE_BOUND[mode] * peak, \
        np.abs(got - want).max() / peak
    np.testing.assert_array_equal(want, _columns(_pallas(case, mode,
                                                         shard=False)))


@pytest.mark.parametrize("mode", list(TANGENT_BOUND))
def test_offset_tangents_match_pallas(case, mode):
    """K3 (``full``) and K4 (``sdvoigt``) plain versions on the shard's
    tiles against ``jax.jvp`` of the differentiable Pallas call with the
    same overrides, two directions."""
    c = case
    names = (("strength", "gamma_d", "gamma_0", "shift0") if mode == "full"
             else ("strength", "gamma_d", "gamma_0", "gamma_2", "shift0"))
    over = _overrides(c["plan"], "jax")

    def f(*vals):
        params = _j_params(c, dict(zip(names, vals)))
        return xsect_pallas(c["plan"], params, interpret=True, n_weideman=16,
                            mode=mode, fused_layers=True, fast_rcp=False,
                            differentiable=True, **over)

    prim = tuple(jnp.asarray(c["prm"][k], dtype=jnp.float32) for k in names)
    want = np.stack([np.asarray(jax.jvp(f, prim, tuple(
        jnp.asarray(c["tans"][k][d], dtype=jnp.float32) for k in names))[1])
        for d in range(2)])
    got = _plain_tangent(c, mode, torch.float32)
    assert got.shape == want.shape == (2, N_LAY, SHARD_TILES.size * TILE)
    for d in range(2):
        peak = np.abs(want[d]).max()
        assert peak > 0.0
        assert np.abs(got[d] - want[d]).max() <= TANGENT_BOUND[mode] * peak


@pytest.mark.parametrize("kind", ["asym", "full", "sdvoigt",
                                  "corr:64:voigt", "jvp", "sdvoigt_jvp"])
def test_offset_shard_is_the_unsharded_columns(case, kind):
    """float64: the shard's output with offsets is the matching columns of
    the unsharded call, bit for bit (each point adds the same terms in the
    same order), for K1's passes and the K3 and K4 tangents."""
    if kind.endswith("jvp"):
        mode = "full" if kind == "jvp" else "sdvoigt"
        got = _plain_tangent(case, mode, torch.float64)
        want = _columns(_plain_tangent(case, mode, torch.float64, False))
    else:
        got = _plain(case, kind, torch.float64)
        want = _columns(_plain(case, kind, torch.float64, shard=False))
    assert np.abs(want).max() > 0.0
    np.testing.assert_array_equal(got, want)


def test_shard_plan_offsets():
    """A scalar offset spreads over the tiles, a Python zero is no offset
    at all (the kernels' nullptr), a per-tile array is taken as it is, and
    a wrong count or new tiles without their offsets raise."""
    dp = fx.DevicePlan(
        tile=4, block=2, n_tiles=3, max_blocks=1, dx=0.1, n_out=12,
        starts=torch.zeros(3, dtype=torch.int32),
        counts=torch.ones(3, dtype=torch.int32),
        k_line=torch.zeros(2, dtype=torch.int32), frac0=torch.zeros(2),
        line=torch.zeros(2, dtype=torch.int32), wcap=torch.ones(2))
    assert fx.shard_plan(dp) is dp
    assert fx.shard_plan(dp, k_offset=0).tile_off is None
    sp = fx.shard_plan(dp, k_offset=8, n_tiles=2, n_out=8)
    assert (sp.n_tiles, sp.n_out) == (2, 8)
    assert sp.tile_off.tolist() == [8, 8]
    assert sp.tile_off.dtype == torch.int32
    one = fx.shard_plan(dp, k_offset=torch.tensor([4]))
    assert one.tile_off.tolist() == [4, 4, 4]
    per = fx.shard_plan(dp, k_offset=np.array([0, 8, 4]))
    assert per.tile_off.tolist() == [0, 8, 4]
    with pytest.raises(ValueError, match="entries"):
        fx.shard_plan(dp, k_offset=np.array([1, 2]))
    with pytest.raises(ValueError, match="offsets"):
        fx.shard_plan(per, n_tiles=2)


def test_corr_offsets_stay_on_the_coarse_grid(case):
    """A correction pass takes tile offsets that are multiples of R (its
    node rows then lie on the global coarse grid) and refuses others."""
    over = _overrides(case["plan"], "torch")
    over["k_offset"] = over["k_offset"] + 32
    dp, lay, t = _port(case, torch.float64)
    with pytest.raises(ValueError, match="multiples of R"):
        fx.xsect_fused_plain(dp, lay, t["shift0"], t["strength"],
                             t["gamma_d"], t["gamma_0"], t["wing"], None,
                             "corr:64:voigt", 16, **over)
