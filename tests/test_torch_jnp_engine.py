"""The port's reference (jnp) engine for SD-Voigt and Hartmann-Tran, and
its forward-mode derivatives, against radtxfr_tpu's jnp engine.

* The CPFs of ``kernels/faddeeva.py`` (``cef``, ``cpf3``,
  ``cpf_humlicek``, ``wofz_real_series_only``) over a plane that crosses
  every region of each, and the four ``profile_*`` of ``kernels/htp.py``
  (the complex pcqsdhc) over cases and wavenumbers that cross every
  pcqsdhc region (PART1 with its |Z1| > 4e3 branch, PART2, PART3 with both
  |sqrt X| branches, PART4 with and without CPF3): float64, within 1e-12
  of each output's peak.
* ``xsect_from_params(profile='sdvoigt')``, ``xsect_ht`` and
  ``compute_od_layers(engine='jnp', profile='sdvoigt'|'ht')`` (HT with and
  without HT columns): float64, within 1e-12 of the peak.
* ``tud_with_jacobian(engine='jnp')`` for ``wrt=("T", 1)``, and
  ``torch.func.jvp`` through ``compute_od_layers(engine='jnp',
  line_mixing=...)`` against ``jax.jvp`` of JAX's: float64, within 1e-10
  of each tangent's peak.
* ``xsect --engine jnp`` (sdvoigt, ht) and ``tud --engine jnp`` through
  both CLIs (the JAX CLI with x64 off, as ``tests/test_torch_cli.py`` runs
  it): within the CLI bounds of that file.

Inputs are drawn with NumPy or the JAX package's generators from fixed
seeds and handed to both packages.
"""

import dataclasses

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
from radtxfr_tpu.cli.main import build_parser as j_build_parser
from radtxfr_tpu.kernels import faddeeva as j_fad
from radtxfr_tpu.kernels import htp as j_htp
from radtxfr_tpu.kernels.ht_driver import xsect_ht as j_xsect_ht
from radtxfr_tpu.kernels.lineparams import compute_line_params as j_params
from radtxfr_tpu.kernels.linemixing_data import y_air_for_store as j_y_air
from radtxfr_tpu.kernels.xsect import xsect_from_params as j_xsect
from radtxfr_tpu.lines.derived import derived_lwir_linelist as j_derived
from radtxfr_tpu.lines.store import IsoTables as JIso
from radtxfr_tpu.lines.synthetic import synthetic_lines as j_synthetic
from radtxfr_tpu.products import od as j_od
from radtxfr_tpu.products.jacobian import tud_with_jacobian as j_jacobian
from radtxfr_tpu_torch.atmos.profile import AtmosphericState
from radtxfr_tpu_torch.cli.main import main
from radtxfr_tpu_torch.io.afit_xs import xs_read
from radtxfr_tpu_torch.kernels import faddeeva, htp
from radtxfr_tpu_torch.kernels.ht_driver import xsect_ht
from radtxfr_tpu_torch.kernels.lineparams import compute_line_params
from radtxfr_tpu_torch.kernels.xsect import pad_params, xsect_from_params
from radtxfr_tpu_torch.lines.store import IsoTables, LineStore
from radtxfr_tpu_torch.products.jacobian import tud_with_jacobian
from radtxfr_tpu_torch.products.od import compute_od_layers
from port_fixtures import one_torch_thread  # noqa: F401

F64 = dict(device="cpu", dtype=torch.float64)
FIELDS = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
          "delta_air", "sd_air", "iso_row", "mol_id")
STATE = ("z0", "z1", "pl", "p", "T", "vmr")


def _close(got, want, bound=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    peak = np.abs(want).max()
    assert peak > 0.0
    err = np.abs(got - want).max() / peak
    assert err <= bound, err


def _port_lines(j_store):
    h = j_store.host_view()
    return LineStore.from_numpy(**{k: np.asarray(getattr(h, k))
                                   for k in FIELDS}, **F64)


def _port_state(atm, layers=None):
    sel = (lambda a: a) if layers is None else (lambda a: a[layers])
    return AtmosphericState.from_numpy(
        **{f: sel(np.asarray(getattr(atm, f))) for f in STATE},
        mol_ids=atm.mol_ids, **F64)


@pytest.fixture(scope="module")
def iso():
    return JIso.load(), IsoTables.load(**F64)


# --------------------------------------------------------------------------
# the CPFs and the pcqsdhc family
# --------------------------------------------------------------------------

def _plane():
    """x in [-40, 40], y in [0, 20] with the region edges sampled: |z| = 8,
    the region-2 line |x| = 18.1 y + 1.65 (y <= 0.85), |x| + y = 15, and
    the real axis."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-40.0, 40.0, 4000)
    y = rng.uniform(0.0, 20.0, 4000) ** 2 / 20.0
    t = rng.uniform(0.0, 2.0 * np.pi, 300)
    yr = rng.uniform(0.0, 0.85, 300)
    xs = np.concatenate([x, 8.0 * np.cos(t), 18.1 * yr + 1.65,
                         -(18.1 * yr + 1.65), rng.uniform(-30, 30, 200)])
    ys = np.concatenate([y, 8.0 * np.abs(np.sin(t)), yr, yr, np.zeros(200)])
    return xs, ys


def test_cpf_regions_of_the_plane():
    """The plane crosses each CPF region (the Humlicek CPF's three, the
    Weideman/asymptotic split)."""
    x, y = _plane()
    in3 = np.sqrt(x * x + y * y) > 8.0
    in2 = ~in3 & (y <= 0.85) & (np.abs(x) >= 18.1 * y + 1.65)
    assert in3.sum() > 100 and in2.sum() > 100 and (~in3 & ~in2).sum() > 100
    wei = np.abs(x) + y < 15.0
    assert wei.sum() > 100 and (~wei).sum() > 100


@pytest.mark.parametrize("name", ["cpf3", "cpf_humlicek",
                                  "wofz_real_series_only", "cef"])
def test_cpf_matches_jax(name):
    x, y = _plane()
    if name == "cpf3":
        keep = x * x + y * y > 1.0   # the bare series is for large |z|
        x, y = x[keep], y[keep]
    want = getattr(j_fad, name)(jnp.asarray(x), jnp.asarray(y))
    got = getattr(faddeeva, name)(torch.as_tensor(x), torch.as_tensor(y))
    if name == "cef":
        assert got.dtype == torch.complex128
        want, got = (jnp.real(want), jnp.imag(want)), (got.real, got.imag)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        _close(g.numpy(), w)
    # float32 inputs give complex64 / float32
    g32 = getattr(faddeeva, name)(torch.as_tensor(x, dtype=torch.float32),
                                  torch.as_tensor(y, dtype=torch.float32))
    assert g32.dtype == torch.complex64 if name == "cef" else \
        g32[0].dtype == torch.float32


#: (sg0, gamma_d, gamma0, gamma2, shift0, shift2, nuvc, eta): pcqsdhc's
#: regions by construction (PART1: c2t = 0; PART2: |X| << |Y|, Gamma2 tiny
#: against Gamma_D; PART3: |Y| << |X|, Gamma_D tiny; PART4 otherwise, its
#: CPF3 sub-case near |Z| = 8)
PCQ_CASES = [
    (0.0, 0.005, 0.05, 0.0, 0.002, 0.0, 0.0, 0.0),
    (0.0, 0.001, 0.01, 0.0, 0.0, 0.0, 0.0, 0.0),
    (0.0, 0.005, 0.05, 0.005, 0.002, 0.0, 0.0, 0.0),
    (0.0, 0.005, 0.05, 0.005, 0.002, 0.001, 0.02, 0.3),
    (0.0, 0.005, 0.05, 0.005, 0.002, 0.001, 0.02, 0.3 + 0.1j),
    (0.0, 0.05, 0.001, 0.0005, 0.0, 0.0, 0.0, 0.0),
    (0.0, 0.0005, 0.3, 0.03, 0.02, 0.002, 0.0, 0.0),
    (0.0, 0.01, 1e-4, 1e-9, 0.0, 0.0, 0.0, 0.0),
    (0.0, 1e-9, 0.05, 1e-6, 0.0, 0.0, 0.0, 0.0),
    (0.0, 1e-9, 0.05, 0.01, 0.001, 0.0, 0.005, 0.2),
    (0.0, 0.02, 0.01, 0.002, 0.0, 0.0, 0.0, 0.0),
]
SG = np.concatenate([np.linspace(-3.0, 3.0, 1201),
                     np.linspace(-400.0, 400.0, 801),
                     np.geomspace(1e-9, 1e-2, 60), -np.geomspace(1e-9, 1e-2,
                                                                 60)])


def _pcq_regions(sg0, gd, g0, g2, s0, s2, nuvc, eta, sg):
    """NumPy replica of pcqsdhc's region tests (hapi's):
    {region: number of points}."""
    cte = np.sqrt(np.log(2.0)) / gd
    c0, c2 = g0 + 1j * s0, g2 + 1j * s2
    c0t = (1.0 - eta) * (c0 - 1.5 * c2) + nuvc
    c2t = (1.0 - eta) * c2
    if abs(c2t) == 0.0:
        Z1 = (1j * (sg0 - sg) + c0t) * cte
        return {"part1": sg.size, "part1_big": int((abs(Z1) > 4e3).sum())}
    X = (1j * (sg0 - sg) + c0t) / c2t
    Y = (1.0 / (2.0 * cte * c2t)) ** 2
    p2 = np.abs(X) <= 3e-8 * abs(Y)
    p3 = ~p2 & (abs(Y) <= 1e-15 * np.abs(X))
    p4 = ~p2 & ~p3
    csqrtY = (g2 - 1j * s2) / (2.0 * cte * (1.0 - eta) * (g2 * g2 + s2 * s2))
    Z1 = np.sqrt(X + Y) - csqrtY
    Z2 = Z1 + 2.0 * csqrtY
    a1, a2 = np.abs(Z1), np.abs(Z2)
    cpf3 = ((np.abs(a1 - a2) <= 1.0) & (np.maximum(a1, a2) > 8.0)
            & (np.minimum(a1, a2) <= 8.0))
    big3 = np.abs(np.sqrt(X)) > 4e3
    return {"part2": int(p2.sum()), "part3_small": int((p3 & ~big3).sum()),
            "part3_big": int((p3 & big3).sum()),
            "part4_cpf": int((p4 & ~cpf3).sum()),
            "part4_cpf3": int((p4 & cpf3).sum())}


def test_pcqsdhc_cases_cross_every_region():
    seen = {}
    for case in PCQ_CASES:
        for k, v in _pcq_regions(*case, SG).items():
            seen[k] = seen.get(k, 0) + v
    assert set(seen) == {"part1", "part1_big", "part2", "part3_small",
                         "part3_big", "part4_cpf", "part4_cpf3"}
    assert min(seen.values()) > 0, seen


def _profile_args(name, case):
    sg0, gd, g0, g2, s0, s2, nuvc, eta = case
    return {"profile_ht": (sg0, gd, g0, g2, s0, s2, nuvc, eta),
            "profile_sdvoigt": (sg0, gd, g0, g2, s0, s2),
            "profile_sdrautian": (sg0, gd, g0, g2, s0, s2, nuvc),
            "profile_rautian": (sg0, gd, g0, s0, nuvc)}[name]


def _one_ulp_spread(fn, args, part):
    """How far JAX's own output moves, of its peak, when one nonzero real
    input moves by one ulp: the rounding that pcqsdhc's cancellations
    amplify (PART4 beside the PART2/PART3 thresholds, where Z1 = sqrt(X +
    Y) - sqrt(Y) of two nearly equal large numbers)."""
    sg = jnp.asarray(SG)
    base = np.asarray(fn(*args, sg)[part])
    out = 0.0
    for k, a in enumerate(args):
        if isinstance(a, complex) or a == 0.0:
            continue
        for f in (1.0 + 2.3e-16, 1.0 - 1.2e-16):
            moved = list(args)
            moved[k] = a * f
            out = max(out, np.abs(np.asarray(fn(*moved, sg)[part])
                                  - base).max())
    return out / np.abs(base).max()


@pytest.mark.parametrize("name", ["profile_ht", "profile_sdvoigt",
                                  "profile_sdrautian", "profile_rautian"])
def test_profiles_match_jax(name):
    """Each case's real and imaginary parts within 1e-12 of their peaks;
    where JAX's own result moves by more under a one-ulp change of one
    input (the three cases built for PART2 and PART3: up to 1.6e-8), within
    that."""
    ill = 0
    for case in PCQ_CASES:
        args = _profile_args(name, case)
        want = getattr(j_htp, name)(*args, jnp.asarray(SG))
        got = getattr(htp, name)(*args, torch.as_tensor(SG))
        for part, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == torch.float64
            w = np.asarray(w)
            err = np.abs(g.numpy() - w).max() / np.abs(w).max()
            if err > 1e-12:
                ill += 1
                assert err <= _one_ulp_spread(getattr(j_htp, name), args,
                                              part), (case, part, err)
    assert ill <= 6


def test_pcqsdhc_broadcasts_and_float32():
    """(lines, 1) parameters against a (1, nX) axis give (lines, nX); a
    float32 axis computes in complex64 and stays within 1e-5 of the peak
    of the float64 result."""
    g = torch.as_tensor(SG[:1201])[None, :]
    gd = torch.tensor([[0.005], [0.001]], dtype=torch.float64)
    re, im = htp.pcqsdhc(0.0, gd, 0.05, 0.005, 0.002, 0.001, 0.02, 0.3, g)
    assert re.shape == im.shape == (2, 1201)
    r32, _ = htp.pcqsdhc(0.0, gd.float(), 0.05, 0.005, 0.002, 0.001, 0.02,
                         0.3, g.float())
    assert r32.dtype == torch.float32
    _close(r32.double().numpy(), re.numpy(), 1e-5)


# --------------------------------------------------------------------------
# the line sums and the layered OD
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lines():
    """200 synthetic lines over 795-815 cm^-1, 30% of them without speed
    dependence; HT columns for 40% of them (the JAX bench's)."""
    j_store = j_synthetic(200, nu_min=795.0, nu_max=815.0, seed=5,
                          sd_zero_frac=0.3)
    rng = np.random.default_rng(6)
    live = rng.random(200) < 0.4
    extras = {"nu_HT_air": rng.uniform(0.01, 0.05, 200) * live,
              "kappa_HT_air": rng.uniform(0.0, 1.0, 200) * live,
              "eta_HT_air": rng.uniform(0.1, 0.3, 200) * live,
              "delta_HT_2_air": rng.uniform(0.0, 2e-4, 200) * live}
    return j_store, _port_lines(j_store), extras


AXIS = 800.0 + 0.01 * np.arange(1001)


@pytest.mark.parametrize("T,p", [(296.0, 1.0), (220.0, 0.1)])
def test_xsect_from_params_sdvoigt_matches_jax(lines, iso, T, p):
    j_store, store, _ = lines
    want = j_xsect(jnp.asarray(AXIS),
                   j_params(j_store, iso[0], T, p, profile="sdvoigt"),
                   profile="sdvoigt")
    prm = compute_line_params(store, iso[1], T, p, profile="sdvoigt")
    got = xsect_from_params(torch.as_tensor(AXIS), prm, "sdvoigt", 64)
    _close(got.numpy(), want)
    # inert padding changes nothing
    padded = pad_params(prm, 96)
    assert padded.nu0.shape == (288,)
    assert torch.equal(xsect_from_params(torch.as_tensor(AXIS), padded,
                                         "sdvoigt", 64), got)


@pytest.mark.parametrize("diluent,with_extras", [(None, True),
                                                 ({"air": 0.7, "self": 0.3},
                                                  True),
                                                 (None, False)])
def test_xsect_ht_matches_jax(lines, iso, diluent, with_extras):
    j_store, store, extras = lines
    ex = extras if with_extras else None
    want = j_xsect_ht(jnp.asarray(AXIS), j_store, iso[0], 260.0, 0.6,
                      diluent=diluent, extras=ex, wing_abs=2.0)
    got = xsect_ht(torch.as_tensor(AXIS), store, iso[1], 260.0, 0.6,
                   diluent=diluent, extras=ex, wing_abs=2.0)
    _close(got.numpy(), want)


LAYERS = np.array([0, 9, 25, 40])


@pytest.mark.parametrize("profile,with_extras", [("sdvoigt", False),
                                                 ("ht", True), ("ht", False)])
def test_compute_od_layers_jnp_matches_jax(lines, iso, profile,
                                           with_extras):
    """Four StdAtmos layers; HT with the air/self mix of each layer."""
    j_store, store, extras = lines
    atm = j_std_atmosphere()
    j_atm = atm.replace(**{f: getattr(atm, f)[LAYERS] for f in STATE})
    kw = dict(profile=profile, continuum="mt_ckd",
              ht_extras=extras if with_extras else None)
    want = j_od.compute_od_layers(j_store, iso[0], jnp.asarray(AXIS), j_atm,
                                  **kw)
    got = compute_od_layers(store, iso[1], AXIS, _port_state(atm, LAYERS),
                            engine="jnp", **kw)
    assert got.shape == (4, AXIS.size)
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# forward mode
# --------------------------------------------------------------------------

def test_tud_with_jacobian_jnp_matches_jax(iso):
    """40 synthetic lines, the first 5 StdAtmos layers, 800-810 cm^-1 at
    0.02, continuum 'mt_ckd': the TUD within 1e-12 and each tangent within
    1e-10 of its peak."""
    j_store = j_synthetic(40, nu_min=795.0, nu_max=815.0, seed=3)
    atm = j_std_atmosphere()
    j_atm = atm.replace(**{f: getattr(atm, f)[:5] for f in STATE})
    axis = 800.0 + 0.02 * np.arange(501)
    alts = [2.0, 100.0]
    tud_j, jac_j = j_jacobian(j_store, iso[0], jnp.asarray(axis), j_atm,
                              jnp.asarray(alts), wrt=("T", 1), n_angles=6,
                              tangent_batch=2, continuum="mt_ckd")
    tud, jac = tud_with_jacobian(_port_lines(j_store), iso[1], axis,
                                 _port_state(atm, slice(0, 5)), alts,
                                 wrt=("T", 1), n_angles=6, tangent_batch=2,
                                 continuum="mt_ckd")
    for k in ("tau", "Lu", "Ld"):
        _close(tud[k].numpy(), tud_j[k])
        for w in ("T", "1"):
            assert jac[w][k].shape == tud[k].shape + (5,)
            _close(jac[w][k].numpy(), jac_j[w][k], 1e-10)


def test_jvp_through_line_mixing_matches_jax(iso):
    """torch.func.jvp of compute_od_layers(engine='jnp', line_mixing=...)
    along a seeded (T, H2O) direction against jax.jvp of JAX's: the
    derived list, the 720.8 cm^-1 CO2 Q branch, five StdAtmos layers."""
    j_store = j_derived(694.0, 746.0)
    lm = {"y_air": j_y_air(j_store)}
    assert np.count_nonzero(lm["y_air"]) > 0
    atm = j_std_atmosphere()
    layers = np.array([0, 16, 32, 48, 60])
    j_atm = atm.replace(**{f: getattr(atm, f)[layers] for f in STATE})
    axis = 719.5 + 0.005 * np.arange(401)
    rng = np.random.default_rng(9)
    dT = rng.standard_normal(5)
    dv = rng.standard_normal(5) * 1e-4

    def j_fn(T, h2o):
        st = j_atm.replace(T=T, vmr=j_atm.vmr.at[:, 0].set(h2o))
        return j_od.compute_od_layers(j_store, iso[0], jnp.asarray(axis), st,
                                      line_mixing=lm, continuum="mt_ckd")

    want, want_t = jax.jvp(j_fn, (j_atm.T, j_atm.vmr[:, 0]),
                           (jnp.asarray(dT), jnp.asarray(dv)))
    store, st = _port_lines(j_store), _port_state(atm, layers)

    def fn(T, h2o):
        vmr = torch.cat([h2o[:, None], st.vmr[:, 1:]], dim=1)
        return compute_od_layers(store, iso[1], axis,
                                 dataclasses.replace(st, T=T, vmr=vmr),
                                 engine="jnp", line_mixing=lm,
                                 continuum="mt_ckd")

    got, got_t = torch.func.jvp(fn, (st.T, st.vmr[:, 0]),
                                (torch.as_tensor(dT), torch.as_tensor(dv)))
    _close(got.numpy(), want)
    _close(got_t.numpy(), want_t, 1e-10)


# --------------------------------------------------------------------------
# the CLIs' jnp engine
# --------------------------------------------------------------------------

def _run_jax_cli(argv):
    args = j_build_parser().parse_args(argv)
    jax.config.update("jax_enable_x64", False)
    try:
        args.fn(args)
    finally:
        jax.config.update("jax_enable_x64", True)


#: tests/test_torch_cli.py's lattice: 200 synthetic lines, 800-820 at
#: 0.01, 60 cm^-1 absolute wings, three temperatures
XS_ARGS = ["xsect", "--synthetic", "200", "--numin", "800", "--numax", "820",
           "--dv", "0.01", "--wing-abs", "60", "--T", "280", "--T-max", "290",
           "--T-step", "5", "--engine", "jnp"]


@pytest.mark.parametrize("profile", ["sdvoigt", "ht"])
def test_xsect_engine_jnp_matches_jax_cli(tmp_path, profile):
    """One AFIT_XS file per state, the same axis and header, within the
    SD-Voigt float32 bound of each file's peak (1e-5,
    tests/test_torch_xsect.py: MODE_BOUND)."""
    args = XS_ARGS + ["--profile", profile]
    main(args + ["--device", "cpu", "--output", str(tmp_path / "port")])
    _run_jax_cli(args + ["--output", str(tmp_path / "jax")])
    for T in ("280", "285", "290"):
        X, Y, meta = xs_read(str(tmp_path / f"port.T{T}_p1"))
        jX, jY, j_meta = xs_read(str(tmp_path / f"jax.T{T}_p1"))
        np.testing.assert_array_equal(X, jX)
        assert meta == j_meta
        assert np.isfinite(Y).all() and np.abs(jY).max() > 0.0
        assert np.abs(Y - jY).max() <= 1e-5 * np.abs(jY).max(), T


def test_tud_engine_jnp_matches_jax_cli(tmp_path):
    """The production command's options on 718-720 cm^-1, one member, both
    CLIs on their jnp engines (float32): tau/La/Ld within the CLI's 1e-5 of
    each one's peak (measured 4.7e-6 for tau at 2 members)."""
    args = ["tud", "--derived", "--line-mixing", "--continuum", "mt_ckd",
            "--numin", "718", "--numax", "720", "--dv", "0.005",
            "--n-atmos", "1", "--batch", "1", "--engine", "jnp"]
    main(args + ["--device", "cpu", "--output", str(tmp_path / "p.h5")])
    _run_jax_cli(args + ["--output", str(tmp_path / "j.h5")])
    with h5py.File(tmp_path / "p.h5", "r") as f, \
            h5py.File(tmp_path / "j.h5", "r") as g:
        np.testing.assert_array_equal(f["X"][...], g["X"][...])
        for k in ("tau", "La", "Ld"):
            assert f[k].shape == g[k].shape, k
            _close(f[k][...], g[k][...], 1e-5)
