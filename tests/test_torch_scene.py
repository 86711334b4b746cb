"""The port's scene modules and their helpers against radtxfr_tpu, in float64
on the CPU, on NumPy-seeded inputs:

* closed forms within 1e-12 relative of the peak: Planck, brightness
  temperature and ``bt2l`` (both unit modes), the grid and reshape helpers,
  ``apparent_radiance``, the HSI composition fed JAX's own draws, the OD and
  feature transforms, ``regrid_profiles``, the robust statistics and
  ``fit_planck``;
* bit-exact where both packages draw with NumPy: ``synthetic_db``,
  ``gen_indices``, the emissivity mixtures;
* the iterative fits (EM, VB, NMF, FastICA) from JAX's initial draws
  within the bound each test states, the iteration counts cut;
* where the port draws its own numbers (``torch.Generator``), shapes,
  ranges and reproducibility under the seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.core import grid as j_grid
from radtxfr_tpu.core import planck as j_planck
from radtxfr_tpu.core import reshape as j_reshape
from radtxfr_tpu.io import h5 as j_h5
from radtxfr_tpu.products.radiance import apparent_radiance as j_radiance
from radtxfr_tpu.scene import emis_features as j_feat
from radtxfr_tpu.scene import emissivity as j_emis
from radtxfr_tpu.scene import generative as j_gen
from radtxfr_tpu.scene import planck_fit as j_pfit
from radtxfr_tpu.scene import robust as j_robust
from radtxfr_tpu.scene.hsi import hsi_generate as j_hsi
from radtxfr_tpu_torch.core import grid, planck, reshape
from radtxfr_tpu_torch.io import h5
from radtxfr_tpu_torch.products.radiance import apparent_radiance
from radtxfr_tpu_torch.scene import emis_features as feat
from radtxfr_tpu_torch.scene import emissivity as emis
from radtxfr_tpu_torch.scene import generative as gen
from radtxfr_tpu_torch.scene import hsi, planck_fit, robust
from port_fixtures import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")
F64 = dict(device="cpu", dtype=torch.float64)
CLOSED = 1e-12


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(a):
    return torch.as_tensor(np.array(a))


def _cpu_gen(seed=0):
    return torch.Generator(device="cpu").manual_seed(seed)


# ---------------------------------------------------------------------------
# core: Planck trio, grids, reshapes; io: h5, gen_indices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wavelength", [False, True])
def test_planck_trio_matches_jax(wavelength):
    """planckian, brightness_temperature and bt2l within 1e-12 of JAX's;
    non-positive or non-finite inputs give NaN (and ``bad_value``)."""
    rng = np.random.default_rng(0)
    X = np.linspace(7.0, 14.0, 40) if wavelength else \
        np.linspace(700.0, 1400.0, 40)
    T = rng.uniform(180.0, 330.0, (40, 3))
    L = np.asarray(j_planck.bt2l(jnp.asarray(X), jnp.asarray(T),
                                 wavelength=wavelength))
    got = planck.bt2l(X, _t(T), wavelength=wavelength)
    assert _rel(got, L) <= CLOSED
    Lb = L.copy()
    Lb[0, 0], Lb[3, 1], Lb[5, 2] = 0.0, -1.0, np.inf
    want = np.asarray(j_planck.brightness_temperature(
        jnp.asarray(X), jnp.asarray(Lb), wavelength=wavelength))
    got = planck.brightness_temperature(X, _t(Lb), wavelength=wavelength)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.isnan(want).sum() == 3
    assert _rel(got.numpy()[ok], want[ok]) <= CLOSED
    got = planck.brightness_temperature(X, _t(Lb), wavelength=wavelength,
                                        bad_value=-1.0)
    assert (got.numpy()[~ok] == -1.0).all()
    Tb = T.copy()
    Tb[1, 1] = 0.0
    want = np.asarray(j_planck.bt2l(jnp.asarray(X), jnp.asarray(Tb),
                                    wavelength=wavelength))
    got = planck.bt2l(X, _t(Tb), wavelength=wavelength).numpy()
    assert np.isnan(got[1, 1]) and np.isnan(want[1, 1])
    B = planck.planckian(X, _t(T[:, 0]), wavelength=wavelength)
    wantB = np.asarray(j_planck.planckian(jnp.asarray(X), jnp.asarray(T[:, 0]),
                                          wavelength=wavelength))
    assert B.shape == (40, 40) and _rel(B, wantB) <= CLOSED


@pytest.mark.parametrize("fn", ["planckian", "brightness_temperature",
                                "bt2l"])
def test_planck_trio_needs_the_card_for_arrays(fn):
    """With no tensor among its inputs a Planck function works on the
    card, so it raises where there is none; a CPU tensor keeps it on the
    CPU, arrays beside it included."""
    X, T = np.linspace(700.0, 1400.0, 5), np.full(5, 290.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(planck, fn)(X, T)
    got = getattr(planck, fn)(X, _t(T))
    assert got.device.type == "cpu" and torch.isfinite(got).all()


def test_grid_and_reshape_match_jax():
    """make_spectral_axis and pad_to_multiple equal JAX's; rs1d/rs2d/rsnd
    give JAX's shapes and values and round-trip."""
    for a in ((690.0, 1410.0, 0.25), (800.0, 801.0, 0.3), (0.0, 1.0, 1.0)):
        np.testing.assert_array_equal(grid.make_spectral_axis(*a),
                                      j_grid.make_spectral_axis(*a))
    for n, m in ((0, 8), (1, 8), (8, 8), (1000, 128), (1025, 512)):
        assert grid.pad_to_multiple(n, m) == j_grid.pad_to_multiple(n, m)
    rng = np.random.default_rng(1)
    for shape in ((), (5,), (5, 3), (5, 3, 2, 4)):
        y = rng.random(shape)
        for fn, j_fn in ((reshape.rs1d, j_reshape.rs1d),
                         (reshape.rs2d, j_reshape.rs2d)):
            got, dims = fn(_t(y))
            want, j_dims = j_fn(jnp.asarray(y))
            assert tuple(dims) == tuple(j_dims)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            back = reshape.rsnd(got, dims if fn is reshape.rs1d
                                else (y.shape if y.ndim >= 2 else dims))
            assert back.numel() == y.size


def test_gen_indices_and_read_h5_match_jax(tmp_path):
    """gen_indices bit-exact with JAX's (NumPy default_rng); read_h5 reads
    what write_h5 wrote, as JAX's reader does, attributes included."""
    for n, seed in ((10, 42), (2952, 0), (1000, 7)):
        for got, want in zip(h5.gen_indices(n, seed=seed),
                             j_h5.gen_indices(n, seed=seed)):
            np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "v.h5")
    h5.write_h5(path, {"a": h5.Var(np.arange(6.0).reshape(2, 3), units="K",
                                   name="temp", info="i", label="$T$"),
                       "b": np.arange(4)})
    got, want = h5.read_h5(path), j_h5.read_h5(path)
    assert sorted(got) == sorted(want) == ["a", "b"]
    for k in got:
        np.testing.assert_array_equal(got[k].data, want[k].data)
        assert (got[k].units, got[k].name, got[k].info, got[k].label) == \
            (want[k].units, want[k].name, want[k].info, want[k].label)


# ---------------------------------------------------------------------------
# products: apparent radiance
# ---------------------------------------------------------------------------

def test_apparent_radiance_matches_jax():
    """The (nX, nE, nA[, nT]) broadcast within 1e-12 of JAX's, with and
    without dT, and Ls; on the device and in the dtype asked for."""
    rng = np.random.default_rng(4)
    nX, nE, nA = 30, 4, 3
    X = np.linspace(800.0, 1200.0, nX)
    em = rng.uniform(0.8, 1.0, (nX, nE))
    Ts = rng.uniform(270.0, 310.0, nA)
    tau, Lu, Ld = (rng.uniform(0.1, 1.0, (nX, nA)) for _ in range(3))
    dT = np.arange(-2.0, 2.5, 0.5)
    for d in (None, dT):
        L, Ls = apparent_radiance(X, em, Ts, tau, Lu, Ld, dT=d,
                                  return_Ls=True, **F64)
        jL, jLs = j_radiance(X, em, Ts, tau, Lu, Ld, dT=d, return_Ls=True)
        assert _rel(L, jL) <= CLOSED and _rel(Ls, jLs) <= CLOSED
    assert L.shape == (nX, nE, nA, dT.size) and L.dtype == torch.float64
    L32 = apparent_radiance(X, em, Ts, _t(tau).float(), Lu, Ld, dT=dT)
    assert L32.dtype == torch.float32 and L32.device.type == "cpu"
    assert _rel(L32.double(), L) <= 1e-6


# ---------------------------------------------------------------------------
# scene: emissivity databases
# ---------------------------------------------------------------------------

def test_synthetic_db_and_mixtures_match_jax():
    """synthetic_db draws JAX's spectra bit for bit (NumPy default_rng);
    pairwise mixtures and resampling match (1e-12)."""
    X = np.arange(700.0, 1300.0, 2.0)
    for n, seed, x in ((24, 0, None), (5, 3, X)):
        got = emis.synthetic_db(n, X=x, seed=seed, **CPU)
        want = j_emis.synthetic_db(n, X=x, seed=seed)
        np.testing.assert_array_equal(got.emis.numpy(), np.asarray(want.emis))
        np.testing.assert_array_equal(got.X.numpy(), np.asarray(want.X))
        np.testing.assert_array_equal(got.material_id.numpy(),
                                      np.asarray(want.material_id))
        assert got.names == want.names and got.n_materials == n
    db, j_db = emis.synthetic_db(5, X=X, seed=3, **CPU), \
        j_emis.synthetic_db(5, X=X, seed=3)
    mix, j_mix = db.pairwise_mixtures(n_fractions=7), \
        j_db.pairwise_mixtures(n_fractions=7)
    assert mix.n_materials == j_mix.n_materials == 10 * 7
    assert _rel(mix.emis, j_mix.emis) <= CLOSED
    X2 = np.linspace(720.0, 1280.0, 97)
    assert _rel(db.resample(X2).emis, j_db.resample(X2).emis) <= CLOSED


def test_emissivity_ingest_and_files_match_jax(tmp_path):
    """from_spectra (reflectance in percent, µm axes, duplicates), ASTER
    export files through read_aster_export and load_aster_dir (coverage
    filter), and save_db's .npz/.h5/.csv equal JAX's; load_db reads both."""
    rng = np.random.default_rng(6)
    d = tmp_path / "aster"
    d.mkdir()
    for i in range(4):
        lo = 5.0 if i != 2 else 9.0                 # file 2 fails coverage
        wl = np.sort(rng.uniform(lo, 16.0, 300))
        wl = np.concatenate([wl, wl[-1:]])          # a duplicate point
        refl = 100.0 * rng.uniform(0.01, 0.2, wl.size)
        lines = [f"Name: sample {i}", "Type: mineral",
                 "X Units: Wavelength (micrometers)",
                 "Y Units: Reflectance (percent)", ""]
        lines += [f"{a:.6f}\t{b:.5f}" for a, b in zip(wl, refl)]
        (d / f"s{i}.txt").write_text("\n".join(lines))
    got, skipped = emis.load_aster_dir(str(d), **CPU)
    want, j_skipped = j_emis.load_aster_dir(str(d))
    assert [p.split("/")[-1] for p in skipped] == \
        [p.split("/")[-1] for p in j_skipped] == ["s2.txt"]
    assert got.names == want.names
    assert _rel(got.emis, want.emis) <= CLOSED
    np.testing.assert_array_equal(got.X.numpy(), np.asarray(want.X))
    meta, wl, r = emis.read_aster_export(str(d / "s0.txt"))
    j_meta, j_wl, j_r = j_emis.read_aster_export(str(d / "s0.txt"))
    assert meta == j_meta
    np.testing.assert_array_equal(wl, j_wl)
    np.testing.assert_array_equal(r, j_r)
    spectra = [(np.linspace(690, 1410, 200), rng.uniform(0.85, 1.0, 200))
               for _ in range(3)]
    Xo = np.arange(700.0, 1400.0, 5.0)
    for refl in (False, True):
        g = emis.EmissivityDB.from_spectra(spectra, Xo, reflectance=refl,
                                           **CPU)
        w = j_emis.EmissivityDB.from_spectra(spectra, Xo, reflectance=refl)
        assert _rel(g.emis, w.emis) <= CLOSED
    emis.save_db(got, str(tmp_path / "p"))
    j_emis.save_db(want, str(tmp_path / "j"))
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    for k in ("X", "emis", "material_ID"):
        a = np.load(tmp_path / "p.npz")[k]
        b = np.load(tmp_path / "j.npz")[k]
        assert a.dtype == b.dtype and _rel(a, b) <= CLOSED
    for k, v in h5.read_h5(str(tmp_path / "p.h5")).items():
        w = j_h5.read_h5(str(tmp_path / "j.h5"))[k]
        assert (v.units, v.name, v.info) == (w.units, w.name, w.info)
    back = emis.load_db(str(tmp_path / "j"), **CPU)
    np.testing.assert_array_equal(back.emis.numpy(), np.asarray(want.emis))
    assert back.material_id.dtype == torch.int32


# ---------------------------------------------------------------------------
# scene: HSI cubes
# ---------------------------------------------------------------------------

def _tud_ensemble(nA=4, nX=50, seed=8):
    rng = np.random.default_rng(seed)
    X = np.linspace(800.0, 1200.0, nX)
    tau = rng.uniform(0.3, 1.0, (nA, nX))
    Lu, Ld = (rng.uniform(0.5, 3.0, (nA, nX)) for _ in range(2))
    return X, tau, Lu, Ld, rng.uniform(280.0, 310.0, nA)


def _jax_hsi_draws(key, n_tud, n_db, n_pixels, n_emis, n_mix, n_atm):
    """The raw draws of JAX's hsi_generate for ``key``, in its order."""
    k_atm, k_scene = jax.random.split(key)
    labels = jax.random.randint(k_atm, (n_atm,), 0, n_tud)
    draws = []
    for k in jax.random.split(k_scene, n_atm):
        k_em, k_pick, k_frac, k_T = jax.random.split(k, 4)
        draws.append((
            jax.random.randint(k_em, (n_emis,), 0, n_db),
            jax.random.randint(k_pick, (n_pixels, n_mix), 0, n_emis),
            jax.random.uniform(k_frac, (n_pixels, n_mix)),
            jax.random.normal(k_T, (n_pixels,))))
    return [np.asarray(labels)] + [np.stack([np.asarray(d[i]) for d in draws])
                                   for i in range(4)]


def test_hsi_composition_matches_jax():
    """The port's composition fed JAX's draws gives JAX's cube (1e-12) and
    labels, fractions and temperatures; the public generator's output has
    the right shapes, fractions summing to 1, labels in range, and is the
    same under the same seed."""
    X, tau, Lu, Ld, Ts = _tud_ensemble()
    db = j_emis.synthetic_db(7, X=X, seed=1)
    E = np.asarray(db.emis)
    kw = dict(n_pixels=20, dT=3.0, n_emis=4, n_mix=3, n_atm=3)
    key = jax.random.key(5)
    want = j_hsi(key, X, tau, Lu, Ld, Ts, E, **kw)
    labels, members, pick, frac_u, z = _jax_hsi_draws(
        key, tau.shape[0], E.shape[0], kw["n_pixels"], kw["n_emis"],
        kw["n_mix"], kw["n_atm"])
    got = hsi._hsi_from_draws(*map(_t, (X, tau, Lu, Ld, Ts, E, labels,
                                        members, pick, frac_u, z)), kw["dT"])
    assert _rel(got["L"], want["L"]) <= CLOSED
    for k in ("atmos_labels", "emis_labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("mix_frac", "Ts_pix"):
        assert _rel(got[k], want[k]) <= CLOSED
    again = hsi._hsi_compose(*map(_t, (X, tau, Lu, Ld, E)),
                             *(got[k] for k in ("atmos_labels", "emis_labels",
                                                "mix_frac", "Ts_pix")))
    np.testing.assert_array_equal(again.numpy(), got["L"].numpy())

    out = hsi.hsi_generate(_cpu_gen(3), X, tau, Lu, Ld, Ts, E, **kw, **CPU)
    assert out["L"].shape == (3, 20, X.size)
    assert out["emis_labels"].shape == out["mix_frac"].shape == (3, 20, 3)
    np.testing.assert_allclose(out["mix_frac"].sum(dim=2).numpy(), 1.0,
                               rtol=1e-14)
    assert 0 <= int(out["emis_labels"].min()) and \
        int(out["emis_labels"].max()) < E.shape[0]
    assert 0 <= int(out["atmos_labels"].min()) and \
        int(out["atmos_labels"].max()) < tau.shape[0]
    assert torch.isfinite(out["L"]).all() and (out["L"] > 0).all()
    same = hsi.hsi_generate(_cpu_gen(3), X, tau, Lu, Ld, Ts, E, **kw, **CPU)
    other = hsi.hsi_generate(_cpu_gen(4), X, tau, Lu, Ld, Ts, E, **kw, **CPU)
    np.testing.assert_array_equal(same["L"].numpy(), out["L"].numpy())
    assert not torch.equal(other["L"], out["L"])


# ---------------------------------------------------------------------------
# scene: emissivity features
# ---------------------------------------------------------------------------

def _od_matrix(n=30, nX=60, seed=2):
    E = np.asarray(j_emis.synthetic_db(n, X=np.linspace(700, 1300, nX),
                                       seed=seed).emis)
    return E, np.asarray(j_feat.od_transform(E))


def test_od_transform_pca_and_bspline_match_jax():
    """od_transform/od_inverse and the B-spline design, fit and
    reconstruction (minimum-norm solve) within 1e-12; the whitened PCA's
    reconstruction (sign-free) within 1e-12 and its components up to sign."""
    E, od = _od_matrix()
    assert _rel(feat.od_transform(_t(E)), od) <= CLOSED
    assert _rel(feat.od_inverse(_t(od)), j_feat.od_inverse(od)) <= CLOSED
    model, feats, recon = feat.pca_compress(_t(E), n_components=8)
    j_model, _, j_recon = j_feat.pca_compress(E, n_components=8)
    assert _rel(recon, j_recon) <= CLOSED
    c, jc = model.components.numpy(), np.asarray(j_model.components)
    sign = np.sign((c * jc).sum(axis=1))
    assert _rel(c * sign[:, None], jc) <= 1e-10
    assert _rel(model.explained_variance_ratio,
                j_model.explained_variance_ratio) <= CLOSED
    X = np.linspace(700, 1300, 60)
    np.testing.assert_array_equal(feat.bspline_design(X, 12),
                                  j_feat.bspline_design(X, 12))
    fit = feat.bspline_fit_emissivity(X, _t(E.T), n_knots=12)
    j_fit = j_feat.bspline_fit_emissivity(X, E.T, n_knots=12)
    assert _rel(fit.coefs, j_fit.coefs) <= CLOSED
    assert _rel(fit.reconstruct(), j_fit.reconstruct()) <= CLOSED


def test_nmf_and_fast_ica_from_jax_draws():
    """NMF and FastICA from JAX's initial draws (the key's normal draws)
    against JAX's fits: NMF's factors within 1e-10 after 60 updates;
    FastICA's unmixing, its sources on held-out rows and its mixing matrix
    within 1e-8 after 40 iterations, the SVD's sign of each whitening row
    aligned (flipping row i of the whitening and column i of W0 gives the
    same sources)."""
    E, od = _od_matrix()
    k, key = 6, jax.random.PRNGKey(3)
    j_m = j_feat.nmf(od, k, key=key, n_iter=60)
    kw_, kh = jax.random.split(key)
    X = jnp.asarray(od)
    scale = float(jnp.sqrt(jnp.maximum(X.mean(), 1e-9) / k))
    W0 = scale * np.abs(np.asarray(jax.random.normal(kw_, (od.shape[0], k))))
    H0 = scale * np.abs(np.asarray(jax.random.normal(kh, (k, od.shape[1]))))
    m = feat._nmf(_t(od), _t(W0), _t(H0), n_iter=60)
    assert _rel(m.W, j_m.W) <= 1e-10 and _rel(m.H, j_m.H) <= 1e-10
    assert _rel(m.inverse_transform(), j_m.inverse_transform()) <= 1e-10

    train, held = od[:24], od[24:]
    j_ica = j_feat.fast_ica(train, k, key=key, n_iter=40)
    W0 = np.asarray(jax.random.normal(key, (k, k)))
    first = feat._fast_ica(_t(train), _t(W0), n_iter=0)
    sign = np.sign((first.whiten.numpy() * np.asarray(j_ica.whiten)).sum(1))
    ica = feat._fast_ica(_t(train), _t(W0 * sign[None, :]), n_iter=40)
    assert _rel(ica.whiten.numpy() * sign[:, None], j_ica.whiten) <= 1e-10
    assert _rel(ica.unmix.numpy() * sign[None, :], j_ica.unmix) <= 1e-8
    assert _rel(ica.transform(_t(held)), j_ica.transform(held)) <= 1e-8
    assert _rel(ica.mixing, j_ica.mixing) <= 1e-8
    S = ica.transform(_t(train))
    assert _rel(ica.inverse_transform(S), j_ica.inverse_transform(
        np.asarray(j_ica.transform(train)))) <= 1e-8
    # the public functions draw from a generator: reproducible by seed
    a = feat.nmf(_t(od), k, generator=_cpu_gen(1), n_iter=5)
    b = feat.nmf(_t(od), k, generator=_cpu_gen(1), n_iter=5)
    np.testing.assert_array_equal(a.H.numpy(), b.H.numpy())
    assert (a.H >= 0).all()
    c = feat.fast_ica(_t(train), k, generator=_cpu_gen(1), n_iter=5)
    assert c.unmix.shape == (k, k) and c.mixing.shape == (od.shape[1], k)


# ---------------------------------------------------------------------------
# scene: the generative model
# ---------------------------------------------------------------------------

def _ensemble(n=40, seed=0):
    from radtxfr_tpu_torch.cli.main import atmosgen_ensemble
    from radtxfr_tpu_torch.atmos.profile import std_atmosphere_raw

    t = std_atmosphere_raw()
    T, H2O, O3 = atmosgen_ensemble(n, seed)
    return t[:, 1], t[:, 4], T, H2O, O3


def test_feature_transforms_match_jax():
    """mf2mol_cum/mol_cum2mf, mf2rh/rh_filter, trans_T/itrans_T,
    trans_C/itrans_C and atmos_to_features/features_to_atmos (with the
    rejection masks) within 1e-12 of JAX's."""
    z, P, T, H2O, O3 = _ensemble()
    Pt, Tt, Ht, Ot = map(_t, (P, T, H2O, O3))
    c = gen.mf2mol_cum(Ht, Pt, Tt)
    assert _rel(c, j_gen.mf2mol_cum(H2O, P, T)) <= CLOSED
    assert _rel(gen.mol_cum2mf(c, Pt, Tt),
                j_gen.mol_cum2mf(np.asarray(c), P, T)) <= CLOSED
    H_wet = H2O * 3.0
    assert _rel(gen.mf2rh(Pt, Tt, _t(H_wet)), j_gen.mf2rh(P, T, H_wet)) \
        <= CLOSED
    np.testing.assert_array_equal(gen.rh_filter(Pt, Tt, _t(H_wet)).numpy(),
                                  np.asarray(j_gen.rh_filter(P, T, H_wet)))
    X, tv, wX = gen.atmos_to_features(Pt, Tt, Ht, Ot, Tm=Tt.mean(dim=0))
    jX, jtv, jwX = j_gen.atmos_to_features(P, T, H2O, O3, Tm=T.mean(axis=0))
    assert _rel(X, jX) <= CLOSED and _rel(wX, jwX) <= CLOSED
    rng = np.random.default_rng(9)
    # half the rows exact (accepted), half perturbed (rejected)
    Xn = np.array(jX)
    Xn[20:] += 0.01 * rng.standard_normal(Xn[20:].shape)
    got = gen.features_to_atmos(_t(Xn), tv, Pt, T=Tt,
                                cH2O=gen.mf2mol_cum(Ht, Pt, Tt),
                                cO3=gen.mf2mol_cum(Ot, Pt, Tt))
    want = j_gen.features_to_atmos(jnp.asarray(Xn), jtv, P, T=T,
                                   cH2O=j_gen.mf2mol_cum(H2O, P, T),
                                   cO3=j_gen.mf2mol_cum(O3, P, T))
    for a, b in zip(got[:3], want[:3]):
        assert _rel(a, b) <= CLOSED
    ok, j_ok = got[3].numpy(), np.asarray(want[3])
    np.testing.assert_array_equal(ok, j_ok)
    assert 0 < ok.sum() < ok.size


def _gmm_close(got, want, bound):
    for f in ("weights", "means", "chols"):
        assert _rel(getattr(got, f), getattr(want, f)) <= bound, f


def test_gmm_fits_from_jax_draws():
    """EM and the variational fit from JAX's initial indices (its
    ``jax.random.choice`` draws) against JAX's fits: weights, means and
    Cholesky factors within 1e-8 after 30 EM and 60 VB steps; then
    log-densities, predictions and pruning from those models within
    1e-12; the public fits reproducible under a generator's seed."""
    z, P, T, H2O, O3 = _ensemble(60)
    feats = np.asarray(j_gen.atmos_to_features(P, T, H2O, O3)[0])
    Xr = np.asarray(j_gen.pca_fit(feats, 4).transform(feats))
    key = jax.random.PRNGKey(7)
    k0 = np.asarray(jax.random.choice(key, Xr.shape[0], (5,), replace=False))
    want = j_gen.gmm_fit(key, Xr, 5, n_iter=30)
    got = gen._gmm_fit(_t(Xr), _t(k0), n_iter=30)
    _gmm_close(got, want, 1e-8)
    want = j_gen.bgmm_fit(key, Xr, 5, n_iter=60)
    got = gen._bgmm_fit(_t(Xr), _t(k0), n_iter=60)
    _gmm_close(got, want, 1e-8)
    lp = gen.gmm_log_prob(want_t := gen.GMMModel(
        weights=_t(want.weights), means=_t(want.means),
        chols=_t(want.chols)), _t(Xr))
    assert _rel(lp, j_gen.gmm_log_prob(want, Xr)) <= CLOSED
    np.testing.assert_array_equal(gen.gmm_predict(want_t, _t(Xr)).numpy(),
                                  np.asarray(j_gen.gmm_predict(want, Xr)))
    pruned, j_pruned = gen.gmm_prune(want_t), j_gen.gmm_prune(want)
    _gmm_close(pruned, j_pruned, CLOSED)
    # with replacement where there are fewer rows than components
    k0 = np.asarray(jax.random.choice(key, 3, (5,), replace=True))
    _gmm_close(gen._bgmm_fit(_t(Xr[:3]), _t(k0), n_iter=10),
               j_gen.bgmm_fit(key, Xr[:3], 5, n_iter=10), 1e-8)
    a = gen.bgmm_fit(_cpu_gen(2), _t(Xr), 5, n_iter=20)
    b = gen.bgmm_fit(_cpu_gen(2), _t(Xr), 5, n_iter=20)
    np.testing.assert_array_equal(a.means.numpy(), b.means.numpy())
    s = gen.gmm_sample(_cpu_gen(1), a, 50)
    assert s.shape == (50, 4) and torch.isfinite(s).all()


def test_float32_airmass_fit_of_the_stand_in_ensemble_is_nan():
    """``atmosgen``'s stand-in ensemble perturbs T by one amplitude, so its
    air-mass features T_surf and lapse are collinear: in float32 the
    variational fit of ``airmass_labels`` (300 steps, JAX's initial draws)
    is NaN, the port's and JAX's (x64 off) alike, and the port's float64
    fit is finite (its parity with JAX's is
    :func:`test_gmm_fits_from_jax_draws`); so ``atmosgen`` works in
    float64 on every device."""
    z, P, T, H2O, O3 = _ensemble(64)
    key = jax.random.PRNGKey(0)
    k0 = np.asarray(jax.random.choice(key, 64, (5,), replace=False))
    feats, fits = {}, {}
    for dt in (torch.float32, torch.float64):
        feats[dt] = gen._airmass_features(*(torch.as_tensor(a).to(dt)
                                            for a in (z, P, T, H2O, O3)))
        assert feats[dt].dtype == dt and torch.isfinite(feats[dt]).all()
        fits[dt] = gen._bgmm_fit(feats[dt], _t(k0), n_iter=300)
    assert torch.isnan(fits[torch.float32].weights).all()
    assert torch.isfinite(fits[torch.float64].weights).all()
    with jax.enable_x64(False):
        want = j_gen.bgmm_fit(key, jnp.asarray(feats[torch.float32].numpy()), 5,
                              n_iter=300)
        assert want.weights.dtype == jnp.float32
        assert jnp.isnan(want.weights).all()


def test_cholesky_of_a_non_pd_matrix_is_nan():
    """A covariance that is not positive definite gives JAX's factor (NaN
    on and below the diagonal), where ``torch.linalg.cholesky`` raises;
    a positive-definite one in the same batch keeps its factor."""
    bad = np.array([[1.0, 2.0], [2.0, 1.0]])
    good = np.array([[2.0, 0.5], [0.5, 1.0]])
    got = gen._cholesky(_t(np.stack([bad, good]))).numpy()
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(bad)))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(got[0], want)     # NaNs where JAX's are
    np.testing.assert_allclose(got[1], np.linalg.cholesky(good), rtol=1e-15)
    with pytest.raises(Exception):
        torch.linalg.cholesky(_t(bad))
    got32 = gen._cholesky(_t(np.stack([bad, good])).float())
    assert torch.isnan(torch.diagonal(got32[0])).all() and \
        torch.isfinite(got32[1]).all()


def test_atmos_generator_invariants_and_seed():
    """The per-air-mass augmentation: labels, counts, profile shapes,
    T > 0, the RH filter holding, finite log-likelihoods, and the same
    output under the same seed."""
    z, P, T, H2O, O3 = _ensemble(40)
    g = _cpu_gen(0)
    labels = gen.airmass_labels(g, _t(z), _t(P), _t(T), _t(H2O), _t(O3),
                                n_airmass=3)
    assert labels.shape == (40,) and labels.min() >= 0 and labels.max() < 3
    out = gen.gen_samples_per_airmass(g, _t(z), _t(P), _t(T), _t(H2O),
                                      _t(O3), labels, n_pca=5, n_gmm=3,
                                      n_aug=2)
    n = out["T"].shape[0]
    assert 0 < n <= 2 * 40
    assert out["H2O"].shape == out["O3"].shape == (n, 66)
    assert out["labels"].shape == out["ll"].shape == (n,)
    assert (out["T"] > 0).all() and np.isfinite(out["ll"]).all()
    assert set(np.unique(out["labels"])) <= set(np.unique(labels))
    assert np.asarray(j_gen.rh_filter(P, out["T"], out["H2O"])).all()
    g2 = _cpu_gen(0)
    labels2 = gen.airmass_labels(g2, _t(z), _t(P), _t(T), _t(H2O), _t(O3),
                                 n_airmass=3)
    out2 = gen.gen_samples_per_airmass(g2, _t(z), _t(P), _t(T), _t(H2O),
                                       _t(O3), labels2, n_pca=5, n_gmm=3,
                                       n_aug=2)
    np.testing.assert_array_equal(labels, labels2)
    np.testing.assert_array_equal(out["T"], out2["T"])


# ---------------------------------------------------------------------------
# scene: robust statistics, Planck fit; atmos: regrid
# ---------------------------------------------------------------------------

def test_robust_and_planck_fit_match_jax():
    """mad, robust_z (both axes), qn_scale, estimate_tau and fit_planck
    within 1e-12 of JAX's."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((30, 40)) + rng.standard_cauchy((30, 40)) * 0.1
    for axis in (None, 0, 1):
        assert _rel(robust.mad(_t(x), axis=axis),
                    j_robust.mad(x, axis=axis)) <= CLOSED
        assert _rel(robust.robust_z(_t(x), axis=axis),
                    j_robust.robust_z(x, axis=axis)) <= CLOSED
    for n in (9, 10):
        assert _rel(robust.qn_scale(_t(x[0, :n])),
                    j_robust.qn_scale(x[0, :n])) <= CLOSED
    L = 5.0 + np.abs(rng.standard_normal((25, 80)))
    assert _rel(robust.estimate_tau(_t(L), smooth_window=9),
                j_robust.estimate_tau(L, smooth_window=9)) <= CLOSED
    X = np.linspace(800.0, 1200.0, 60)
    spec = 0.93 * np.asarray(j_planck.planckian(X, 301.7))
    got = planck_fit.fit_planck(_t(X), _t(spec))
    want = j_pfit.fit_planck(X, spec)
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) <= CLOSED * max(abs(float(b)), 1e-3)
    assert abs(float(got[0]) - 301.7) < 0.05


def test_regrid_and_tigr_match_jax(tmp_path):
    """load_tigr_mat (a TIGR-style .mat the test writes), regrid_profiles
    (a batched state; omitted species keep the base's) within 1e-12 of
    JAX's, jacobian_inputs and std_atmosphere_raw equal."""
    from scipy.io import savemat

    from radtxfr_tpu.atmos import profile as j_profile
    from radtxfr_tpu.atmos import regrid as j_regrid
    from radtxfr_tpu_torch.atmos import profile, regrid

    np.testing.assert_array_equal(profile.std_atmosphere_raw(),
                                  j_profile.std_atmosphere_raw())
    rng = np.random.default_rng(13)
    nz, n = 40, 3
    zs = np.linspace(0.0, 80.0, nz)
    mat = {"P": 1013.0 * np.exp(-zs / 7.0)[None, :],
           "T": 288.0 - 4.0 * np.minimum(zs, 12.0)[None, :]
           + rng.normal(0, 1, (n, nz)),
           "H2O": 1e4 * np.exp(-zs / 2.0)[None, :] * rng.uniform(0.5, 1.5,
                                                                 (n, 1)),
           "O3": 1e-6 * rng.uniform(0.5, 1.5, (n, nz)),
           "z": np.tile(zs, (n, 1))}
    savemat(tmp_path / "tigr.mat", mat)
    got = regrid.load_tigr_mat(str(tmp_path / "tigr.mat"))
    want = j_regrid.load_tigr_mat(str(tmp_path / "tigr.mat"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for kw in (dict(T=got["T"], h2o=got["H2O"], o3=got["O3"]),
               dict(T=got["T"][:1])):
        st = regrid.regrid_profiles(zs, dtype=torch.float64, **CPU, **kw)
        j_st = j_regrid.regrid_profiles(zs, dtype=jnp.float64, **kw)
        for f in ("z0", "z1", "pl", "p", "T", "vmr"):
            assert getattr(st, f).shape == np.shape(getattr(j_st, f))
            assert _rel(getattr(st, f), getattr(j_st, f)) <= CLOSED, f
        assert st.mol_ids == j_st.mol_ids
    with pytest.raises(ValueError, match="at least one"):
        regrid.regrid_profiles(zs, **CPU)
    a = np.linspace(200, 300, 5)
    for x, y in zip(regrid.jacobian_inputs(a, a * 1e-3, a * 1e-6),
                    j_regrid.jacobian_inputs(a, a * 1e-3, a * 1e-6)):
        np.testing.assert_array_equal(x, y)
