"""The port's scene and sensor commands (``planck``, ``mako``, ``radiance``,
``hsi``, ``emis``, ``atmosgen``) in-process against the JAX CLI's, on a
small TUD file the test writes (the ``tud`` product layout: tau/La
(nA, nX, nZs), Ld (nA, nX), X) and on emissivity and profile inputs it
writes: ``--device cpu``, float64 on both sides (x64 on).

Where a command draws no random numbers its files equal the JAX CLI's:
every dataset within 1e-12 relative of its peak (the float32 radiance
tensor within one float32 rounding), the attributes and the CSV label maps
equal. Where it draws (``hsi``, ``atmosgen``, ``emis --features``), the
datasets, attributes and shapes are the JAX CLI's and the values hold
their invariants and repeat under ``--seed``. Without ``--device`` and
without a card every command raises.
"""

import h5py
import numpy as np
import pytest
import torch

from radtxfr_tpu.cli.main import build_parser as j_build_parser
from radtxfr_tpu_torch.cli.main import build_parser, main
from radtxfr_tpu_torch.io.h5 import Var, write_h5
from port_fixtures import one_torch_thread  # noqa: F401

N_ATM, N_ZS = 4, 3


@pytest.fixture(scope="module")
def tud_file(tmp_path_factory):
    """A TUD product file over 740-1340 cm^-1 at 0.5 cm^-1."""
    path = str(tmp_path_factory.mktemp("tud") / "tud.h5")
    rng = np.random.default_rng(21)
    X = np.arange(740.0, 1340.0, 0.5)
    shape = (N_ATM, X.size, N_ZS)
    tau = np.clip(rng.uniform(0.2, 1.0, shape), 0, 1)
    info = "(atmos, X, altitude)"
    write_h5(path, {
        "X": Var(X, units="cm^{-1}", name="Wavenumbers"),
        "tau": Var(tau, units="none", name="Transmittance", info=info),
        "La": Var(rng.uniform(0.5, 8.0, shape), units="µW/(cm^2 sr cm^{-1})",
                  name="Upwelling (path) radiance", info=info),
        "Ld": Var(rng.uniform(0.5, 8.0, shape[:2]),
                  units="µW/(cm^2 sr cm^{-1})",
                  name="Hemispherically averaged downwelling radiance"),
        "Altitudes": Var(np.array([1.0, 5.0, 500.0]), units="km"),
    })
    return path


def _jax(argv):
    args = j_build_parser().parse_args(argv)
    args.fn(args)


def _port(argv, device="cpu"):
    main(argv + (["--device", device] if device else []))


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k][...], dict(f[k].attrs)) for k in f}


def _same_h5(got, want, bound=1e-12, f32_ulps=None):
    got, want = _read(got), _read(want)
    assert sorted(got) == sorted(want)
    for k, (a, attrs) in got.items():
        b, j_attrs = want[k]
        assert attrs == j_attrs, k
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        tol = (f32_ulps * np.finfo(np.float32).eps if a.dtype == np.float32
               and f32_ulps else bound)
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), k


def test_planck_matches_jax(capsys):
    """``planck``: the printed radiance range equals the JAX CLI's and the
    brightness-temperature round trip closes within 1e-9 K on both."""
    _jax(["planck"])
    j_line = capsys.readouterr().out.strip().splitlines()[-1]
    _port(["planck"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.split(";")[0] == j_line.split(";")[0]
    for s in (line, j_line):
        assert float(s.rsplit(" ", 2)[-2]) <= 1e-9


@pytest.mark.parametrize("extra", [[], ["--sort-atmos"],
                                   ["--fwhm-sf", "1.3", "--shift", "0.4",
                                    "--scale", "0.9998"]],
                         ids=["default", "sorted", "calibrated"])
def test_mako_file_matches_jax(tud_file, tmp_path, extra):
    """``mako``: the channelized file equals the JAX CLI's."""
    argv = ["mako", "--input", tud_file] + extra
    _jax(argv + ["--output", str(tmp_path / "j.h5")])
    _port(argv + ["--output", str(tmp_path / "p.h5")])
    _same_h5(str(tmp_path / "p.h5"), str(tmp_path / "j.h5"))
    sorted_ = "--sort-atmos" in extra
    assert ("atmos_order" in _read(str(tmp_path / "p.h5"))) == sorted_


def test_radiance_file_matches_jax(tud_file, tmp_path):
    """``radiance``: the (nX, nE, nA, nT) tensor at the CLI defaults (24
    materials, dT -10..10 K by 0.5) and the index split equal the JAX
    CLI's; the float32 tensor within one float32 rounding."""
    argv = ["radiance", "--input", tud_file, "--n-materials", "5",
            "--dT-step", "2.5"]
    _jax(argv + ["--output", str(tmp_path / "j.h5")])
    _port(argv + ["--output", str(tmp_path / "p.h5")])
    _same_h5(str(tmp_path / "p.h5"), str(tmp_path / "j.h5"), f32_ulps=1)
    L = _read(str(tmp_path / "p.h5"))["L"][0]
    assert L.shape == (1200, 5, N_ATM, 9) and (L > 0).all()


def test_hsi_file_layout_and_seed(tud_file, tmp_path):
    """``hsi`` draws its scene: the JAX CLI's datasets, attributes and
    shapes; fractions summing to 1, labels in range, finite positive L;
    the same file under the same seed and another under another."""
    argv = ["hsi", "--input", tud_file, "--n-pixels", "30", "--n-atm", "3",
            "--n-materials", "8"]
    _jax(argv + ["--output", str(tmp_path / "j.h5")])
    for name, seed in (("a", "1"), ("b", "1"), ("c", "2")):
        _port(argv + ["--seed", seed, "--output",
                      str(tmp_path / f"{name}.h5")])
    got, want = _read(str(tmp_path / "a.h5")), _read(str(tmp_path / "j.h5"))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k][1] == want[k][1] and got[k][0].shape == want[k][0].shape
    L = got["L"][0]
    assert L.shape == (3, 30, 1200) and np.isfinite(L).all() and (L > 0).all()
    np.testing.assert_allclose(got["mix_frac"][0].sum(axis=2), 1.0,
                               rtol=1e-14)
    assert got["emis_labels"][0].min() >= 0 and \
        got["emis_labels"][0].max() < 8
    assert got["atmos_labels"][0].min() >= 0 and \
        got["atmos_labels"][0].max() < N_ATM
    b, c = _read(str(tmp_path / "b.h5")), _read(str(tmp_path / "c.h5"))
    for k in got:
        np.testing.assert_array_equal(got[k][0], b[k][0])
    assert not np.array_equal(got["L"][0], c["L"][0])


def _same_db(got, want):
    for ext in (".npz",):
        a, b = np.load(got + ext), np.load(want + ext)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert np.abs(a[k] - b[k]).max() <= 1e-12 * np.abs(b[k]).max()
    _same_h5(got + ".h5", want + ".h5")
    assert open(got + ".csv").read() == open(want + ".csv").read()


@pytest.mark.parametrize("source", ["synthetic", "input", "aster"])
def test_emis_files_match_jax(tmp_path, capsys, source):
    """``emis`` from the synthetic DB (with mixtures and the MAKO DB), an
    ``--input`` file of reflectances and an ``--aster-dir`` of exports:
    the .npz/.h5/.csv files equal the JAX CLI's; ``--features`` reports
    the same k and shapes."""
    rng = np.random.default_rng(5)
    argv = ["emis", "--mako"]
    if source == "synthetic":
        argv += ["--n-materials", "4", "--mixtures", "--n-fractions", "5",
                 "--features", "3"]
    elif source == "input":
        X = np.linspace(700.0, 1400.0, 400)
        np.savez(tmp_path / "in.npz", X=X,
                 emis=rng.uniform(0.01, 0.15, (3, X.size)))
        argv += ["--input", str(tmp_path / "in.npz"), "--reflectance"]
    else:
        d = tmp_path / "aster"
        d.mkdir()
        for i in range(3):
            wl = np.sort(rng.uniform(6.0, 15.5, 200))
            rows = "\n".join(f"{a:.5f} {b:.4f}" for a, b in
                             zip(wl, rng.uniform(1.0, 20.0, wl.size)))
            (d / f"m{i}.txt").write_text(
                f"Name: m{i}\nY Units: Reflectance (percent)\n\n{rows}\n")
        argv += ["--aster-dir", str(d)]
    _jax(argv + ["--output", str(tmp_path / "j")])
    j_out = capsys.readouterr().out
    _port(argv + ["--output", str(tmp_path / "p")])
    out = capsys.readouterr().out
    _same_db(str(tmp_path / "p"), str(tmp_path / "j"))
    _same_db(str(tmp_path / "p_MAKO"), str(tmp_path / "j_MAKO"))
    same = [s for s in j_out.splitlines() if not s.startswith(("wrote",
                                                               "feature"))]
    assert [s for s in out.splitlines()
            if not s.startswith(("wrote", "feature"))] == same
    if "--features" in argv:
        f = [s for s in out.splitlines() if s.startswith("feature")][0]
        j_f = [s for s in j_out.splitlines() if s.startswith("feature")][0]
        assert f.split("PCA")[0] == j_f.split("PCA")[0]
        assert "NMF basis (3, 721)" in f and "NMF basis (3, 721)" in j_f


def test_atmosgen_file_layout_and_seed(tmp_path):
    """``atmosgen`` draws its model: the JAX CLI's arrays and shapes (its
    stand-in ensemble and inputs equal, NumPy draws); generated profiles
    with T > 0, no supersaturated layer (the RH filter), air-mass labels in
    range; the same file under the same seed; ``--input`` profiles used."""
    from radtxfr_tpu_torch.scene.generative import rh_filter

    argv = ["atmosgen", "--n-ensemble", "24", "--n-airmass", "1",
            "--n-aug", "2"]
    _jax(argv + ["--output", str(tmp_path / "j.npz")])
    _port(argv + ["--output", str(tmp_path / "a.npz")])
    _port(argv + ["--output", str(tmp_path / "b.npz")])
    got, want = np.load(tmp_path / "a.npz"), np.load(tmp_path / "j.npz")
    assert sorted(got) == sorted(want)
    for k in ("z", "P", "T_in", "H2O_in", "O3_in"):
        np.testing.assert_array_equal(got[k], want[k])
    n = got["T"].shape[0]
    assert 0 < n <= 48 and got["H2O"].shape == got["O3"].shape == (n, 66)
    assert got["airmass"].shape == got["loglik"].shape == (n,)
    assert (got["T"] > 0).all() and np.isfinite(got["loglik"]).all()
    assert set(np.unique(got["airmass"])) == {0}
    assert rh_filter(torch.as_tensor(got["P"]), torch.as_tensor(got["T"]),
                     torch.as_tensor(got["H2O"])).all()
    b = np.load(tmp_path / "b.npz")
    for k in got:
        np.testing.assert_array_equal(got[k], b[k])
    np.savez(tmp_path / "in.npz", T=want["T_in"][:12],
             H2O=want["H2O_in"][:12], O3=want["O3_in"][:12])
    _port(["atmosgen", "--input", str(tmp_path / "in.npz"), "--n-aug", "2",
           "--n-airmass", "1", "--output", str(tmp_path / "c.npz")])
    c = np.load(tmp_path / "c.npz")
    np.testing.assert_array_equal(c["T_in"], want["T_in"][:12])


@pytest.mark.parametrize("argv", [["planck"], ["mako", "--input", "{tud}"],
                                  ["radiance", "--input", "{tud}"],
                                  ["hsi", "--input", "{tud}"], ["emis"],
                                  ["atmosgen"]], ids=lambda a: a[0])
def test_commands_need_the_card_by_default(tud_file, argv):
    """Without ``--device`` each command runs on the card, so it raises
    where there is none: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    argv = [a.replace("{tud}", tud_file) for a in argv]
    assert build_parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(argv, device=None)
