"""Both CLIs in-process: the production path, `tud --derived --line-mixing
--continuum mt_ckd`, on a 1001-point grid with 2 members (HDF5 products
compared), and the `xsect` lattice on a small band (AFIT_XS files compared):
the port (CPU tensors: the kernels' plain versions) against the JAX CLI.

The JAX CLI runs in float32 (x64 off for the call, as on its chip): its
jnp engine cannot run line mixing under x64.
"""

import h5py
import jax
import numpy as np
import pytest
import torch

from radtxfr_tpu.cli.main import build_parser as j_build_parser
from radtxfr_tpu_torch.cli.main import build_parser, main, run_xsect
from radtxfr_tpu_torch.io.afit_xs import xs_read
from port_fixtures import one_torch_thread  # noqa: F401

ARGS = ["tud", "--derived", "--line-mixing", "--continuum", "mt_ckd",
        "--numin", "718", "--numax", "723", "--dv", "0.005", "--n-atmos", "2",
        "--batch", "2"]


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][...] for k in ("X", "tau", "La", "Ld", "Altitudes")}


@pytest.fixture(scope="module")
def port_products(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("port") / "tud.h5")
    main(ARGS + ["--device", "cpu", "--output", path])
    return _read(path)


@pytest.mark.parametrize("engine,bound", [
    # the JAX production builder: the same plans and the same wing clamps
    # (measured <= 1.9e-6 of peak)
    ("pallas", 1e-5),
    # The jnp engine evaluates every member's full runtime wing, while both
    # production builders clamp runtime wings to the plan bound sized on
    # the base atmosphere (vmr margin 1.5); the members' -N(0, 5 K) colder
    # states exceed it. Measured: the JAX package's own two engines differ
    # by 5.3e-4 of peak in La here, and a port plan sized on the perturbed
    # state matches jnp to 1e-12 (float64).
    ("jnp", 1e-3),
])
def test_port_cli_matches_jax_cli(port_products, tmp_path, engine, bound):
    path = str(tmp_path / "jax.h5")
    args = j_build_parser().parse_args(ARGS + ["--engine", engine,
                                               "--output", path])
    jax.config.update("jax_enable_x64", False)
    try:
        args.fn(args)
    finally:
        jax.config.update("jax_enable_x64", True)
    want = _read(path)
    np.testing.assert_array_equal(port_products["X"], want["X"])
    np.testing.assert_allclose(port_products["Altitudes"], want["Altitudes"],
                               rtol=1e-7)
    for k in ("tau", "La", "Ld"):
        got, ref = port_products[k], want[k]
        assert got.shape == ref.shape, k
        assert np.isfinite(got).all(), k
        assert np.abs(got - ref).max() <= bound * np.abs(ref).max(), k


def test_port_cli_jacobian_matches_jax_cli(tmp_path):
    """`tud --jacobian --jacobian-wrt T`: the port CLI on the CPU against
    the JAX CLI's Pallas engine (interpret mode, float32), the d*_dT arrays
    of the HDF5 files within 5e-4 of each one's peak, the JAX package's
    bound between its Jacobian engines (test_pallas_xsect.py:376);
    measured <= 8e-6 (dtau_dT)."""
    args = ["tud", "--derived", "--continuum", "mt_ckd", "--numin", "718",
            "--numax", "723", "--dv", "0.005", "--n-atmos", "1", "--batch",
            "1", "--jacobian", "--jacobian-wrt", "T"]
    keys = ("dtau_dT", "dLu_dT", "dLd_dT")
    port = str(tmp_path / "port.h5")
    main(args + ["--device", "cpu", "--output", port])
    ref = str(tmp_path / "jax.h5")
    j_args = j_build_parser().parse_args(args + ["--engine", "pallas",
                                                 "--output", ref])
    jax.config.update("jax_enable_x64", False)
    try:
        j_args.fn(j_args)
    finally:
        jax.config.update("jax_enable_x64", True)
    with h5py.File(port, "r") as f, h5py.File(ref, "r") as g:
        assert set(f) == set(g)
        for k in keys:
            got, want = f[k][...], g[k][...]
            assert got.shape == want.shape, k
            assert np.isfinite(got).all(), k
            peak = np.abs(want).max()
            assert peak > 0.0, k
            assert np.abs(got - want).max() <= 5e-4 * peak, k


#: 200 synthetic lines, 800-820 cm^-1 at 0.01, three temperatures, 60 cm^-1
#: absolute wings: a 2048-point correction tile clears the coarse-far
#: disjointness bound (~48 cm^-1 here), so Voigt and SD-Voigt go coarse
XS_ARGS = ["xsect", "--synthetic", "200", "--numin", "800", "--numax", "820",
           "--dv", "0.01", "--wing-abs", "60", "--T", "280", "--T-max", "290",
           "--T-step", "5"]


def _run_jax_cli(args):
    j_args = j_build_parser().parse_args(args)
    jax.config.update("jax_enable_x64", False)
    try:
        j_args.fn(j_args)
    finally:
        jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("profile,bound", [
    ("voigt", 2e-6), ("lorentz", 2e-6), ("doppler", 2e-6),
    # the SD-Voigt float32 bound (tests/test_torch_xsect.py: MODE_BOUND)
    ("sdvoigt", 1e-5)])
def test_port_xsect_matches_jax_cli(tmp_path, profile, bound):
    """`xsect` through both CLIs (JAX: --engine pallas, interpret mode),
    one AFIT_XS file per state, read back with xs_read: the same axis and
    header, cross-sections within ``bound`` of each file's peak; Voigt and
    SD-Voigt take the coarse-far route."""
    args = XS_ARGS + ["--profile", profile]
    modes = run_xsect(build_parser().parse_args(args + ["--device", "cpu"]),
                      "cpu")["modes"]
    if profile in ("voigt", "sdvoigt"):
        assert any(m.startswith("corr:64:") for m in modes), modes
    else:
        assert modes == [profile]
    main(args + ["--device", "cpu", "--output", str(tmp_path / "port")])
    _run_jax_cli(args + ["--engine", "pallas", "--output",
                         str(tmp_path / "jax")])
    for T in ("280", "285", "290"):
        X, Y, meta = xs_read(str(tmp_path / f"port.T{T}_p1"))
        jX, jY, j_meta = xs_read(str(tmp_path / f"jax.T{T}_p1"))
        np.testing.assert_array_equal(X, jX)
        assert meta == j_meta
        assert np.isfinite(Y).all() and np.abs(jY).max() > 0.0
        assert np.abs(Y - jY).max() <= bound * np.abs(jY).max(), T


@pytest.mark.parametrize("T_max", [None, "290"])
def test_port_xsect_ht_matches_jax_cli(tmp_path, T_max):
    """`xsect --profile ht` through both CLIs (JAX: --engine pallas,
    interpret mode): the CLI takes no HT columns, so the lines route to
    pcqsdhc's SD-Voigt and Voigt degenerations, on the coarse-far route;
    the AFIT_XS files within the SD-Voigt float32 bound of each file's
    peak (tests/test_torch_xsect.py: MODE_BOUND)."""
    args = XS_ARGS[:-4] + (["--T-max", T_max, "--T-step", "5"] if T_max
                           else []) + ["--profile", "ht"]
    modes = run_xsect(build_parser().parse_args(args + ["--device", "cpu"]),
                      "cpu")["modes"]
    assert "ht" not in modes and "corr:64:sdvoigt" in modes, modes
    main(args + ["--device", "cpu", "--output", str(tmp_path / "port")])
    _run_jax_cli(args + ["--engine", "pallas", "--output",
                         str(tmp_path / "jax")])
    names = [f".T{T}_p1" for T in ("280", "285", "290")] if T_max else [""]
    for name in names:
        X, Y, meta = xs_read(str(tmp_path / f"port{name}"))
        jX, jY, j_meta = xs_read(str(tmp_path / f"jax{name}"))
        np.testing.assert_array_equal(X, jX)
        assert meta == j_meta
        assert np.isfinite(Y).all() and np.abs(jY).max() > 0.0
        assert np.abs(Y - jY).max() <= 1e-5 * np.abs(jY).max(), name


def test_port_xsect_jnp_and_par_match_jax_cli(tmp_path):
    """``--engine jnp`` (the reference engine) and ``--par`` (the native
    .par parser), which raised before they were ported, through both CLIs
    on the lattice's band: the lines of a .par file written from the
    synthetic list (tests/test_lines.py's records), the JAX CLI on its jnp
    engine; the same axis and header, within 2e-6 of each file's peak."""
    from radtxfr_tpu.lines.synthetic import synthetic_lines as j_synthetic
    from radtxfr_tpu.lines.tips import load_tips_tables

    store = j_synthetic(200, nu_min=740.0, nu_max=880.0, seed=0)
    iso_ids = load_tips_tables()[1]
    par = str(tmp_path / "lines.par")
    with open(par, "w") as f:
        for k in range(200):
            i = int(iso_ids[int(store.iso_row[k])])
            f.write((f"{int(store.mol_id[k]):2d}{'0' if i == 10 else i}"
                     f"{float(store.nu0[k]):12.6f}{float(store.sw[k]):10.3E}"
                     f"{1.0:10.3E}{float(store.gamma_air[k]):5.3f}"
                     f"{float(store.gamma_self[k]):5.3f}"
                     f"{float(store.elower[k]):10.4f}"
                     f"{float(store.n_air[k]):4.2f}"
                     f"{float(store.delta_air[k]):8.5f}").ljust(160) + "\n")
    args = ["xsect", "--par", par, "--numin", "800", "--numax", "820",
            "--dv", "0.01", "--wing-abs", "60", "--T", "280",
            "--engine", "jnp"]
    main(args + ["--device", "cpu", "--output", str(tmp_path / "port")])
    _run_jax_cli(args + ["--output", str(tmp_path / "jax")])
    X, Y, meta = xs_read(str(tmp_path / "port"))
    jX, jY, j_meta = xs_read(str(tmp_path / "jax"))
    np.testing.assert_array_equal(X, jX)
    assert meta == j_meta and meta["db_name"] == par[:128]
    assert np.isfinite(Y).all() and np.abs(jY).max() > 0.0
    assert np.abs(Y - jY).max() <= 2e-6 * np.abs(jY).max()
