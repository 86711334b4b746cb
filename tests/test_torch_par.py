"""The port's HITRAN ``.par`` reader (``parse_par``, its own ctypes
binding of ``native/par_parser.cpp``) against radtxfr_tpu's, and
``xsect --par`` through both CLIs.

Records are the 160-character ``.par`` records of a seeded synthetic list,
written as ``tests/test_lines.py:112-142`` writes them. The port's native
path (taken here: ``g++`` builds the library into the port's ``_build/``,
never into ``native/``) and its Python path give JAX's ``parse_par``
columns exactly, in float64; ``xsect --par`` on the port (CPU: the
kernels' plain versions) matches the JAX CLI (``--engine pallas``,
interpret mode) within the CLI's 1e-5 of the peak
(``tests/test_torch_cli.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.cli.main import build_parser as j_build_parser
from radtxfr_tpu.lines.store import parse_par as j_parse_par
from radtxfr_tpu.lines.synthetic import synthetic_lines as j_synthetic
from radtxfr_tpu.lines.tips import load_tips_tables
from radtxfr_tpu_torch.cli.main import main
from radtxfr_tpu_torch.io.afit_xs import xs_read
from radtxfr_tpu_torch.lines import native_parser
from radtxfr_tpu_torch.lines.store import parse_par
from port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
          "delta_air", "sd_air", "iso_row", "mol_id")


def _records(n, nu_min, nu_max, seed):
    """Valid 160-character .par records of a synthetic store (as
    tests/test_lines.py::_synthetic_par_text writes them)."""
    store = j_synthetic(n, nu_min=nu_min, nu_max=nu_max, seed=seed)
    _, iso_ids, _, _ = load_tips_tables()
    recs = []
    for k in range(n):
        m = int(store.mol_id[k])
        i = int(iso_ids[int(store.iso_row[k])])
        ic = "0" if i == 10 else str(i)
        rec = (
            f"{m:2d}{ic}{float(store.nu0[k]):12.6f}"
            f"{float(store.sw[k]):10.3E}{1.0:10.3E}"
            f"{float(store.gamma_air[k]):5.3f}"
            f"{float(store.gamma_self[k]):5.3f}"
            f"{float(store.elower[k]):10.4f}{float(store.n_air[k]):4.2f}"
            f"{float(store.delta_air[k]):8.5f}")
        recs.append(rec.ljust(160))
    return recs


@pytest.fixture(scope="module")
def par_file(tmp_path_factory):
    recs = _records(3000, 500.0, 1500.0, 19)
    # a short and a blank line, as files carry them, are skipped
    path = str(tmp_path_factory.mktemp("par") / "lines.par")
    with open(path, "w") as f:
        f.write("\n".join(recs[:1500] + ["", "short"] + recs[1500:]) + "\n")
    return path, recs


def _columns(store):
    h = store.host_view() if hasattr(store, "host_view") else store
    return {k: np.asarray(getattr(h, k)) for k in FIELDS}


def test_native_library_builds_in_the_port(par_file):
    """The port's binding builds its own library under _build/, named by
    the source's hash, and leaves native/ as it was."""
    before = sorted(os.listdir(os.path.join(ROOT, "native")))
    lib = native_parser.load_library()
    assert lib is not None, "g++ is expected here"
    path = native_parser.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "radtxfr_tpu_torch",
                                                 "_build")
    assert os.path.exists(path)
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == before
    assert native_parser.parse_par_native(par_file[0])["nu"].size == 3000


@pytest.mark.parametrize("route", ["native", "python_file",
                                   "python_records"])
def test_parse_par_matches_jax(par_file, route):
    """Every column equals JAX's parse_par (its native path for the file),
    float64, in the same (sorted) order."""
    path, recs = par_file
    want = _columns(j_parse_par(path, dtype=jnp.float64))
    src = recs if route == "python_records" else path
    got = parse_par(src, device="cpu", dtype=torch.float64,
                    native=route == "native")
    assert len(got) == 3000
    for k, v in _columns(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
        assert np.array_equal(getattr(got, k).numpy(), v), k
    sub = got.select_band(800.0, 900.0, margin=10.0)
    nu = sub.host["nu0"]
    assert len(sub) == int(((want["nu0"] >= 790.0)
                               & (want["nu0"] <= 910.0)).sum()) > 0
    assert ((nu >= 790.0) & (nu <= 910.0)).all()


def test_port_xsect_par_matches_jax_cli(par_file, tmp_path):
    """`xsect --par` (the band's lines, 50 cm^-1 beyond its edges): the
    same axis and header, cross-sections within 1e-5 of the peak."""
    args = ["xsect", "--par", par_file[0], "--numin", "800", "--numax",
            "810", "--dv", "0.01", "--T", "280", "--profile", "voigt"]
    main(args + ["--device", "cpu", "--output", str(tmp_path / "port")])
    j_args = j_build_parser().parse_args(args + [
        "--engine", "pallas", "--output", str(tmp_path / "jax")])
    jax.config.update("jax_enable_x64", False)
    try:
        j_args.fn(j_args)
    finally:
        jax.config.update("jax_enable_x64", True)
    X, Y, meta = xs_read(str(tmp_path / "port"))
    jX, jY, j_meta = xs_read(str(tmp_path / "jax"))
    np.testing.assert_array_equal(X, jX)
    assert meta == j_meta
    assert np.isfinite(Y).all() and np.abs(jY).max() > 0.0
    assert np.abs(Y - jY).max() <= 1e-5 * np.abs(jY).max()
