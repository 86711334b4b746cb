"""The port's file formats (``radtxfr_tpu_torch/io/{mbi,envi,lblrtm}.py``)
against ``radtxfr_tpu.io``'s on the CPU.

* MBI (both interleaves, with the YAML sidecar), ENVI (every interleave),
  TAPE12, TAPE3 (with line-coupling entries) and TAPE5 files written by the
  port are byte-identical to JAX's from the same inputs (the port's given
  tensors, JAX's NumPy arrays).
* Each package reads the other's files to the same arrays.
* ``tape3_to_linestore``'s columns and mixing dict equal JAX's (float64),
  and ``default_continuum_factors`` its defaulting.
"""

import time

import numpy as np
import pytest
import torch

from radtxfr_tpu.io import envi as jax_envi, lblrtm as jax_lblrtm
from radtxfr_tpu.io import mbi as jax_mbi

from radtxfr_tpu_torch.io import envi, lblrtm, mbi
from port_fixtures import one_torch_thread  # noqa: F401


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def cube():
    return np.random.default_rng(0).normal(size=(5, 4, 3))


@pytest.mark.parametrize("ext", ["bsq", "bip"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_mbi_bytes_and_cross_read(tmp_path, cube, ext, dtype, monkeypatch):
    # the MAT header carries scipy's time.asctime(): one clock for both
    # writers, so a second that ticks between them changes no byte
    monkeypatch.setattr(time, "asctime",
                        lambda *a: "Sun Oct 18 00:00:00 2026")
    data = cube.astype(dtype)
    rows, bands = np.arange(4) * 0.5, np.linspace(8.0, 12.0, 5)
    hdr = dict(Units="W", Scale=2.0, Sensor="test")
    a, b = str(tmp_path / f"jax.{ext}"), str(tmp_path / f"port.{ext}")
    jax_mbi.mbi_export(a, data, rows=rows, bands=bands, sidecar=True, **hdr)
    mbi.mbi_export(b, torch.as_tensor(data), rows=torch.as_tensor(rows),
                   bands=bands, sidecar=True, **hdr)
    assert _bytes(a) == _bytes(b)
    ya = _bytes(str(tmp_path / "jax.yaml"))
    yb = _bytes(str(tmp_path / "port.yaml"))
    assert ya.replace(b"jax." + ext.encode(), b"") == \
        yb.replace(b"port." + ext.encode(), b"")
    for reader, path in ((mbi.mbi_read, a), (jax_mbi.mbi_read, b)):
        got, r, c, bnd, header = reader(path)
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(r, rows)
        np.testing.assert_array_equal(bnd, bands)
        assert str(header["Sensor"][0, 0][0]) == "test"


def test_mbi_refuses_what_jax_refuses(tmp_path, cube):
    for export in (jax_mbi.mbi_export, mbi.mbi_export):
        with pytest.raises(ValueError, match="extension"):
            export(str(tmp_path / "x.img"), cube)
        with pytest.raises(ValueError, match="not MBI-exportable"):
            export(str(tmp_path / "x.bsq"), cube.astype(np.complex128))


@pytest.mark.parametrize("interleave", ["bsq", "bil", "bip"])
def test_envi_bytes_and_cross_read(tmp_path, cube, interleave):
    data = cube.astype(np.float32)
    wl = np.linspace(8.0, 12.0, 5)
    a, b = str(tmp_path / "jax.hdr"), str(tmp_path / "port.hdr")
    jax_envi.write_envi(a, data, interleave=interleave, wavelength=wl,
                        sensor_type="test")
    envi.write_envi(b, torch.as_tensor(data), interleave=interleave,
                    wavelength=torch.as_tensor(wl), sensor_type="test")
    assert _bytes(a) == _bytes(b)
    assert _bytes(str(tmp_path / "jax.img")) == \
        _bytes(str(tmp_path / "port.img"))
    for reader, path in ((envi.read_envi, a), (jax_envi.read_envi, b)):
        got, h = reader(path)
        np.testing.assert_array_equal(got, data)
        np.testing.assert_allclose(h["wavelength"], wl, rtol=0, atol=1e-6)
        assert h["interleave"] == interleave


def test_tape12_bytes_and_cross_read(tmp_path):
    nu = np.linspace(700.0, 705.0, 5001)
    od = np.random.default_rng(1).uniform(0.0, 3.0, nu.size)
    a, b = str(tmp_path / "TAPE12_jax"), str(tmp_path / "TAPE12_port")
    jax_lblrtm.write_tape12(a, nu, od, panel_size=2400)
    lblrtm.write_tape12(b, torch.as_tensor(nu), torch.as_tensor(od),
                        panel_size=2400)
    assert _bytes(a) == _bytes(b)
    for reader, path in ((lblrtm.read_tape12, a),
                         (jax_lblrtm.read_tape12, b)):
        x, y = reader(path)
        x0, y0 = jax_lblrtm.read_tape12(a)
        np.testing.assert_array_equal(x, x0)
        np.testing.assert_array_equal(y, y0)


@pytest.fixture(scope="module")
def tape3_columns():
    rng = np.random.default_rng(2)
    n = 700
    mol = rng.choice([1, 2, 3], n)
    cols = dict(nu0=rng.uniform(700.0, 800.0, n),
                sw=10.0 ** rng.uniform(-25, -19, n),
                gamma_air=rng.uniform(0.02, 0.1, n),
                elower=rng.uniform(0.0, 2000.0, n), mol_id=mol,
                local_iso_id=np.ones(n, dtype=int),
                gamma_self=rng.uniform(0.1, 0.4, n),
                n_air=rng.uniform(0.5, 0.8, n),
                delta_air=rng.normal(0.0, 0.003, n))
    coupling = {int(k): rng.normal(0.0, 0.01, 8).astype(np.float32)
                for k in rng.choice(np.nonzero(mol == 2)[0], 20,
                                    replace=False)}
    return cols, coupling


def test_tape3_bytes_cross_read_and_linestore(tmp_path, tape3_columns):
    cols, coupling = tape3_columns
    a, b = str(tmp_path / "TAPE3_jax"), str(tmp_path / "TAPE3_port")
    jax_lblrtm.write_tape3(a, **cols, coupling=coupling, block_lines=100)
    lblrtm.write_tape3(b, **{k: torch.as_tensor(v) for k, v in cols.items()},
                       coupling=coupling, block_lines=100)
    assert _bytes(a) == _bytes(b)
    want = jax_lblrtm.read_tape3(a)
    for got in (lblrtm.read_tape3(a), jax_lblrtm.read_tape3(b)):
        assert set(got) == set(want)
        for k in want:
            if k == "coupling":
                for c in ("index", "yg"):
                    np.testing.assert_array_equal(got[k][c], want[k][c])
            elif isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k] == want[k]
    # band selection at the block level
    sub = lblrtm.read_tape3(a, nu_min=740.0, nu_max=760.0)
    sub_j = jax_lblrtm.read_tape3(a, nu_min=740.0, nu_max=760.0)
    np.testing.assert_array_equal(sub["nu0"], sub_j["nu0"])
    assert sub["blocks"] == sub_j["blocks"]

    store, mix = lblrtm.tape3_to_linestore(a, device="cpu",
                                           dtype=torch.float64)
    store_j, mix_j = jax_lblrtm.tape3_to_linestore(a)
    for k in ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
              "delta_air", "sd_air", "iso_row", "mol_id"):
        np.testing.assert_array_equal(np.asarray(getattr(store, k)),
                                      np.asarray(getattr(store_j, k)))
    assert store.sw.dtype == torch.float64
    np.testing.assert_array_equal(mix["y_air"], mix_j["y_air"])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mf_ppmv=[400.0, 1.5e4, 0.03], mf_ids=[2, 1, 3], T=280.0,
         P_pa=9e4, PL_km=2.5, dvout=0.001),
    dict(mf_ppmv=[2e5], mf_ids=[7], continuum_factors=[0.5] * 7,
         continuum_override=True),
])
def test_tape5_bytes(tmp_path, kw):
    a, b = str(tmp_path / "TAPE5_jax"), str(tmp_path / "TAPE5_port")
    jax_lblrtm.write_tape5(a, 700.0, 760.0, **kw)
    lblrtm.write_tape5(b, 700.0, 760.0, **{
        k: torch.tensor(v, dtype=torch.float64) if isinstance(v, list) else v
        for k, v in kw.items()})
    assert _bytes(a) == _bytes(b)
    mf = np.zeros(len(lblrtm.HITRAN_MOLECULES))
    mf[[0, 21]] = 1.0
    np.testing.assert_array_equal(
        lblrtm.default_continuum_factors(mf),
        jax_lblrtm.default_continuum_factors(mf))
