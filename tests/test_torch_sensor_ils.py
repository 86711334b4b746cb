"""The port's instrument line shapes (``radtxfr_tpu_torch/sensor/ils.py``)
against radtxfr_tpu's: the MAKO channel axis, every slit shape's weight
matrix, the dense ILS product and the MAKO convolutions, in float64 on the
CPU, on NumPy-seeded spectra. The weight matrices are host float64 in both
packages (the same operations: equal to 1e-15); the products within 1e-12
relative of the peak.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.sensor import ils as j_ils
from radtxfr_tpu_torch.sensor import ils
from port_fixtures import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_mako_axis_matches_jax():
    """The packaged 128 channels and the in-band wavenumber axis, with and
    without a resolution factor, equal JAX's."""
    np.testing.assert_array_equal(ils.mako_wavelengths_um(),
                                  j_ils.mako_wavelengths_um())
    assert ils.mako_wavelengths_um().shape == (128,)
    X = np.linspace(700.0, 1400.0, 3000)
    for rf in (None, 2, 0.5):
        np.testing.assert_array_equal(ils.mako_axis_wn(X, rf),
                                      j_ils.mako_axis_wn(X, rf))


@pytest.mark.parametrize("shape", sorted(j_ils.SLIT_SHAPES))
def test_ils_matrix_matches_jax(shape):
    """Each hapi slit shape's normalized (and raw) weight matrix, with the
    spectral calibration (scale, shift), within 1e-15 of JAX's (the
    Michelson slit against JAX's slit function a channel at a time)."""
    assert sorted(ils.SLIT_SHAPES) == sorted(j_ils.SLIT_SHAPES)
    X = np.linspace(800.0, 900.0, 2001)
    centers = np.array([812.3, 850.0, 851.7, 888.8])
    widths = np.array([0.8, 1.5, 2.0, 3.0])
    for kw in (dict(), dict(shift=0.3, scale=1.001),
               dict(normalize=False)):
        got = ils.ils_matrix(X, centers, widths, shape=shape, **kw)
        if shape == "michelson":
            # JAX's ils_matrix cannot take its Michelson slit (the masked
            # assignment of a (1, n_chan) width raises): JAX's slit
            # function column by column, normalized as ils_matrix does
            d = X[:, None] - (kw.get("scale", 1.0) * centers[None, :]
                              + kw.get("shift", 0.0))
            want = np.stack([j_ils.SLIT_SHAPES[shape](d[:, i].copy(), w)
                             for i, w in enumerate(widths)], axis=1)
            if kw.get("normalize", True):
                want = want / want.sum(axis=0)
        else:
            want = j_ils.ils_matrix(X, centers, widths, shape=shape, **kw)
        assert got.shape == want.shape == (X.size, centers.size)
        assert got.dtype == np.float64
        assert _rel(got, want) <= 1e-15


def test_apply_ils_matches_jax():
    """The dense product W^T Y, one spectrum and a batch, float64 within
    1e-12; float32 spectra stay float32; on the spectra's device."""
    rng = np.random.default_rng(11)
    W = ils.ils_matrix(np.linspace(800, 900, 501), [820.0, 860.0, 880.0],
                       2.0)
    for Y in (rng.random(501), rng.random((501, 7))):
        got = ils.apply_ils(W, torch.as_tensor(Y))
        want = j_ils.apply_ils(W, jnp.asarray(Y))
        assert got.shape == want.shape and got.dtype == torch.float64
        assert _rel(got.numpy(), want) <= 1e-12
    y32 = ils.apply_ils(W, torch.as_tensor(rng.random((501, 2)),
                                           dtype=torch.float32))
    assert y32.dtype == torch.float32 and y32.device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(), dict(fwhm_sf=1.5, shift=0.2,
                                             scale=0.9995),
                                dict(shape="gaussian"), dict(res_factor=2)],
                         ids=["default", "calibrated", "gaussian", "res2"])
def test_ils_mako_matches_jax(kw):
    """``ils_mako`` on a (nX, nS) float64 batch over 740-1340 cm^-1: the
    same channels, the outputs within 1e-12 relative."""
    rng = np.random.default_rng(3)
    X = np.arange(740.0, 1340.0, 0.25)
    Y = 1.0 + 0.1 * rng.standard_normal((X.size, 5))
    x, y = ils.ils_mako(X, torch.as_tensor(Y), **kw)
    jx, jy = j_ils.ils_mako(X, jnp.asarray(Y), **kw)
    np.testing.assert_array_equal(x, jx)
    assert y.shape == (x.size, 5)
    assert _rel(y.numpy(), jy) <= 1e-12
    only = ils.ils_mako(X, torch.as_tensor(Y[:, 0]), return_x=False, **kw)
    assert _rel(only.numpy(), np.asarray(jy)[:, 0]) <= 1e-12


def test_ils_mako_simple_matches_jax():
    """The standalone Gaussian variant: all 128 channels, no trim."""
    X = np.arange(700.0, 1400.0, 0.5)
    Y = np.random.default_rng(2).random((X.size, 3))
    x, y = ils.ils_mako_simple(X, torch.as_tensor(Y))
    jx, jy = j_ils.ils_mako_simple(X, jnp.asarray(Y))
    np.testing.assert_array_equal(x, jx)
    assert x.size == 128
    assert _rel(y.numpy(), jy) <= 1e-12


def test_ils_mako_refusals():
    """A band with under two MAKO channels raises ``ValueError`` as JAX's;
    NumPy spectra without a device go to the card, so they raise where
    there is none (no CPU fallback)."""
    X = np.arange(700.0, 750.0, 0.5)
    with pytest.raises(ValueError, match="MAKO channel"):
        ils.ils_mako(X, torch.ones(X.size, dtype=torch.float64))
    X = np.arange(800.0, 900.0, 0.5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ils.ils_mako(X, np.ones(X.size))
    x, y = ils.ils_mako(X, np.ones(X.size), **CPU)
    assert y.device.type == "cpu"
    np.testing.assert_allclose(y.numpy(), 1.0, rtol=1e-14)
