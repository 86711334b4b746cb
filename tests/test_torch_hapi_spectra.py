"""The port's spectra and slit convolutions
(``radtxfr_tpu_torch/kernels/spectra.py`` and their ``hapi_compat``
wrappers) against ``radtxfr_tpu``'s on the CPU, float64.

* The seven hapi slits are the same NumPy functions.
* The three spectra, ``convolve_spectrum`` with each slit at an odd and an
  even slit length (``arange_drift_free(-w, w + step, step)`` gives either
  parity), and ``convolveSpectrum``/``Same``/``Full``, all within 1e-12 of
  the JAX result's peak.
* ``step >= resolution`` raises ``ValueError`` on both sides.
"""

import numpy as np
import pytest
import torch

from radtxfr_tpu import hapi_compat as jhc
from radtxfr_tpu.kernels import spectra as jspec

from radtxfr_tpu_torch import hapi_compat as hc
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.kernels import spectra
from port_fixtures import one_torch_thread  # noqa: F401

BOUND = 1e-12
STEP = 0.005
OMEGA = np.arange(4001) * STEP + 800.0
SLITS = sorted(spectra.HAPI_SLITS)
#: half-widths whose drift-free slit axes have an even (802) and an odd
#: (803) number of points
WINGS = {"even": 2.0, "odd": 2.0025}


def _spectrum():
    rng = np.random.default_rng(5)
    centres = rng.uniform(802.0, 818.0, 12)
    k = sum(rng.uniform(0.2, 2.0) / (1.0 + ((OMEGA - c) / 0.05) ** 2)
            for c in centres) * 1e-2
    return k + 1e-4 * np.sin(OMEGA)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def test_wing_parities():
    for parity, w in WINGS.items():
        n = arange_drift_free(-w, w + STEP, STEP).size
        assert n % 2 == (parity == "odd"), (parity, n)


@pytest.mark.parametrize("slit", SLITS)
def test_slit_functions_equal_jax(slit):
    x = arange_drift_free(-2.0, 2.0 + STEP, STEP)
    np.testing.assert_array_equal(spectra.HAPI_SLITS[slit](x, 0.4),
                                  jspec.HAPI_SLITS[slit](x, 0.4))


@pytest.mark.parametrize("name", ["transmittance_spectrum",
                                  "absorption_spectrum",
                                  "radiance_spectrum"])
def test_spectra_match_jax(name):
    k = _spectrum()
    got = getattr(spectra, name)(torch.as_tensor(OMEGA), torch.as_tensor(k),
                                 path_cm=50.0)
    want = getattr(jspec, name)(OMEGA, k, path_cm=50.0)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert _rel(got, want) <= BOUND


@pytest.mark.parametrize("parity", sorted(WINGS))
@pytest.mark.parametrize("slit", SLITS)
def test_convolve_spectrum_matches_jax(slit, parity):
    y = _spectrum()
    kw = dict(resolution=0.4, af_wing=WINGS[parity], slit=slit)
    om, yc, i1, i2, w = spectra.convolve_spectrum(
        torch.as_tensor(OMEGA), torch.as_tensor(y), **kw)
    om_j, yc_j, i1_j, i2_j, w_j = jspec.convolve_spectrum(OMEGA, y, **kw)
    assert (i1, i2) == (i1_j, i2_j)
    np.testing.assert_array_equal(om, om_j)
    np.testing.assert_array_equal(w, w_j)
    assert _rel(yc, yc_j) <= BOUND


def test_hapi_spectra_wrappers_match_jax():
    k = _spectrum()
    for name, env in (("transmittanceSpectrum", {"l": 50.0}),
                      ("absorptionSpectrum", {"l": 50.0}),
                      ("radianceSpectrum", {"l": 50.0, "T": 300.0})):
        nu, s = getattr(hc, name)(torch.as_tensor(OMEGA), torch.as_tensor(k),
                                  Environment=env)
        nu_j, s_j = getattr(jhc, name)(OMEGA, k, Environment=env)
        assert isinstance(s, np.ndarray)
        np.testing.assert_array_equal(nu, nu_j)
        assert _rel(s, s_j) <= BOUND, name


@pytest.mark.parametrize("parity", sorted(WINGS))
def test_convolve_spectrum_wrappers_match_jax(parity):
    y = _spectrum()
    kw = dict(Resolution=0.4, AF_wing=WINGS[parity])
    got = hc.convolveSpectrum(OMEGA, torch.as_tensor(y),
                              SlitFunction=hc.SLIT_GAUSSIAN, **kw)
    want = jhc.convolveSpectrum(OMEGA, y, SlitFunction=jhc.SLIT_GAUSSIAN,
                                **kw)
    assert got[2:4] == want[2:4] and isinstance(got[1], np.ndarray)
    assert _rel(got[1], want[1]) <= BOUND
    for fn, jfn in ((hc.convolveSpectrumSame, jhc.convolveSpectrumSame),
                    (hc.convolveSpectrumFull, jhc.convolveSpectrumFull)):
        om, yc, i1, i2, w = fn(OMEGA, torch.as_tensor(y),
                               SlitFunction=hc.SLIT_TRIANGULAR, **kw)
        om_j, yc_j, i1_j, i2_j, w_j = jfn(OMEGA, y,
                                          SlitFunction=jhc.SLIT_TRIANGULAR,
                                          **kw)
        assert (i1, i2) == (i1_j, i2_j)
        np.testing.assert_array_equal(w, w_j)
        assert _rel(yc, yc_j) <= BOUND, fn.__name__


@pytest.mark.parametrize("omega,resolution", [
    (OMEGA, 0.004),                       # step above the resolution
    (np.arange(64) * 0.5 + 800.0, 0.5),   # step equal to it, exactly
])
def test_step_not_below_resolution_raises(omega, resolution):
    y = np.ones(omega.size)
    with pytest.raises(ValueError, match="step must be less"):
        spectra.convolve_spectrum(omega, torch.as_tensor(y),
                                  resolution=resolution)
    with pytest.raises(ValueError, match="step must be less"):
        jspec.convolve_spectrum(omega, y, resolution=resolution)
