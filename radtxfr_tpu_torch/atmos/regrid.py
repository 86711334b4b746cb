"""Sounding/ensemble ingestion: regrid measured profiles onto a layer grid
(counterpart of ``radtxfr_tpu/atmos/regrid.py``).

The reference's TIGR data path (``Generate_LWIR_TUD.py:16-49``): load a
``.mat`` ensemble (P [hPa], T [K], H2O [ppmv], O3 [fraction], z [km]),
cubic-interpolate each profile's T/H2O/O3 onto the 66-level 1976 US
Standard Atmosphere altitude grid, and assemble a batched
:class:`~.profile.AtmosphericState`. Also the finite-difference Jacobian
inputs (``JacIn`` and the 3·nL+1 tiling, ``Generate_LWIR_TUD.py:55-71``),
for parity with the reference's workflow (:mod:`..products.jacobian` is the
forward-mode replacement).

Host NumPy and SciPy: regridding is one-time data ingestion; only the
assembled state goes to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import as_numpy
from .profile import AtmosphericState, std_atmosphere

__all__ = ["load_tigr_mat", "regrid_profiles", "jacobian_inputs"]


def load_tigr_mat(path: str) -> dict:
    """Load a TIGR-style ``.mat`` ensemble with the reference's unit
    conversions (``Generate_LWIR_TUD.py:34-38``): P hPa -> Pa, H2O ppmv ->
    mixing fraction; T [K], O3 [fraction], z [km] pass through. Returns
    NumPy ``P`` (raveled), ``T``/``H2O``/``O3``/``z`` (nAtm, nz)."""
    from scipy.io import loadmat

    m = loadmat(path)
    return {
        "P": np.asarray(m["P"]).ravel() * 100.0,
        "T": np.atleast_2d(np.asarray(m["T"], dtype=np.float64)),
        "H2O": np.atleast_2d(np.asarray(m["H2O"], dtype=np.float64)) / 1e6,
        "O3": np.atleast_2d(np.asarray(m["O3"], dtype=np.float64)),
        "z": np.atleast_2d(np.asarray(m["z"], dtype=np.float64)),
    }


def _interp_cubic(x_src, y_src, x_out):
    """Global cubic interpolation, the semantics of the reference's
    ``scipy.interpolate.interp1d(kind='cubic')`` (``Generate_LWIR_TUD.py:45``),
    extrapolated."""
    from scipy.interpolate import interp1d

    return interp1d(x_src, y_src, kind="cubic", bounds_error=False,
                    fill_value="extrapolate")(x_out)


def regrid_profiles(z_src, T=None, h2o=None, o3=None, base=None,
                    dtype=torch.float32, device=None) -> AtmosphericState:
    """Cubic-regrid ensemble profiles onto ``base``'s altitude levels and
    return a batched :class:`AtmosphericState` (leading axis = member).

    ``z_src`` (nz,) or (nAtm, nz) source altitudes [km], ascending; ``T``,
    ``h2o``, ``o3`` optional (nAtm, nz) temperature [K] and volume mixing
    fractions. Omitted quantities keep ``base``'s values, as the reference
    regrids only T/H2O/O3 and keeps the StdAtmos pressure and other species
    (``Generate_LWIR_TUD.py:42-49``). ``base`` defaults to the 66-level
    StdAtmos; the state is built on ``device`` (None: ``base``'s, or the
    card) in ``dtype``.
    """
    if base is None:
        base = std_atmosphere(device=device, dtype=dtype)
    device = base.T.device if device is None else torch.device(device)
    host = lambda a: a.detach().cpu().numpy().astype(np.float64)  # noqa
    z_out = host(base.z0)
    given = [a for a in (T, h2o, o3) if a is not None]
    if not given:
        raise ValueError("provide at least one of T, h2o, o3")
    n_atm = np.atleast_2d(as_numpy(given[0])).shape[0]
    z_src = as_numpy(z_src, np.float64)
    if z_src.ndim == 1:
        z_src = np.broadcast_to(z_src, (n_atm, z_src.size))

    def regrid(a):
        if a is None:
            return None
        a = np.atleast_2d(as_numpy(a, np.float64))
        return np.stack([_interp_cubic(z_src[i], a[i], z_out)
                         for i in range(n_atm)])

    T_g, h2o_g, o3_g = regrid(T), regrid(h2o), regrid(o3)
    rep = lambda a: np.broadcast_to(a, (n_atm,) + a.shape)  # noqa: E731
    vmr = np.array(rep(host(base.vmr)))
    mol_col = {m: i for i, m in enumerate(base.mol_ids)}
    if h2o_g is not None:
        vmr[:, :, mol_col[1]] = h2o_g
    if o3_g is not None:
        vmr[:, :, mol_col[3]] = o3_g
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype,  # noqa: E731
                                  device=device)
    return base.replace(
        z0=t(rep(host(base.z0))), z1=t(rep(host(base.z1))),
        pl=t(rep(host(base.pl))), p=t(rep(host(base.p))),
        T=t(T_g if T_g is not None else rep(host(base.T))), vmr=t(vmr))


def jacobian_inputs(T_mean, h2o_mean, o3_mean, rel_step: float = 1e-3):
    """The reference's finite-difference Jacobian ensemble: 3·nL+1 profiles,
    row 0 unperturbed, then per-level perturbations of T, H2O and O3 in
    turn with step ``rel_step * max|x|`` (``JacIn``,
    ``Generate_LWIR_TUD.py:55-71``). Returns NumPy (T, h2o, o3), each
    (3·nL+1, nL)."""
    prof = [as_numpy(a, np.float64) for a in (T_mean, h2o_mean, o3_mean)]
    nL = prof[0].size
    out = [np.tile(a, (3 * nL + 1, 1)) for a in prof]
    for q in range(3):
        step = rel_step * np.max(np.abs(prof[q]))
        rows = 1 + q * nL + np.arange(nL)
        out[q][rows, np.arange(nL)] += step
    return tuple(out)
