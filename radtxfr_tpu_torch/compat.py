"""Drop-in compatibility layer mirroring the reference's public API
(counterpart of ``radtxfr_tpu/compat.py``).

Functions carry the reference's names, argument conventions, units and
return shapes (``radiative_transfer.py``), backed by the port's engines. A
user of westi024/RadTxfr can ``import radtxfr_tpu_torch.compat as rt`` and
keep their scripts, with two deliberate differences:

* **No LBLRTM binary.** ``compute_OD``/``compute_TUD`` take a line database
  (:class:`~.lines.store.LineStore`, e.g. from ``parse_par``) via the
  ``lines=`` option; the default options dict carries none. The work runs
  on the device of ``lines`` (the card unless the store was built on the
  CPU). The ``engine`` option picks the engine: ``"jnp"`` (the default,
  the reference engine in plain PyTorch, in the store's dtype) or
  ``"pallas"`` (the CUDA kernels, float32 inside as the JAX package's
  Pallas kernels; CPU stores run their plain versions).
* **No mutable module-global options.** The reference's ``options`` dict is
  mutated by every call (``opts.update(kwargs)``,
  ``radiative_transfer.py:303,421,483,523``), so kwargs silently persist
  across calls. Here each call composes ``DEFAULT_OPTIONS`` + ``opts`` +
  ``kwargs`` functionally.

Every function returns host NumPy arrays, as the JAX module does; inputs
that are tensors are computed on their device, other arrays on ``device=``
(None: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from . import as_numpy, as_tensor_on
from .atmos.profile import AtmosphericState, std_atmosphere_raw
from .core import grid as _grid
from .core import planck as _planck
from .core.reshape import rs1d, rs2d, rsnd
from .io import lblrtm as _lblrtm_io
from .lines.store import IsoTables, LineStore
from .products.od import compute_od_layers
from .products.radiance import apparent_radiance
from .products.tud import tud_from_od
from .sensor.ils import ils_mako
from .sensor.resolution import reduce_resolution, smooth  # noqa: F401  (re-export)

__all__ = [
    "c1", "c2", "StdAtmos", "options", "DEFAULT_OPTIONS",
    "rs1D", "rs2D", "rsND", "make_spectral_axis",
    "planckian", "brightnessTemperature", "BT2L",
    "compute_OD", "compute_TUD", "compute_LWIR_apparent_radiance",
    "ILS_MAKO", "smooth", "reduceResolution", "getHelp",
    "run_LBLRTM", "write_tape5", "read_tape12",
]

c1 = 1.19104295315e-16
c2 = 1.43877736830e-02

#: The 66-layer 1976 US Standard Atmosphere table, same column layout as the
#: reference's ``StdAtmos`` (radiative_transfer.py:146).
StdAtmos = std_atmosphere_raw()

DEFAULT_OPTIONS = {
    # write_tape5-equivalents (radiative_transfer.py:152-183)
    "V1": 2000.00, "V2": 3333.33, "T": 296.0, "P": 101325.0, "PL": 1.0,
    "MF_ID": np.array([]), "MF_VAL": np.array([]),
    "DVOUT": 0.0005,
    # engine selection (replaces LBLRTM paths)
    "lines": None, "iso": None, "profile": "voigt", "engine": "jnp",
    "wing_abs": 0.0, "wing_hw": 50.0,
    # continuum model: 'none' = hapi parity; 'mt_ckd' mirrors the
    # reference's LBLRTM ICNTNM=6 production setting
    # (radiative_transfer.py:622); factors follow TAPE5 record 1.2a.
    "continuum": "none", "continuum_factors": None,
    # compute_TUD options
    "Zs": StdAtmos[:, 1], "Ts": StdAtmos[:, 5], "Ps": StdAtmos[:, 4],
    "PLs": StdAtmos[:, 3],
    "MFs_VAL": StdAtmos[:, 6:14] * 1e6,  # [ppmv]
    "MFs_ID": np.array([1, 2, 3, 4, 5, 6, 7, 22]),
    "theta_r": 0.0, "N_angle": 30, "Altitudes": np.asarray([500]),
    "returnOD": False,
}

#: Reference-style alias. NOT mutated by calls (see module docstring).
options = DEFAULT_OPTIONS


def _merge_opts(opts, kwargs):
    """The reference's options composition (defaults <- opts <- kwargs),
    without its global-dict mutation (``radiative_transfer.py:303`` etc.)."""
    o = dict(DEFAULT_OPTIONS)
    if opts is not None:
        o.update(opts)
    o.update(kwargs)
    return o


def _opts(opts, kwargs):
    """The merged options with the line database on its device in the
    engine's dtype ('pallas': float32, the kernels'; else the store's) and
    the isotopologue tables beside it."""
    o = _merge_opts(opts, kwargs)
    lines = o["lines"]
    if lines is None:
        raise ValueError(
            "compat.compute_OD/compute_TUD need a line database: pass "
            "lines=<LineStore> (e.g. radtxfr_tpu_torch.lines.parse_par(...)); "
            "the reference used the LBLRTM binary + TAPE3 here"
        )
    dt = torch.float32 if o["engine"] == "pallas" else lines.sw.dtype
    if lines.sw.dtype != dt:
        lines = LineStore.from_numpy(**lines.host, device=lines.sw.device,
                                     dtype=dt)
    o["lines"] = lines
    iso = o["iso"]
    if iso is None:
        iso = IsoTables.load(device=lines.sw.device, dtype=dt)
    elif iso.q.dtype != dt or iso.q.device != lines.sw.device:
        iso = IsoTables.from_numpy(
            *(as_numpy(getattr(iso, f)) for f in
              ("q", "abundance", "molar_mass", "mol", "iso")),
            device=lines.sw.device, dtype=dt)
    o["iso"] = iso
    return o


def rs1D(y, device=None):
    a, dims = rs1d(y, device)
    return as_numpy(a), dims


def rs2D(y, device=None):
    a, dims = rs2d(y, device)
    return as_numpy(a), dims


def rsND(y, dims, device=None):
    return as_numpy(rsnd(y, dims, device))


def make_spectral_axis(Xmin, Xmax, DVOUT):
    return _grid.make_spectral_axis(Xmin, Xmax, DVOUT)


def _wavelength_mode(X, wavelength):
    # the reference's mean(X) < 50 heuristic (radiative_transfer.py:836)
    return wavelength or (float(np.mean(as_numpy(X))) < 50.0)


def planckian(X, T, wavelength=False, device=None):
    return as_numpy(_planck.planckian(
        X, T, wavelength=_wavelength_mode(X, wavelength), device=device))


def _spectral_first(a, spectral_dim):
    """``a`` (a tensor stays one) with ``spectral_dim`` moved to axis 0."""
    if spectral_dim == 0:
        return a
    if isinstance(a, torch.Tensor):
        return a.swapaxes(0, spectral_dim)
    return np.swapaxes(np.asarray(a), 0, spectral_dim)


def brightnessTemperature(X, L, wavelength=False, bad_value=np.nan,
                          spectral_dim=0, device=None):
    T = as_numpy(_planck.brightness_temperature(
        X, _spectral_first(L, spectral_dim),
        wavelength=_wavelength_mode(X, wavelength), bad_value=bad_value,
        device=device))
    return _spectral_first(T, spectral_dim)


def BT2L(X, T, wavelength=False, bad_value=np.nan, spectral_dim=0,
         device=None):
    L = as_numpy(_planck.bt2l(
        X, _spectral_first(T, spectral_dim),
        wavelength=_wavelength_mode(X, wavelength), bad_value=bad_value,
        device=device))
    return _spectral_first(L, spectral_dim)


def _atmos_from_opts(o) -> AtmosphericState:
    """The layered state of the TUD options on the store's device in its
    dtype."""
    mf = as_numpy(o["MFs_VAL"], np.float64) * 1e-6  # ppmv -> fraction
    z0 = as_numpy(o["Zs"], np.float64)
    return AtmosphericState.from_numpy(
        z0=z0, z1=z0,  # layer tops not used by the engine
        pl=o["PLs"], p=o["Ps"], T=o["Ts"], vmr=mf,
        mol_ids=tuple(int(m) for m in as_numpy(o["MFs_ID"]).ravel()),
        device=o["lines"].sw.device, dtype=o["lines"].sw.dtype)


def _od(o, X, atmos) -> torch.Tensor:
    return compute_od_layers(
        o["lines"], o["iso"], X, atmos, profile=o["profile"],
        wing_abs=o["wing_abs"], wing_hw=o["wing_hw"], engine=o["engine"],
        continuum=o["continuum"], continuum_factors=o["continuum_factors"])


def compute_OD(Xmin, Xmax, opts=None, **kwargs):
    """Single-layer monochromatic OD, reference signature
    (``radiative_transfer.py:395-456``), on the device of ``lines``.

    Layer state comes from T [K], P [Pa], PL [km] and MF_ID/MF_VAL [ppmv]
    options. No 2020 cm^-1 band chunking is needed — the engine evaluates
    any band in one pass.
    """
    o = _opts(opts, kwargs)
    X = make_spectral_axis(Xmin, Xmax, o["DVOUT"])
    mf_ids = tuple(int(m) for m in as_numpy(o["MF_ID"]).ravel())
    mf_val = as_numpy(o["MF_VAL"], np.float64).ravel() * 1e-6
    atmos = AtmosphericState.from_numpy(
        z0=[0.0], z1=[0.0], pl=[float(o["PL"])], p=[float(o["P"])],
        T=[float(o["T"])], vmr=mf_val[None, :], mol_ids=mf_ids,
        device=o["lines"].sw.device, dtype=o["lines"].sw.dtype)
    return X, as_numpy(_od(o, X, atmos)[0])


def compute_TUD(Xmin, Xmax, opts=None, **kwargs):
    """Monochromatic TUD, reference signature and return convention
    (``radiative_transfer.py:274-392``), on the device of ``lines``:
    returns (X, tau, Lu, Ld) with singleton altitude/angle axes squeezed.
    """
    o = _opts(opts, kwargs)
    X = make_spectral_axis(Xmin, Xmax, o["DVOUT"])
    atmos = _atmos_from_opts(o)
    od = _od(o, X, atmos)
    Xt = torch.as_tensor(X, dtype=od.dtype, device=od.device)
    # the source in float64, then in the OD's dtype (the JAX module's)
    B = _planck.planckian(torch.as_tensor(X, device=od.device),
                          atmos.T.double()).transpose(0, 1).to(od.dtype)
    mu = 1.0 / np.cos(float(o["theta_r"]))
    tud = tud_from_od(
        Xt, od, B, atmos.z0,
        torch.as_tensor(np.atleast_1d(o["Altitudes"]), dtype=od.dtype,
                        device=od.device),
        mu=mu, n_angles=int(o["N_angle"]), return_od=bool(o["returnOD"]),
    ).squeezed()
    return X, as_numpy(tud.tau), as_numpy(tud.Lu), as_numpy(tud.Ld)


def compute_LWIR_apparent_radiance(X, emis, Ts, tau, La, Ld, dT=None,
                                   return_Ls=False, device=None):
    out = apparent_radiance(X, emis, Ts, tau, La, Ld, dT=dT,
                            return_Ls=return_Ls, device=device)
    if return_Ls:
        return as_numpy(out[0]), as_numpy(out[1])
    return as_numpy(out)


def ILS_MAKO(X, Y, resFactor=None, returnX=True, fwhm_sf=1.0, shift=0.0,
             scale=1.0, device=None):
    out = ils_mako(X, Y, res_factor=resFactor, return_x=returnX,
                   fwhm_sf=fwhm_sf, shift=shift, scale=scale,
                   device=Y.device if isinstance(Y, torch.Tensor) else device)
    if returnX:
        return out[0], as_numpy(out[1])
    return as_numpy(out)


def reduceResolution(X, Y, dX, N=4, window="hanning", X_out=None,
                     device=None):
    Y = as_tensor_on(Y if isinstance(Y, torch.Tensor) else np.asarray(Y),
                     None if isinstance(Y, torch.Tensor) else device)
    out = reduce_resolution(X, Y, dX, N=N, window=window, X_out=X_out)
    if X_out is None:
        return out[0], as_numpy(out[1])
    return as_numpy(out)


def getHelp(target=None):
    """hapi-style interactive help (``misc/hapi.py:4987``): no argument
    prints the API index; a name or object prints its documentation."""
    from .utils.help import get_help
    get_help(target)


def write_tape5(fname="TAPE5", opts=None, **kwargs):
    """Reference-signature TAPE5 writer (``radiative_transfer.py:504-727``):
    writes the single-layer OD-mode LBLRTM punch-card deck described by the
    V1/V2/T/P/PL/MF_ID/MF_VAL/DVOUT options. Interop only — the engine never
    consumes it."""
    o = _merge_opts(opts, kwargs)
    _lblrtm_io.write_tape5(
        fname, float(o["V1"]), float(o["V2"]), T=float(o["T"]),
        P_pa=float(o["P"]), PL_km=float(o["PL"]),
        mf_ppmv=as_numpy(o["MF_VAL"], np.float64).ravel(),
        mf_ids=as_numpy(o["MF_ID"]).ravel(), dvout=float(o["DVOUT"]),
        continuum_factors=o.get("continuum_factors"),
        continuum_override=bool(o.get("continuum_override", False)),
    )


def read_tape12(fname="TAPE12"):
    """Reference-signature TAPE12 reader (``radiative_transfer.py:730-789``):
    returns flat (nu, od) concatenated over the file's panels."""
    return _lblrtm_io.read_tape12(fname)


def run_LBLRTM(V1, V2, opts=None, **kwargs):
    """Reference-signature single-layer OD run (``radiative_transfer.py:459-501``),
    with the port's engine in place of the LBLRTM subprocess: no TAPE3
    symlink, no temporary directory, no Fortran binary — the same options
    produce (nu, od) directly from the line database. Requires ``lines=``
    exactly like :func:`compute_OD`."""
    nu, od = compute_OD(V1, V2, opts=opts, **kwargs)
    return nu, od
