"""The end-to-end drive of ``tools/e2e_drive.py`` through the port's public
exports, with the same NumPy hand-offs.

Synthetic lines -> ``compute_od_layers`` (the 66-layer standard
atmosphere) -> ``tud_from_od`` (four sensor altitudes) -> the products as
host NumPy arrays, which go on as NumPy into ``apparent_radiance``,
``ils_mako``, ``reduce_resolution``, ``hsi_generate``, ``write_h5`` and
``mbi_export``; ``compat.compute_OD``'s host axis goes into
``xsect_from_params``. Each step asserts the physics invariants of the JAX
drive (0 <= tau <= 1, tau falling with sensor altitude, radiances >= 0,
brightness temperatures in 150-400 K), and two error probes run last (a
negative radiance gives NaN; lines of a molecule the atmosphere lacks
raise ValueError).

Where a NumPy array meets the port without a tensor beside it, the call
is given ``device=`` (the port's rule: such a call runs on the card unless
told otherwise); the arrays stay NumPy. The HDF5 step runs where h5py is
installed and is listed in ``skipped`` elsewhere.

Run::

    python -m radtxfr_tpu_torch.tools.e2e_drive              # on the card
    python -m radtxfr_tpu_torch.tools.e2e_drive --device cpu --small
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from .. import as_numpy, as_tensor_on, brightness_temperature, planckian
from .. import compat, make_spectral_axis, resolve_device
from ..atmos import std_atmosphere
from ..io import Var, mbi_export, mbi_read, read_h5, write_h5
from ..kernels.lineparams import compute_line_params
from ..kernels.xsect import xsect_from_params
from ..lines import IsoTables, synthetic_lines
from ..products import apparent_radiance, compute_od_layers, tud_from_od
from ..scene import hsi_generate, synthetic_db
from ..sensor.ils import ils_mako
from ..sensor.resolution import reduce_resolution

#: the JAX drive's sizes: 2000 lines over 650-1450 cm^-1, 690-1410 at 0.05
FULL = dict(n_lines=2000, line_band=(650.0, 1450.0),
            band=(690.0, 1410.0, 0.05))
#: a cut band for the CPU: 200 lines, 800-820 cm^-1 at 0.05
SMALL = dict(n_lines=200, line_band=(780.0, 840.0), band=(800.0, 820.0, 0.05))

ALTITUDES = (0.061, 2.0, 10.0, 500.0)


def drive(device=None, dtype=torch.float32, n_lines=FULL["n_lines"],
          line_band=FULL["line_band"], band=FULL["band"], engine="pallas",
          seed=0) -> dict:
    """Run the drive's steps on ``device`` (None: the card) in ``dtype``;
    ``engine`` is ``compute_od_layers``'s (``'pallas'``: the kernels,
    ``'jnp'``: the reference engine). Returns the products (host NumPy
    where the JAX drive hands NumPy on): ``grid``, ``tau``, ``Lu``,
    ``Ld``, ``L``, ``Tb``, ``x_mako``, ``L_mako``, ``x_lo``, ``tau_lo``,
    ``X_c``, ``od_c``, ``k_sd``, ``hsi_L``, the probes' ``bt_bad`` and
    ``probe_error``, ``seconds`` per step and the ``skipped`` steps."""
    dev = resolve_device(device)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    secs, skipped = {}, []
    t0 = time.perf_counter()
    atm = std_atmosphere(dtype=dtype, device=dev)
    iso = IsoTables.load(dtype=dtype, device=dev)
    lines = synthetic_lines(n_lines, nu_min=line_band[0],
                            nu_max=line_band[1], seed=seed, dtype=dtype,
                            device=dev)
    grid = as_tensor_on(make_spectral_axis(*band), dev, dtype)
    od = compute_od_layers(lines, iso, grid, atm, engine=engine,
                           pallas_opts=dict(max_groups=2))
    _sync(dev)
    secs["od"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    B = planckian(grid, atm.T).transpose(0, 1).to(dtype)
    alts = as_tensor_on(np.asarray(ALTITUDES), dev, dtype)
    tud = tud_from_od(grid, od, B, atm.z0, alts, mu=1.0, n_angles=30)
    tau, Lu, Ld = as_numpy(tud.tau), as_numpy(tud.Lu), as_numpy(tud.Ld)
    secs["tud"] = time.perf_counter() - t0
    _check((tau >= 0).all() and (tau <= 1.0 + 1e-6).all(), "tau in [0, 1]")
    _check((Lu >= 0).all() and (Ld >= 0).all(), "radiances >= 0")
    _check((tau[:, 3, 0] <= tau[:, 0, 0] + 1e-6).all(),
           "tau falls with sensor altitude")

    t0 = time.perf_counter()
    n_x = grid.shape[0]
    emis = (torch.ones((n_x, 2), dtype=dtype, device=dev)
            * as_tensor_on(np.asarray([0.95, 0.7]), dev, dtype))
    L = apparent_radiance(grid, emis, as_tensor_on(np.asarray([296.0]), dev,
                                                   dtype),
                          tau[:, 3:4, 0], Lu[:, 3:4, 0], Ld[:, None])
    Tb = as_numpy(brightness_temperature(grid, L[:, 0, 0]))
    _check(150 < np.nanmin(Tb) and np.nanmax(Tb) < 400, "Tb in 150-400 K")
    x_mako, L_mako = ils_mako(as_numpy(grid, np.float64), L[:, :, 0])
    _check(x_mako.shape[0] > 0 and torch.isfinite(L_mako).all(),
           "MAKO channels finite")
    secs["radiance, Tb, MAKO"] = time.perf_counter() - t0

    # resolution reduction (compat-style pipeline step)
    t0 = time.perf_counter()
    x_lo, tau_lo = reduce_resolution(as_numpy(grid, np.float64),
                                     tau[:, 3, 0], 0.25, device=dev)
    _check(x_lo.size < n_x and torch.isfinite(tau_lo).all(),
           "reduced tau coarser and finite")
    secs["reduce_resolution"] = time.perf_counter() - t0

    # compat drop-in surface (reference-named API)
    t0 = time.perf_counter()
    X_c, od_c = compat.compute_OD(
        800.0, 805.0, lines=lines.select_band(790, 815), iso=iso,
        DVOUT=0.01, T=280.0, P=90000.0, PL=0.5,
        MF_ID=np.array([1, 2, 3]), MF_VAL=np.array([7000.0, 380.0, 0.03]))
    _check((od_c >= 0).all(), "compat OD >= 0")
    # SD-Voigt profile path: the compat call's host axis as the grid
    sd_params = compute_line_params(lines.select_band(800, 810), iso, 280.0,
                                    0.9, profile="sdvoigt")
    k_sd = xsect_from_params(np.asarray(X_c, dtype=np_dt), sd_params,
                             profile="sdvoigt")
    _check(torch.isfinite(k_sd).all(), "SD-Voigt cross-section finite")
    secs["compat, sdvoigt"] = time.perf_counter() - t0

    # scene: emissivity DB -> HSI cube on the freshly computed TUD
    t0 = time.perf_counter()
    db = synthetic_db(16, X=as_numpy(grid, np.float64), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    hsi = hsi_generate(gen, grid, tau[None, :, 3, 0], Lu[None, :, 3, 0],
                       Ld[None, :], [296.0], db.emis, n_pixels=8, n_emis=4,
                       n_mix=2, n_atm=2)
    hsi_L = as_numpy(hsi["L"])
    _check(np.isfinite(hsi_L).all() and (hsi_L > 0).all(),
           "HSI radiances finite and positive")
    secs["hsi"] = time.perf_counter() - t0

    # io: HDF5 with units metadata + MBI cube round trip
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        try:
            import h5py  # noqa: F401
        except ImportError:
            skipped.append("write_h5/read_h5 (no h5py)")
        else:
            write_h5(os.path.join(td, "t.h5"),
                     {"X": Var(as_numpy(grid), units="cm^{-1}"),
                      "tau": Var(tau)})
            _check(read_h5(os.path.join(td, "t.h5"))["X"].units
                   == "cm^{-1}", "HDF5 units read back")
        mbi_export(os.path.join(td, "c.bip"), hsi_L[0].T[None, :, :])
        _check(mbi_read(os.path.join(td, "c.bip"))[0].shape[0] == 1,
               "MBI cube read back")
    secs["io"] = time.perf_counter() - t0

    # the error probes
    bt_bad = as_numpy(brightness_temperature(np.array([1000.0]),
                                             np.array([-5.0]), device=dev))
    _check(np.isnan(bt_bad).all(), "a negative radiance gives NaN")
    bad = synthetic_lines(10, species=((9, 1),), seed=1, dtype=dtype,
                          device=dev)
    try:
        compute_od_layers(bad, iso, grid, atm)
    except ValueError as e:
        probe_error = str(e)
    else:
        _check(False, "no error for a molecule missing from the atmosphere")
    return dict(grid=as_numpy(grid), tau=tau, Lu=Lu, Ld=Ld, L=as_numpy(L),
                Tb=Tb, x_mako=x_mako, L_mako=as_numpy(L_mako), x_lo=x_lo,
                tau_lo=as_numpy(tau_lo), X_c=X_c, od_c=od_c,
                k_sd=as_numpy(k_sd), hsi_L=hsi_L, bt_bad=bt_bad,
                probe_error=probe_error, seconds=secs, skipped=skipped)


def _check(ok, what):
    """The drive's invariants: AssertionError naming the one that fails
    (raised, not asserted, so that ``python -O`` keeps them)."""
    if not ok:
        raise AssertionError(f"e2e drive: {what}")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--small", action="store_true",
                    help="the cut band (200 lines, 800-820 cm^-1)")
    ap.add_argument("--engine", default=None,
                    help="'pallas' (the kernels; default on the card) or "
                         "'jnp' (the reference engine; default elsewhere)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    engine = args.engine or ("pallas" if dev.type == "cuda" else "jnp")
    t0 = time.perf_counter()
    out = drive(dev, engine=engine, **(SMALL if args.small else FULL))
    print(f"grid {out['grid'].size} pts on {dev} ({engine}); "
          f"steps {out['seconds']}; skipped {out['skipped']}")
    print("probe ok:", out["probe_error"])
    print(f"TOTAL {time.perf_counter() - t0:.1f}s  -- END-TO-END OK")


if __name__ == "__main__":
    main()
