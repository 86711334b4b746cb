"""Command-line entry point of the port (counterpart of
``radtxfr_tpu/cli/main.py``; the ``tud`` command, single device).

    python -m radtxfr_tpu_torch.cli.main tud --derived --line-mixing \\
        --continuum mt_ckd --numin 690 --numax 1410 --dv 0.0005 \\
        --n-atmos N --batch B [--jacobian [--jacobian-wrt T,1,3]] \\
        [--device cuda] [--output tud.h5]

``tud`` is configuration 3 of the reference (``Generate_LWIR_TUD.py``):
66-layer multi-altitude transmittance / upwelling / downwelling over the
LWIR band for an ensemble of perturbed standard atmospheres, reduced on the
device to ``--dv-out``, written to HDF5. Members are processed in chunks of
``--batch``; each chunk's reduced products are copied to the host once.
``--jacobian`` adds d(tau, Lu, Ld)/d(T, H2O, O3) of the standard
atmosphere by forward-mode autodiff (the reference's 199-profile finite
differences), 8 directions at a time, each batch reduced on the device as
soon as it exists.

Not ported yet (each raises ``NotImplementedError``): ``--par`` (parse_par
and the native parser, ROADMAP M9), ``--synthetic`` (M2), ``--checkpoint``
(M9) and ``--mesh-*`` (M15, with the sharded Jacobian).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _load_lines(args, device, margin=25.0):
    from ..lines.derived import derived_lwir_linelist

    if args.par:
        raise NotImplementedError(
            "--par: parse_par and the native .par parser are ROADMAP M9")
    if not args.derived:
        raise NotImplementedError(
            "--synthetic line lists (lines/synthetic.py) are ROADMAP M2; "
            "pass --derived")
    return derived_lwir_linelist(args.numin - margin, args.numax + margin,
                                 device=device, dtype=torch.float32)


def run_tud(args, device, timings: dict | None = None):
    """The ``tud`` production path on ``device``.

    Returns ``(x_lo, {"tau", "Lu", "Ld"})``: the reduced axis (n_out,) and
    NumPy products tau/Lu (n_atmos, n_out, nZs), Ld (n_atmos, n_out); with
    ``--jacobian`` also ``d{tau,Lu}_d{T,H2O,O3}`` (n_out, nZs, nLay) and
    ``dLd_d*`` (n_out, nLay), the JAX CLI's keys. ``timings``, when given,
    receives ``build_s`` (lines, plans, operators), ``members_s`` (all
    members, products on the host), ``chunk_s`` (the seconds of each
    ``--batch`` chunk) and, with ``--jacobian``, ``jacobian_s``.
    """
    from ..atmos.profile import std_atmosphere
    from ..core.grid import arange_drift_free
    from ..kernels.linemixing_data import y_air_for_store
    from ..lines.store import IsoTables
    from ..products.od import make_od_fn
    from ..products.tud import make_tud_fn
    from ..sensor.resolution import reduce_operator

    if args.checkpoint:
        raise NotImplementedError(
            "--checkpoint: resumable ensemble checkpoints (dist/checkpoint.py)"
            " are ROADMAP M9")
    if args.mesh_spectrum * args.mesh_ensemble > 1:
        raise NotImplementedError("--mesh-*: multi-GPU runs are ROADMAP M15")
    if args.batch < 1 or args.n_atmos < 1:
        raise ValueError("--batch and --n-atmos must be positive")
    device = torch.device(device)
    f32 = torch.float32

    t0 = time.perf_counter()
    store = _load_lines(args, device)
    iso = IsoTables.load(device=device, dtype=f32)
    base = std_atmosphere(device=device, dtype=f32)
    X = arange_drift_free(args.numin, args.numax, args.dv)
    grid = torch.as_tensor(X, dtype=f32, device=device)

    # the JAX CLI's ensemble draws, member for member
    rng = np.random.default_rng(args.seed)
    dT = rng.normal(0.0, 5.0, (args.n_atmos, 1)).astype(np.float32)
    scale_h2o = rng.uniform(0.5, 1.5, args.n_atmos).astype(np.float32)

    line_mixing = None
    if args.line_mixing:
        y = y_air_for_store(store.host_view())
        n_mix = int((y != 0.0).sum())
        line_mixing = {"y_air": y} if n_mix else None
        print(f"line mixing: derived Rosenkranz y_air on {n_mix} CO2 "
              f"branch lines (Sum S*Y = 0 enforced by construction)")
    od_fn = make_od_fn(store, iso, X, base, continuum=args.continuum,
                       line_mixing=line_mixing)
    tud_fn = make_tud_fn(base.z0.cpu().numpy(), args.altitudes,
                         n_angles=args.n_angles, device=device)
    try:
        op = reduce_operator(X, args.dv_out, device=device)
    except ValueError as e:
        raise NotImplementedError(
            f"{e}; the unfused reduce_resolution path is not ported yet "
            "(ROADMAP M8)") from e
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0

    def member(i):
        T = base.T + torch.as_tensor(dT[i], device=device)
        vmr = base.vmr.clone()
        vmr[:, 0] *= float(scale_h2o[i])
        return T, vmr

    t1 = time.perf_counter()
    parts = {"tau": [], "Lu": [], "Ld": []}
    chunk_s = []
    for lo in range(0, args.n_atmos, args.batch):
        tc = time.perf_counter()
        chunk = {"tau": [], "Lu": [], "Ld": []}
        for i in range(lo, min(lo + args.batch, args.n_atmos)):
            T, vmr = member(i)
            od = od_fn(T, base.p, base.pl, vmr)
            tud = tud_fn(grid, od, T)
            # all sensor altitudes, as the reference stores them
            # (Generate_LWIR_TUD.py:96-132)
            chunk["tau"].append(op(tud.tau[:, :, 0]))
            chunk["Lu"].append(op(tud.Lu[:, :, 0]))
            chunk["Ld"].append(op(tud.Ld))
        for k, v in chunk.items():
            parts[k].append(torch.stack(v).cpu().numpy())
        chunk_s.append(time.perf_counter() - tc)
    out = {k: np.concatenate(v) for k, v in parts.items()}
    if timings is not None:
        timings.update(build_s=build_s, members_s=time.perf_counter() - t1,
                       chunk_s=chunk_s)
    if args.jacobian:
        t2 = time.perf_counter()
        out.update(_jacobian(args, store, iso, grid, base, op, line_mixing,
                             device))
        if timings is not None:
            timings["jacobian_s"] = time.perf_counter() - t2
    return op.x_out, out


def _jacobian(args, store, iso, grid, base, op, line_mixing, device):
    """The ``--jacobian`` products of the standard atmosphere, reduced like
    tau/Lu/Ld (the singleton mu axis dropped), as NumPy arrays under the
    JAX CLI's keys."""
    from ..products.jacobian import tud_with_jacobian

    wrt = tuple(w if w == "T" else int(w)
                for w in args.jacobian_wrt.split(","))
    if line_mixing is not None:
        print("jacobian: line-mixing tangents are not supported by the "
              "differentiable kernels; the Jacobian runs without mixing")
    alts = torch.as_tensor(args.altitudes, dtype=torch.float32,
                           device=device)
    _, jac = tud_with_jacobian(store, iso, grid, base, alts, wrt=wrt,
                               n_angles=args.n_angles, tangent_batch=8,
                               continuum=args.continuum, reduce=op)
    names = {"T": "T", 1: "H2O", 3: "O3"}
    out = {}
    for key in wrt:
        for prod in ("tau", "Lu", "Ld"):
            a = jac[str(key)][prod]
            a = a[:, :, 0] if a.dim() == 4 else a
            out[f"d{prod}_d{names.get(key, str(key))}"] = a.cpu().numpy()
    print(f"jacobian: {sum(v.size for v in out.values())} elements")
    return out


def _write_tud_h5(path, x_lo, out, altitudes):
    from ..io.h5 import Var, write_h5

    info = "(atmos, X, altitude)"
    jac = {k: Var(v, info="TUD Jacobian (trailing axis = layer)")
           for k, v in out.items() if k.startswith("d")}
    write_h5(path, {
        "X": Var(np.asarray(x_lo), units="cm^{-1}", name="Wavenumbers",
                 label=r"$\tilde{\nu}$"),
        "tau": Var(out["tau"], units="none", name="Transmittance", info=info),
        "La": Var(out["Lu"], units="µW/(cm^2 sr cm^{-1})",
                  name="Upwelling (path) radiance", info=info),
        "Ld": Var(out["Ld"], units="µW/(cm^2 sr cm^{-1})",
                  name="Hemispherically averaged downwelling radiance"),
        "Altitudes": Var(np.asarray(altitudes), units="km",
                         name="Sensor altitudes"),
        **jac,
    })
    print(f"wrote {path}")


def cmd_tud(args):
    timings = {}
    x_lo, out = run_tud(args, args.device, timings)
    n = args.n_atmos
    print(f"tud [{args.device}]: {n} members x {x_lo.size} reduced points; "
          f"build {timings['build_s']:.3f} s, members "
          f"{timings['members_s']:.3f} s ({n / timings['members_s']:.3f} "
          f"spectra/s)" + (f"; jacobian {timings['jacobian_s']:.3f} s"
                           if args.jacobian else ""))
    if args.output:
        _write_tud_h5(args.output, x_lo, out, args.altitudes)


def build_parser():
    p = argparse.ArgumentParser(
        prog="radtxfr_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    p3 = sub.add_parser("tud", help="config 3: ensemble TUD production")
    p3.add_argument("--par", help="HITRAN .par line database (not ported)")
    p3.add_argument("--synthetic", type=int, default=0,
                    help="synthetic line list (not ported)")
    p3.add_argument("--derived", action="store_true",
                    help="use the physics-derived H2O+CO2+O3+N2O+CH4 LWIR "
                         "list (lines/derived.py)")
    p3.add_argument("--seed", type=int, default=0)
    p3.add_argument("--numin", type=float, default=690.0)
    p3.add_argument("--numax", type=float, default=1410.0)
    p3.add_argument("--dv", type=float, default=0.0025)
    p3.add_argument("--output", default=None)
    p3.add_argument("--device", default="cuda",
                    help="torch device the run uses (e.g. cuda, cuda:1, cpu)")
    p3.add_argument("--n-atmos", type=int, default=4)
    p3.add_argument("--batch", type=int, default=24)
    p3.add_argument("--continuum", default="none",
                    help="continuum model: 'none' (hapi parity) or 'mt_ckd' "
                         "(the MT_CKD-formulation production setup)")
    p3.add_argument("--n-angles", type=int, default=30)
    p3.add_argument("--dv-out", type=float, default=0.25)
    p3.add_argument("--altitudes", type=float, nargs="+",
                    default=[0.061, 0.305, 1.524, 3.048, 6.096, 9.144,
                             12.192, 15.24, 500.0])
    p3.add_argument("--checkpoint", default=None, help="(not ported)")
    p3.add_argument("--line-mixing", dest="line_mixing", action="store_true",
                    help="first-order Rosenkranz CO2 Q-branch line coupling")
    p3.add_argument("--mesh-spectrum", dest="mesh_spectrum", type=int,
                    default=1, help="(not ported)")
    p3.add_argument("--mesh-ensemble", dest="mesh_ensemble", type=int,
                    default=1, help="(not ported)")
    p3.add_argument("--jacobian", action="store_true",
                    help="also write d(tau,Lu,Ld)/d(T,H2O,O3) for the "
                         "standard atmosphere (forward-mode autodiff; "
                         "replaces the reference's 199-profile finite "
                         "differences)")
    p3.add_argument("--jacobian-wrt", dest="jacobian_wrt", default="T,1,3",
                    help="comma list of Jacobian variables: 'T' and/or "
                         "HITRAN molecule ids (default T,1,3 = the "
                         "reference's 199-profile set)")
    p3.set_defaults(fn=cmd_tud)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
