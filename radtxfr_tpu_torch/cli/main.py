"""Command-line entry point of the port (counterpart of
``radtxfr_tpu/cli/main.py``; the ``xsect`` and ``tud`` commands, single
device).

    python -m radtxfr_tpu_torch.cli.main xsect --synthetic 30000 \\
        --numin 400 --numax 7100 --dv 0.0025 --profile sdvoigt \\
        --wing-abs 350 --T 275 --T-max 320 --T-step 5 --p 1.0 \\
        [--device cuda] [--output DIR/xs]
    python -m radtxfr_tpu_torch.cli.main tud --derived --line-mixing \\
        --continuum mt_ckd --numin 690 --numax 1410 --dv 0.0005 \\
        --n-atmos N --batch B [--jacobian [--jacobian-wrt T,1,3]] \\
        [--device cuda] [--output tud.h5]

``xsect`` is configuration 2 of the reference (``RT_gen_AbsXS_files.py``):
absorption cross-sections of a (T, p) lattice on a fine grid, one AFIT_XS
binary file per state. The states are the kernels' layers
(:func:`~..products.od.make_xsect_fn`); absolute wings that dominate every
halfwidth wing (the reference's 350 cm^-1) take the coarse-far route.

``tud`` is configuration 3 of the reference (``Generate_LWIR_TUD.py``):
66-layer multi-altitude transmittance / upwelling / downwelling over the
LWIR band for an ensemble of perturbed standard atmospheres, reduced on the
device to ``--dv-out``, written to HDF5. Members are processed in chunks of
``--batch``; each chunk's reduced products are copied to the host once.
``--jacobian`` adds d(tau, Lu, Ld)/d(T, H2O, O3) of the standard
atmosphere by forward-mode autodiff (the reference's 199-profile finite
differences), 8 directions at a time, each batch reduced on the device as
soon as it exists.

Line data: ``--derived`` (the physics-derived LWIR list) or ``--synthetic
N`` (the deterministic synthetic list; 20,000 lines when neither is given,
as in the JAX CLI).

``xsect --profile ht`` runs the Hartmann-Tran lattice
(:func:`~..products.od.make_ht_fn`), as the JAX CLI's Pallas engine does;
the CLI takes no HT columns, so its lines route to the SD-Voigt and Voigt
degenerations of pcqsdhc.

Not ported yet (each raises ``NotImplementedError``): ``--par`` (parse_par
and the native parser, ROADMAP M9), ``--engine jnp`` (the JAX package's
jnp engine, whose SD-Voigt and HT profiles are pcqsdhc through ``htp.py``,
M13; ROADMAP queue 1 item 3), ``--checkpoint`` (M9) and ``--mesh-*`` (M15,
with the sharded Jacobian; ``tud --partition`` is accepted and matters only
there).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _load_lines(args, device, margin=25.0):
    """The run's line list, ``margin`` cm^-1 beyond each band edge: the
    derived list, or ``--synthetic`` lines (20,000 by default)."""
    from ..lines.derived import derived_lwir_linelist
    from ..lines.synthetic import synthetic_lines

    if args.par:
        raise NotImplementedError(
            "--par: parse_par and the native .par parser are ROADMAP M9")
    if args.derived:
        return derived_lwir_linelist(args.numin - margin,
                                     args.numax + margin, device=device,
                                     dtype=torch.float32)
    return synthetic_lines(args.synthetic or 20000, nu_min=args.numin - margin,
                           nu_max=args.numax + margin, seed=args.seed,
                           device=device, dtype=torch.float32)


def run_xsect(args, device, timings: dict | None = None) -> dict:
    """The ``xsect`` lattice on ``device``.

    Returns ``{"X", "T", "p", "K", "mol_id", "modes"}``: the axis (nX,),
    the states' T [K] and p [atm] (nStates,), the NumPy float32
    cross-sections (nStates, nX) [cm^2/molec], the AFIT molecule id (the
    list's one molecule, else 0) and the modes of the kernel passes run.
    ``timings``, when given, receives ``build_s`` (lines and plans) and
    ``run_s`` (the lattice, on the host).
    """
    from ..core.grid import arange_drift_free
    from ..lines.store import IsoTables
    from ..products.od import make_ht_fn, make_xsect_fn

    if args.engine == "jnp":
        raise NotImplementedError(
            "--engine jnp: the JAX package's jnp engine (SD-Voigt through "
            "htp.py's pcqsdhc) is not ported; the port runs the kernels")
    device = torch.device(device)
    f32 = torch.float32
    t0 = time.perf_counter()
    store = _load_lines(args, device, margin=max(50.0, args.wing_abs))
    iso = IsoTables.load(device=device, dtype=f32)
    X = arange_drift_free(args.numin, args.numax, args.dv)
    # the (T, p) lattice, reference XS-generator style
    # (misc/RT_gen_AbsXS_files.py:25-30); defaults to the single state
    T_states = (np.arange(args.T, args.T_max + 1e-9, args.T_step)
                if args.T_max else np.array([args.T]))
    p_states = (np.arange(args.p, args.p_max + 1e-9, args.p_step)
                if args.p_max else np.array([args.p]))
    TT, PP = [a.ravel() for a in np.meshgrid(T_states, p_states,
                                             indexing="ij")]
    if args.profile == "ht":
        # the CLI takes no HT columns: the lines resolve eta = nuVC = Shift2
        # = 0 and route to pcqsdhc's SD-Voigt and Voigt degenerations
        fn = make_ht_fn(store, iso, X, TT, PP, wing_abs=args.wing_abs,
                        wing_hw=args.wing_hw)
    else:
        fn = make_xsect_fn(store, iso, X, TT, PP, profile=args.profile,
                           wing_abs=args.wing_abs, wing_hw=args.wing_hw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    K = fn(torch.as_tensor(TT, dtype=f32, device=device),
           torch.as_tensor(PP, dtype=f32, device=device)).cpu().numpy()
    if timings is not None:
        timings.update(build_s=t1 - t0, run_s=time.perf_counter() - t1)
    mols = np.unique(store.host["mol_id"])
    return {"X": X, "T": TT, "p": PP, "K": K,
            "mol_id": int(mols[0]) if mols.size == 1 else 0,
            "modes": [c[2] for c in fn.all_calls()]}


def write_xs(path, xs: dict, db_name: str) -> list:
    """One AFIT_XS file per state: ``path`` for a single state, else
    ``path.T<T>_p<p>`` (the JAX CLI's names); the paths written."""
    from ..io.afit_xs import xs_write

    T, p = xs["T"], xs["p"]
    return [xs_write(xs["X"], xs["K"][i], float(T_s), float(p_s) * 101325.0,
                     xs["mol_id"], db_name,
                     fname=(path if T.size == 1
                            else f"{path}.T{T_s:g}_p{p_s:g}"))
            for i, (T_s, p_s) in enumerate(zip(T, p))]


def cmd_xsect(args):
    timings = {}
    xs = run_xsect(args, args.device, timings)
    n, n_x = xs["T"].size, xs["X"].size
    print(f"xsect [{args.device}]: {n} (T,p) states x {n_x} points, max "
          f"{xs['K'].max():.3e} cm^2/molec; build {timings['build_s']:.3f} "
          f"s, lattice {timings['run_s']:.3f} s "
          f"({n / timings['run_s']:.3f} states/s)")
    if args.output:
        db = "radtxfr_tpu synthetic" if not args.par else args.par
        write_xs(args.output, xs, db)
        print(f"wrote {n} file(s) at {args.output}")


def ensemble_draws(n_atmos: int, seed: int):
    """The ensemble's perturbations, member for member as the JAX CLI draws
    them: T offsets from N(0, 5 K), (n_atmos, 1), and H2O column scales from
    U(0.5, 1.5), (n_atmos,), both float32."""
    rng = np.random.default_rng(seed)
    dT = rng.normal(0.0, 5.0, (n_atmos, 1)).astype(np.float32)
    scale_h2o = rng.uniform(0.5, 1.5, n_atmos).astype(np.float32)
    return dT, scale_h2o


def ensemble_member(base, draws, i: int):
    """Member ``i``'s (T, vmr): the state ``base`` with its T offset by
    ``draws`` (:func:`ensemble_draws`) and its H2O column scaled."""
    dT, scale_h2o = draws
    T = base.T + torch.as_tensor(dT[i], device=base.T.device)
    vmr = base.vmr.clone()
    vmr[:, 0] *= float(scale_h2o[i])
    return T, vmr


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

    if args.engine == "jnp":
        raise NotImplementedError(
            "--engine jnp: the JAX package's reference engine for tud is "
            "ROADMAP queue 1 item 3; the port runs the kernels")
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

    draws = ensemble_draws(args.n_atmos, args.seed)

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

    t1 = time.perf_counter()
    parts = {"tau": [], "Lu": [], "Ld": []}
    chunk_s = []
    for lo in range(0, args.n_atmos, args.batch):
        tc = time.perf_counter()
        chunk = {"tau": [], "Lu": [], "Ld": []}
        for i in range(lo, min(lo + args.batch, args.n_atmos)):
            T, vmr = ensemble_member(base, draws, i)
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


def _add_common(p):
    p.add_argument("--par", help="HITRAN .par line database (not ported)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic lines (default 20000 when neither "
                        "--synthetic nor --derived is given)")
    p.add_argument("--derived", action="store_true",
                   help="use the physics-derived H2O+CO2+O3+N2O+CH4 LWIR "
                        "list (lines/derived.py)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--numin", type=float, default=690.0)
    p.add_argument("--numax", type=float, default=1410.0)
    p.add_argument("--dv", type=float, default=0.0025)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device the run uses (e.g. cuda, cuda:1, cpu)")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "jnp", "pallas"],
                   help="'auto' and 'pallas' (the JAX CLI's name) run the "
                        "kernels; 'jnp' is not ported")


def build_parser():
    p = argparse.ArgumentParser(
        prog="radtxfr_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    p2 = sub.add_parser("xsect", help="config 2: (T, p) cross-section lattice")
    _add_common(p2)
    p2.add_argument("--T", type=float, default=296.0)
    p2.add_argument("--p", type=float, default=1.0, help="pressure [atm]")
    p2.add_argument("--profile", default="voigt",
                    choices=["voigt", "lorentz", "doppler", "sdvoigt", "ht"])
    p2.add_argument("--wing-hw", dest="wing_hw", type=float, default=50.0)
    p2.add_argument("--wing-abs", dest="wing_abs", type=float, default=0.0,
                    help="absolute wing [cm^-1] (reference XS generator: 350)")
    p2.add_argument("--T-max", dest="T_max", type=float, default=None,
                    help="build a T lattice from --T to --T-max")
    p2.add_argument("--T-step", dest="T_step", type=float, default=5.0)
    p2.add_argument("--p-max", dest="p_max", type=float, default=None,
                    help="build a p lattice from --p to --p-max [atm]")
    p2.add_argument("--p-step", dest="p_step", type=float, default=0.05)
    p2.set_defaults(fn=cmd_xsect)

    p3 = sub.add_parser("tud", help="config 3: ensemble TUD production")
    _add_common(p3)
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
    p3.add_argument("--partition", default="weighted",
                    choices=["equal", "weighted"],
                    help="spectral-shard assignment of the --mesh-* path "
                         "(accepted; matters only with --mesh-*)")
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
