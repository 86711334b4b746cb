"""Command-line entry point of the port (counterpart of
``radtxfr_tpu/cli/main.py``; every command).

    python -m radtxfr_tpu_torch.cli.main xsect --synthetic 30000 \\
        --numin 400 --numax 7100 --dv 0.0025 --profile sdvoigt \\
        --wing-abs 350 --T 275 --T-max 320 --T-step 5 --p 1.0 \\
        [--engine auto|pallas|jnp] [--device cuda] [--output DIR/xs]
    python -m radtxfr_tpu_torch.cli.main tud --derived --line-mixing \\
        --continuum mt_ckd --numin 690 --numax 1410 --dv 0.0005 \\
        --n-atmos N --batch B [--checkpoint DIR] \\
        [--jacobian [--jacobian-wrt T,1,3]] [--engine auto|pallas|jnp] \\
        [--mesh-spectrum S --mesh-ensemble E [--partition equal]] \\
        [--device cuda] [--output tud.h5]

``xsect`` is configuration 2 of the reference (``RT_gen_AbsXS_files.py``):
absorption cross-sections of a (T, p) lattice on a fine grid, one AFIT_XS
binary file per state. The states are the kernels' layers
(:func:`~..products.od.make_xsect_fn`); absolute wings that dominate every
halfwidth wing (the reference's 350 cm^-1) take the coarse-far route.
``--profile ht`` runs the Hartmann-Tran lattice
(:func:`~..products.od.make_ht_fn`); the CLI takes no HT columns, so its
lines route to the SD-Voigt and Voigt degenerations of pcqsdhc.

``tud`` is configuration 3 of the reference (``Generate_LWIR_TUD.py``):
66-layer multi-altitude transmittance / upwelling / downwelling over the
LWIR band for an ensemble of perturbed standard atmospheres, reduced on the
device to ``--dv-out`` (by ``reduce_resolution`` member by member where the
banded operator does not apply, e.g. under 3 fine steps), written to HDF5.
Members run in batches of ``--batch``; each batch's reduced products are
copied to the host once. ``--checkpoint DIR`` persists each batch as
``DIR/batch_%06d.npz`` as soon as it exists (:mod:`..dist.checkpoint`): a
run that is killed and started again with the same arguments computes only
the missing batches, and its products are bit-identical to an
uninterrupted run's. ``--jacobian`` adds d(tau, Lu, Ld)/d(T, H2O, O3) of
the standard atmosphere by forward-mode autodiff (the reference's
199-profile finite differences), 8 directions at a time.

Engines (``--engine``): ``auto`` and ``pallas`` (the JAX CLI's name) run
the CUDA kernels on every device (their plain versions for ``--device
cpu``); ``jnp`` runs the reference engine, plain PyTorch on the device
asked for: ``xsect`` per state ``compute_line_params`` and
``xsect_from_params`` (``xsect_ht`` for ``--profile ht``), ``tud`` per
member ``compute_od_layers(engine="jnp")``, the Planck source and
``tud_from_od``, and its Jacobian ``tud_with_jacobian(engine="jnp")``.

Line data: ``--par FILE`` (a HITRAN ``.par`` file, the native parser),
``--derived`` (the physics-derived LWIR list) or ``--synthetic N`` (the
deterministic synthetic list; 20,000 lines when none is given, as in the
JAX CLI).

``tud --mesh-spectrum S --mesh-ensemble E`` runs the sharded production
path of the JAX CLI: an (E x S) mesh of the visible cards
(:func:`~..dist.mesh.make_mesh`; too few raise), the members of a batch
(``--batch`` a multiple of E) split over the ensemble axis and the padded
grid over the spectrum axis with ``--partition`` ('weighted': tiles dealt
by op-weighted work; 'equal': contiguous slices), through
:func:`~..dist.fused_ensemble.make_tud_ensemble_fn` (the kernels, whatever
``--engine`` says), with ``--checkpoint`` and ``--jacobian``
(:func:`~..dist.fused_ensemble.make_tud_jacobian_fn`: directions over the
ensemble axis) as above. ``run_tud(..., mesh=...)`` takes a mesh of its
own, e.g. a virtual one that lists one card several times.

The scene and sensor commands turn ``tud``'s products into the reference's
downstream data (``SURVEY.md`` §1, layers L2-L4), with the JAX CLI's flags,
defaults and files:

    python -m radtxfr_tpu_torch.cli.main planck [--numin/--numax/--dv]
    python -m radtxfr_tpu_torch.cli.main mako --input tud.h5 \
        [--sort-atmos] --output mako.h5
    python -m radtxfr_tpu_torch.cli.main radiance --input tud.h5 \
        --output radiance.h5
    python -m radtxfr_tpu_torch.cli.main hsi --input tud.h5 --output hsi.h5
    python -m radtxfr_tpu_torch.cli.main emis [--mixtures --mako \
        --features K] --output DB
    python -m radtxfr_tpu_torch.cli.main atmosgen [--input ens.npz] \
        --output gen.npz

``planck`` is configuration 1 (the StdAtmos Planck round trip), ``mako``
configuration 4 (``Generate_LWIR_TUD_MAKO.py``: the ILS product on the
card), ``radiance`` the apparent-radiance dataset
(``Compute_LWIR_Apparent_Radiance.py``: one (nX, nE, nA, nT) broadcast on
the card, copied to the host once), ``hsi`` configuration 5
(``LWIR_HSI_Generator.py``), ``emis`` the emissivity DB build
(``Generate_ASTER_emissivity_DB.py``, ``Generate_Emissivity_DB.py``) and
``atmosgen`` the PCA+GMM ensemble augmentation
(``GenerativeModel_AtmosInputs.py``). Each has ``run_<cmd>(args, device,
data)``, which computes from arrays in memory (a host without h5py can
drive it), and ``cmd_<cmd>(args)``, which reads and writes the files.
They compute in float32 on the card and float64 on the CPU (``atmosgen``
in float64 on both); their random draws come from a ``torch.Generator`` on
the device seeded by ``--seed``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from .. import as_numpy, resolve_device


def _load_lines(args, device, margin=25.0):
    """The run's line list, ``margin`` cm^-1 beyond each band edge: the
    ``--par`` file's lines, the derived list, or ``--synthetic`` lines
    (20,000 by default)."""
    from ..lines.derived import derived_lwir_linelist
    from ..lines.store import parse_par
    from ..lines.synthetic import synthetic_lines

    if args.par:
        store = parse_par(args.par, device=device, dtype=torch.float32)
        return store.select_band(args.numin, args.numax, margin=margin)
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
    list's one molecule, else 0) and the modes of the kernel passes run
    (none on the jnp engine). ``timings``, when given, receives
    ``build_s`` (lines and plans) and ``run_s`` (the lattice, on the
    host).
    """
    from ..core.grid import arange_drift_free
    from ..lines.store import IsoTables
    from ..products.od import make_ht_fn, make_xsect_fn

    device = resolve_device(device)
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
    fn, modes = None, []
    if args.engine != "jnp":
        if args.profile == "ht":
            # the CLI takes no HT columns: the lines resolve eta = nuVC =
            # Shift2 = 0 and route to pcqsdhc's SD-Voigt and Voigt
            # degenerations
            fn = make_ht_fn(store, iso, X, TT, PP, wing_abs=args.wing_abs,
                            wing_hw=args.wing_hw)
        else:
            fn = make_xsect_fn(store, iso, X, TT, PP, profile=args.profile,
                               wing_abs=args.wing_abs, wing_hw=args.wing_hw)
        modes = [c[2] for c in fn.all_calls()]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    if fn is None:
        K = _xsect_jnp(args, store, iso, X, TT, PP)
    else:
        K = fn(torch.as_tensor(TT, dtype=f32, device=device),
               torch.as_tensor(PP, dtype=f32, device=device))
    K = K.cpu().numpy()
    if timings is not None:
        timings.update(build_s=t1 - t0, run_s=time.perf_counter() - t1)
    mols = np.unique(store.host["mol_id"])
    return {"X": X, "T": TT, "p": PP, "K": K,
            "mol_id": int(mols[0]) if mols.size == 1 else 0, "modes": modes}


def _xsect_jnp(args, store, iso, X, TT, PP):
    """The lattice (nStates, nX) by the reference engine, one state at a
    time at its float64 (T, p), as the JAX CLI's jnp engine."""
    from ..kernels.ht_driver import xsect_ht
    from ..kernels.lineparams import compute_line_params
    from ..kernels.xsect import xsect_from_params

    grid = torch.as_tensor(X, dtype=torch.float32, device=store.sw.device)
    kw = dict(wing_abs=args.wing_abs, wing_hw=args.wing_hw)

    def one(T, p):
        if args.profile == "ht":
            return xsect_ht(grid, store, iso, T, p, **kw)
        prm = compute_line_params(store, iso, T, p, profile=args.profile,
                                  **kw)
        return xsect_from_params(grid, prm, profile=args.profile)

    return torch.stack([one(float(T), float(p)) for T, p in zip(TT, PP)])


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


def _reducer(X, dv_out, device):
    """``(x_lo, reduce, op)``: the reduced axis, ``reduce(a)`` of an (nX,
    ...) tensor on ``device`` and the banded operator ``op`` where it
    applies (the default axis is interior; it refuses when there is nothing
    to reduce, under 3 fine steps: ``op`` None and ``reduce`` by
    ``reduce_resolution``)."""
    from ..sensor.resolution import reduce_operator, reduce_resolution

    try:
        op = reduce_operator(X, dv_out, device=device)
        return op.x_out, op, op
    except ValueError:
        x_lo = reduce_resolution(X, torch.as_tensor(X, device=device),
                                 dv_out)[0]
        return x_lo, (lambda a: reduce_resolution(X, a, dv_out,
                                                  X_out=x_lo)), None


def _run_batches(args, compute_batch):
    """The ensemble in batches of ``--batch``: through the checkpoint
    directory (only the pending batches computed) or all in memory."""
    from ..dist.checkpoint import EnsembleCheckpoint, run_batched

    if args.checkpoint:
        ckpt = EnsembleCheckpoint(args.checkpoint, args.n_atmos, args.batch)
        return run_batched(ckpt, compute_batch)
    parts = [compute_batch(range(lo, min(lo + args.batch, args.n_atmos)))
             for lo in range(0, args.n_atmos, args.batch)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def run_tud(args, device, timings: dict | None = None, mesh=None):
    """The ``tud`` production path on ``device``.

    Returns ``(x_lo, {"tau", "Lu", "Ld"})``: the reduced axis (n_out,) and
    NumPy products tau/Lu (n_atmos, n_out, nZs), Ld (n_atmos, n_out); with
    ``--jacobian`` also ``d{tau,Lu}_d{T,H2O,O3}`` and ``dLd_d*``, the JAX
    CLI's keys and shapes: reduced, (n_out, nZs, nLay) and (n_out, nLay),
    where the banded operator applies, else at full resolution with the
    mu axis, (nX, nZs, 1, nLay) and (nX, nLay). ``timings``, when given,
    receives ``report``, the report of the :class:`~..utils.PhaseTimer`
    charged the JAX CLI's phases (``build``; a batch's ``od+tud+reduce``
    on the kernels, ``tud`` with ``--mesh-*``, or each member's ``od``,
    ``tud`` and ``reduce`` with ``--engine jnp``; ``jacobian``), and the
    seconds read from it: ``build_s`` (lines, plans, operators), ``chunk_s`` (each
    batch computed) and, with ``--jacobian``, ``jacobian_s``; besides,
    ``members_s`` (all members computed in this call, products on the
    host). With ``--checkpoint`` only the pending batches are computed and
    the products are gathered from the batch files.

    ``--mesh-*`` runs the sharded path on ``mesh`` (None: an (E x S) mesh
    of the visible cards; a mesh given must have the flags' shape), its
    products joined on ``device``.
    """
    from ..atmos.profile import std_atmosphere
    from ..core.grid import arange_drift_free
    from ..dist.mesh import ENSEMBLE, SPECTRUM, make_mesh
    from ..kernels.linemixing_data import y_air_for_store
    from ..lines.store import IsoTables
    from ..utils import PhaseTimer, device_sync

    timer = PhaseTimer()
    shape = {ENSEMBLE: args.mesh_ensemble, SPECTRUM: args.mesh_spectrum}
    if mesh is None and args.mesh_spectrum * args.mesh_ensemble > 1:
        mesh = make_mesh(args.mesh_ensemble, args.mesh_spectrum)
    if mesh is not None and mesh.shape != shape:
        raise ValueError(f"the mesh {mesh.shape} is not the --mesh-* "
                         f"flags' {shape}")
    if args.batch < 1 or args.n_atmos < 1:
        raise ValueError("--batch and --n-atmos must be positive")
    device = resolve_device(device)
    f32 = torch.float32

    with timer.phase("build"):
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
        if mesh is not None:
            members, X_red, jac_fn = _mesh_members(
                args, store, iso, X, base, draws, line_mixing, mesh, device)
        else:
            member = _member_fn(args, store, iso, X, grid, base,
                                line_mixing, device, timer)
            X_red = X

            def members(indices):
                return [member(*ensemble_member(base, draws, int(i)))
                        for i in indices]

            def jac_fn(op):
                return _jacobian(args, store, iso, grid, base, op,
                                 line_mixing, device)
        x_lo, reduce_one, op = _reducer(X_red, args.dv_out, device)
        n = X.size

        def reduce(tau, Lu, Ld):
            # all sensor altitudes, as the reference stores them
            # (Generate_LWIR_TUD.py:96-132)
            return tuple(reduce_one(a[:n])
                         for a in (tau[:, :, 0], Lu[:, :, 0], Ld))

        if device.type == "cuda":
            torch.cuda.synchronize(device)

    chunk_s = []

    if mesh is not None:
        batch_phase = ("tud", X.size)
    elif args.engine != "jnp":
        batch_phase = ("od+tud+reduce", store.n_lines * base.n_layers)
    else:
        batch_phase = None     # the engine's members: od, tud, reduce

    def reduce_member(prod):
        if batch_phase is not None:
            return reduce(*prod)
        with timer.phase("reduce"):
            return device_sync(reduce(*prod))

    def compute_batch(indices):
        charged = sum(timer.phases.values())
        with (timer.phase(batch_phase[0],
                          work_items=len(indices) * batch_phase[1])
              if batch_phase else contextlib.nullcontext()):
            parts = {"tau": [], "Lu": [], "Ld": []}
            for prod in members(indices):
                for k, v in zip(parts, reduce_member(prod)):
                    parts[k].append(v)
            out = {k: torch.stack(v).cpu().numpy() for k, v in parts.items()}
        chunk_s.append(sum(timer.phases.values()) - charged)
        return out

    t1 = time.perf_counter()
    out = _run_batches(args, compute_batch)
    members_s = time.perf_counter() - t1
    if args.jacobian:
        with timer.phase("jacobian"):
            out.update(jac_fn(op))
    if timings is not None:
        timings.update(report=timer.report(), build_s=timer.phases["build"],
                       members_s=members_s, chunk_s=chunk_s)
        if args.jacobian:
            timings["jacobian_s"] = timer.phases["jacobian"]
    return x_lo, out


def _mesh_members(args, store, iso, X, base, draws, line_mixing, mesh,
                  device):
    """The ``--mesh-*`` path's parts: ``members(indices)`` giving each
    member's full-resolution (tau, Lu, Ld) on the padded grid (a batch of
    ``--batch`` through the sharded builder, a short last batch padded
    with its first member), the padded axis's first len(X) points (the
    reduction's fine axis, as the JAX CLI's) and ``jac_fn(op)``, the
    sharded Jacobian."""
    from ..dist.ensemble import stack_states
    from ..dist.fused_ensemble import make_tud_ensemble_fn
    from ..dist.mesh import ENSEMBLE

    n_ens = mesh.shape[ENSEMBLE]
    if args.batch % n_ens:
        raise SystemExit(f"--batch ({args.batch}) must be divisible by "
                         f"--mesh-ensemble ({n_ens})")

    def state(i):
        T, vmr = ensemble_member(base, draws, int(i))
        return dataclasses.replace(base, T=T, vmr=vmr)

    probe = stack_states([state(i % args.n_atmos)
                          for i in range(args.batch)])
    gpad, run = make_tud_ensemble_fn(
        store, iso, X, probe, args.altitudes, mesh, n_angles=args.n_angles,
        continuum=args.continuum, line_mixing=line_mixing,
        partition=args.partition)

    def members(indices):
        idx = [int(i) for i in indices]
        keep = len(idx)
        idx += [idx[0]] * (args.batch - keep)
        tau, Lu, Ld = run(stack_states([state(i) for i in idx]))
        return [(tau[k], Lu[k], Ld[k]) for k in range(keep)]

    def jac_fn(op):
        return _mesh_jacobian(args, store, iso, X, base, line_mixing, mesh,
                              op)

    return members, gpad.values()[:X.size], jac_fn


def _mesh_jacobian(args, store, iso, X, base, line_mixing, mesh, op):
    """The sharded ``--jacobian``: one-hot directions in batches of
    ``max(E, 8 // E * E)`` over the ensemble axis, the padded grid over the
    spectrum axis; each batch's tangents reduced by ``op`` before the next
    (the JAX CLI's keys and shapes)."""
    from ..dist.fused_ensemble import (jacobian_directions,
                                       make_tud_jacobian_fn)
    from ..dist.mesh import ENSEMBLE

    if op is None:
        raise ValueError("--mesh-* --jacobian reduces each direction batch "
                         "by the banded operator, which needs --dv-out of "
                         "at least 3 fine steps")
    if line_mixing is not None:
        print("jacobian: line-mixing tangents are not supported by the "
              "differentiable kernels; the Jacobian runs without mixing")
    n_ens = mesh.shape[ENSEMBLE]
    _, run_j = make_tud_jacobian_fn(store, iso, X, base, args.altitudes,
                                    mesh, n_angles=args.n_angles,
                                    continuum=args.continuum,
                                    partition=args.partition)
    wrt = tuple(w if w == "T" else int(w)
                for w in args.jacobian_wrt.split(","))
    V_T, V_vmr, _ = jacobian_directions(base, wrt=wrt)
    n, n_dirs = X.size, V_T.shape[0]
    dbatch = max(n_ens, (8 // n_ens) * n_ens)
    parts = []
    for lo in range(0, n_dirs, dbatch):
        idx = [min(i, n_dirs - 1) for i in range(lo, lo + dbatch)]
        _, tan = run_j(base.T, base.vmr, V_T[idx], V_vmr[idx])
        keep = min(dbatch, n_dirs - lo)
        parts.append({k: torch.stack([op(a[d, :n]) for d in range(keep)])
                      .cpu().numpy() for k, a in tan.items()})
    tan_all = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    n_lay = int(base.T.numel())
    names = {"T": "T", 1: "H2O", 3: "O3"}
    out = {}
    for vi, key in enumerate(wrt):
        sl = slice(vi * n_lay, (vi + 1) * n_lay)
        for prod in ("tau", "Lu", "Ld"):
            a = tan_all[prod][sl]
            a = a[..., 0] if a.ndim == 4 else a
            out[f"d{prod}_d{names.get(key, str(key))}"] = np.moveaxis(a, 0,
                                                                      -1)
    print(f"jacobian: {n_dirs} sharded directions "
          f"({sum(v.size for v in out.values())} elements)")
    return out


def _member_fn(args, store, iso, X, grid, base, line_mixing, device, timer):
    """``member(T, vmr) -> (tau, Lu, Ld)`` at full resolution, tau/Lu
    (nX, nZs, 1) and Ld (nX,): the kernels' builders (``auto``,
    ``pallas``) or the reference engine (``jnp``, its ``od`` and ``tud``
    charged to ``timer``)."""
    from ..core.planck import planckian
    from ..products.od import compute_od_layers, make_od_fn
    from ..products.tud import make_tud_fn, tud_from_od
    from ..utils import device_sync

    if args.engine != "jnp":
        od_fn = make_od_fn(store, iso, X, base, continuum=args.continuum,
                           line_mixing=line_mixing)
        tud_fn = make_tud_fn(base.z0.cpu().numpy(), args.altitudes,
                             n_angles=args.n_angles, device=device)

        def member(T, vmr):
            tud = tud_fn(grid, od_fn(T, base.p, base.pl, vmr), T)
            return tud.tau, tud.Lu, tud.Ld
        return member

    alts = torch.as_tensor(args.altitudes, dtype=grid.dtype, device=device)

    def member(T, vmr):
        with timer.phase("od", work_items=store.n_lines * base.n_layers):
            od = device_sync(compute_od_layers(
                store, iso, grid, dataclasses.replace(base, T=T, vmr=vmr),
                engine="jnp", continuum=args.continuum,
                line_mixing=line_mixing))
        with timer.phase("tud", work_items=X.size):
            B = planckian(grid, T).transpose(0, 1).to(od.dtype)
            tud = device_sync(tud_from_od(grid, od, B, base.z0, alts,
                                          n_angles=args.n_angles))
        return tud.tau, tud.Lu, tud.Ld
    return member


def _jacobian(args, store, iso, grid, base, op, line_mixing, device):
    """The ``--jacobian`` products of the standard atmosphere as NumPy
    arrays under the JAX CLI's keys: reduced like tau/Lu/Ld, the singleton
    mu axis dropped, where the banded operator ``op`` exists; at full
    resolution otherwise, as the JAX CLI keeps them."""
    from ..products.jacobian import tud_with_jacobian

    wrt = tuple(w if w == "T" else int(w)
                for w in args.jacobian_wrt.split(","))
    if line_mixing is not None:
        print("jacobian: line-mixing tangents are not supported by the "
              "differentiable kernels; the Jacobian runs without mixing")
    alts = torch.as_tensor(args.altitudes, dtype=torch.float32,
                           device=device)
    _, jac = tud_with_jacobian(
        store, iso, grid, base, alts, wrt=wrt, n_angles=args.n_angles,
        tangent_batch=8, continuum=args.continuum, reduce=op,
        engine="jnp" if args.engine == "jnp" else "pallas")
    names = {"T": "T", 1: "H2O", 3: "O3"}
    out = {}
    for key in wrt:
        for prod in ("tau", "Lu", "Ld"):
            a = jac[str(key)][prod]
            if op is not None and a.dim() == 4:
                a = a[:, :, 0]
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
    print(timings["report"])
    if args.output:
        _write_tud_h5(args.output, x_lo, out, args.altitudes)


# --------------------------------------------------------------------------
# The scene and sensor commands: run_<cmd> computes from arrays in memory,
# cmd_<cmd> reads and writes the JAX CLI's files
# --------------------------------------------------------------------------

def _scene_device(device) -> tuple[torch.device, torch.dtype]:
    """The scene commands' device (:func:`resolve_device`) and working
    dtype: float32 on the card, float64 on the CPU (the JAX CLI's float64
    under x64)."""
    device = resolve_device(device)
    return device, (torch.float64 if device.type == "cpu"
                    else torch.float32)


def run_planck(args, device, data=None) -> dict:
    """Configuration 1: the Planck radiance of the StdAtmos ground
    temperature on ``make_spectral_axis(numin, numax, max(dv, 0.25))`` and
    its brightness-temperature round trip. Returns NumPy ``X``, ``B`` and
    the round trip's largest error ``bt_err`` [K], with ``T0`` [K]."""
    from ..atmos.profile import std_atmosphere
    from ..core.grid import make_spectral_axis
    from ..core.planck import brightness_temperature, planckian

    device, dt = _scene_device(device)
    T0 = std_atmosphere(device=device, dtype=dt).T[0]
    X = make_spectral_axis(args.numin, args.numax, max(args.dv, 0.25))
    Xt = torch.as_tensor(X, dtype=dt, device=T0.device)
    B = planckian(Xt, T0)
    err = torch.max(torch.abs(brightness_temperature(Xt, B) - T0))
    return {"X": X, "B": B.cpu().numpy(), "T0": float(T0),
            "bt_err": float(err)}


def cmd_planck(args):
    out = run_planck(args, args.device)
    print(f"Planck @ ground T={out['T0']:.2f} K: L in "
          f"[{out['B'].min():.3f}, {out['B'].max():.3f}] µW/(cm^2 sr "
          f"cm^-1); BT round-trip max err {out['bt_err']:.2e} K")


def _read_tud(path) -> tuple[dict, dict]:
    """A TUD HDF5 file (``tud``'s output) as ({name: array}, {name: Var})."""
    from ..io.h5 import read_h5

    v = read_h5(path)
    return {k: v[k].data for k in ("X", "tau", "La", "Ld")}, v


def run_mako(args, device, data) -> dict:
    """Configuration 4: the MAKO channels of a TUD (``data``: NumPy
    ``X`` (nX,), ``tau``/``La`` (nA, nX[, nZs]) and ``Ld`` (nA, nX), the top
    altitude taken where there are several, as
    ``Generate_LWIR_TUD_MAKO.py:26-28``) by the ILS product on ``device``.
    Returns NumPy ``X`` (channels) and ``tau``/``La``/``Ld`` (nA, n_chan),
    with ``--sort-atmos`` in order of band-mean tau and ``atmos_order``."""
    from ..sensor.ils import ils_mako

    device, dt = _scene_device(device)
    X = as_numpy(data["X"])
    out = {}
    for name in ("tau", "La", "Ld"):
        Y = as_numpy(data[name])
        if Y.ndim == 3:
            Y = Y[:, :, -1]
        Y = torch.as_tensor(Y.T if Y.ndim == 2 else Y[:, None], dtype=dt,
                            device=device)
        x_out, y = ils_mako(X, Y, fwhm_sf=args.fwhm_sf, shift=args.shift,
                            scale=args.scale)
        out[name] = y.T.cpu().numpy()
    out["X"] = x_out
    if args.sort_atmos:
        # the reference sorts by band-mean transmittance
        # (Generate_LWIR_TUD_MAKO.py:39-44)
        order = np.argsort(out["tau"].mean(axis=1))
        out.update({k: out[k][order] for k in ("tau", "La", "Ld")},
                   atmos_order=order)
    return out


def cmd_mako(args):
    from ..io.h5 import Var, write_h5

    data, meta = _read_tud(args.input)
    out = run_mako(args, args.device, data)
    print(f"MAKO: {out['X'].size} channels")
    if args.output:
        res = {k: Var(out[k], units=meta[k].units,
                      name=meta[k].name + " (MAKO)")
               for k in ("tau", "La", "Ld")}
        res["X"] = Var(out["X"], units="cm^{-1}", name="MAKO channel centers")
        if "atmos_order" in out:
            res["atmos_order"] = Var(
                out["atmos_order"], units="none",
                name="Atmosphere sort order (by mean tau)")
        write_h5(args.output, res)
        print(f"wrote {args.output}")


def _spec_major(a):
    """(nA, nX[, nZs]) -> (nX, nA), the top altitude where there are
    several."""
    a = as_numpy(a)
    if a.ndim == 3:
        a = a[:, :, -1]
    return a.T if a.ndim == 2 else a


def run_radiance(args, device, data) -> dict:
    """The apparent-radiance ML dataset (``Compute_LWIR_Apparent_Radiance``):
    the (nX, nE, nA, nT) broadcast of a TUD (``data`` as :func:`run_mako`'s)
    over ``--n-materials`` synthetic emissivities and surface temperatures
    296 K + (-10 .. 10 K by ``--dT-step``), computed on ``device`` and
    copied to the host once. Returns NumPy ``X``, ``L`` (the working
    dtype), ``dT``, ``emis`` (nX, nE) and the split ``ix_train``,
    ``ix_test``, ``ix_val``."""
    from ..io.h5 import gen_indices
    from ..products.radiance import apparent_radiance
    from ..scene.emissivity import synthetic_db

    device, dt = _scene_device(device)
    X = as_numpy(data["X"])
    tau, Lu, Ld = (_spec_major(data[k]) for k in ("tau", "La", "Ld"))
    n_atm = tau.shape[1]
    emis = synthetic_db(args.n_materials, X=X, seed=args.seed, device="cpu"
                        ).emis.numpy().T                        # (nX, nE)
    dT = np.arange(-10.0, 10.0 + args.dT_step, args.dT_step)
    L = apparent_radiance(X, emis, np.full(n_atm, 296.0), tau, Lu, Ld,
                          dT=dT, device=device, dtype=dt).cpu().numpy()
    n_samples = L.shape[1] * L.shape[2] * L.shape[3]
    tr, te, va = gen_indices(n_samples, seed=args.seed)
    return {"X": X, "L": L, "dT": dT, "emis": emis, "ix_train": tr,
            "ix_test": te, "ix_val": va}


def cmd_radiance(args):
    from ..io.h5 import Var, write_h5

    data, _ = _read_tud(args.input)
    out = run_radiance(args, args.device, data)
    L = out["L"]
    print(f"radiance tensor {L.shape} -> {L[0].size} samples "
          f"(train {len(out['ix_train'])}/test {len(out['ix_test'])}/val "
          f"{len(out['ix_val'])})")
    if args.output:
        write_h5(args.output, {
            "X": Var(out["X"], units="cm^{-1}", name="Wavenumbers"),
            "L": Var(L.astype(np.float32), units="µW/(cm^2 sr cm^{-1})",
                     name="At-sensor apparent spectral radiance",
                     info="(nX, nE, nA, nT) broadcast tensor"),
            "dT": Var(out["dT"], units="K", name="Surface temperature deltas"),
            "emis": Var(out["emis"], units="none",
                        name="Surface emissivities"),
            "ix_train": Var(out["ix_train"]), "ix_test": Var(out["ix_test"]),
            "ix_val": Var(out["ix_val"]),
        })
        print(f"wrote {args.output}")


def run_hsi(args, device, data) -> dict:
    """Configuration 5: mixed-pixel HSI cubes over a TUD ensemble
    (``data`` as :func:`run_mako`'s; the top altitude of tau/La), with
    ``--n-materials`` synthetic emissivities, 296 K surfaces and the draws
    of a generator on ``device`` seeded by ``--seed``. Returns NumPy ``X``
    and :func:`~..scene.hsi.hsi_generate`'s arrays."""
    from ..scene.emissivity import synthetic_db
    from ..scene.hsi import hsi_generate

    device, dt = _scene_device(device)
    X = as_numpy(data["X"])
    top = lambda a: a[:, :, -1] if a.ndim == 3 else a   # noqa: E731
    tau, Lu = (top(as_numpy(data[k])) for k in ("tau", "La"))
    Ld = as_numpy(data["Ld"])
    db = synthetic_db(args.n_materials, X=X, seed=args.seed, device=device,
                      dtype=dt)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    out = hsi_generate(gen, X, tau, Lu, Ld, np.full(tau.shape[0], 296.0),
                       db.emis, n_pixels=args.n_pixels, dT=args.dT,
                       n_emis=args.n_emis, n_mix=args.n_mix,
                       n_atm=min(args.n_atm, tau.shape[0]), device=device,
                       dtype=dt)
    return {"X": X, **{k: v.cpu().numpy() for k, v in out.items()}}


def cmd_hsi(args):
    from ..io.h5 import Var, write_h5

    data, _ = _read_tud(args.input)
    out = run_hsi(args, args.device, data)
    L = out["L"]
    print(f"HSI cube: {L.shape}, L in [{L.min():.3f}, {L.max():.3f}]")
    if args.output:
        write_h5(args.output, {
            "L": Var(L, units="µW/(cm^2 sr cm^{-1})",
                     name="At-sensor apparent spectral radiance"),
            "X": Var(out["X"], units="cm^{-1}", name="Wavenumbers"),
            "Ts_pix": Var(out["Ts_pix"], units="K",
                          name="Pixel surface temperature"),
            "mix_frac": Var(out["mix_frac"], units="none",
                            name="Material mixing fractions"),
            "emis_labels": Var(out["emis_labels"], units="none",
                               name="End-member indices"),
            "atmos_labels": Var(out["atmos_labels"], units="none",
                                name="Atmosphere indices"),
        })
        print(f"wrote {args.output}")


def run_emis(args, device, data=None) -> dict:
    """The emissivity DB build (``Generate_ASTER_emissivity_DB.py`` +
    ``Generate_Emissivity_DB.py``): ASTER exports (``--aster-dir``),
    spectra (``data``: NumPy ``X`` (nX,) and ``emis`` (n_mat, nX), the
    ``--input`` file's) or ``--n-materials`` synthetic ones; then
    ``--mixtures``, the ``--mako`` channels (clamped to [0, 1]) and the
    ``--features`` K compression (PCA, NMF from a generator on ``device``
    seeded by ``--seed``, B-splines). Returns ``db``, ``db_mako`` (or
    None), ``skipped`` files, ``n_base`` (the materials before mixing)
    and, with features, ``k``, ``err_pca``, ``nmf_shape``, ``err_spl``."""
    from ..scene.emissivity import (EmissivityDB, load_aster_dir,
                                    synthetic_db)

    device, dt = _scene_device(device)
    skipped = []
    if args.aster_dir:
        db, skipped = load_aster_dir(args.aster_dir,
                                     lambda_min_um=args.lambda_min,
                                     lambda_max_um=args.lambda_max,
                                     device=device)
    elif data is not None:
        X_in = as_numpy(data["X"])
        spectra = [(X_in, e) for e in as_numpy(data["emis"])]
        X_out = np.arange(np.ceil(X_in.min()), np.floor(X_in.max()) + 1.0)
        db = EmissivityDB.from_spectra(spectra, X_out,
                                       reflectance=args.reflectance,
                                       device=device)
    else:
        db = synthetic_db(args.n_materials, seed=args.seed, device=device)
    out = {"db": db, "db_mako": None, "skipped": skipped,
           "n_base": db.n_materials}
    if args.mixtures:
        db = out["db"] = db.pairwise_mixtures(n_fractions=args.n_fractions)
    if args.mako:
        from ..sensor.ils import ils_mako

        Xc, emis_c = ils_mako(db.X.cpu().numpy(), db.emis.T)
        out["db_mako"] = EmissivityDB(
            X=torch.as_tensor(Xc, dtype=db.X.dtype, device=db.X.device),
            emis=torch.clamp(emis_c.T, 0.0, 1.0),
            material_id=db.material_id, names=db.names)
    if args.features:
        from ..scene.emis_features import (bspline_fit_emissivity, nmf,
                                           od_transform, pca_compress)

        emis_t = db.emis.to(dt)                        # (n_mat, nX)
        clipped = torch.clamp(emis_t, 1e-4, 1 - 1e-4)
        k = min(args.features, db.n_materials - 1, int(db.X.numel()) - 1)
        _, _, recon = pca_compress(emis_t, n_components=k)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        m = nmf(od_transform(emis_t), n_components=k, generator=gen)
        fit = bspline_fit_emissivity(db.X.cpu().numpy(), emis_t.T,
                                     n_knots=min(48, int(db.X.numel()) // 4))
        out.update(
            k=k, err_pca=float(torch.abs(recon - clipped).max()),
            nmf_shape=tuple(m.H.shape),
            err_spl=float(torch.abs(fit.reconstruct().T - clipped).max()))
    return out


def cmd_emis(args):
    """The emissivity DB build, the JAX CLI's files: ``--output`` .npz,
    .h5 and .csv (and ``--output``_MAKO with ``--mako``)."""
    from ..scene.emissivity import save_db

    data = None
    if args.input and not args.aster_dir:
        with np.load(args.input) as f:
            data = {"X": np.asarray(f["X"]), "emis": np.asarray(f["emis"])}
    out = run_emis(args, args.device, data)
    db = out["db"]
    if out["skipped"]:
        print(f"skipped {len(out['skipped'])} export files (coverage "
              f"filter)")
    print(f"emissivity DB: {out['n_base']} materials x {db.X.numel()} "
          f"points")
    if args.mixtures:
        print(f"with pairwise mixtures: {db.n_materials} entries "
              f"({args.n_fractions} fractions)")
    if args.output:
        save_db(db, args.output)
        print(f"wrote {args.output}.npz/.h5/.csv")
    if out["db_mako"] is not None:
        print(f"MAKO-channelized: {out['db_mako'].n_materials} x "
              f"{out['db_mako'].X.numel()} channels")
        if args.output:
            save_db(out["db_mako"], args.output + "_MAKO")
            print(f"wrote {args.output}_MAKO.npz/.h5/.csv")
    if args.features:
        print(f"feature compression (k={out['k']}): PCA max err "
              f"{out['err_pca']:.2e}, NMF basis {out['nmf_shape']}, "
              f"B-spline max err {out['err_spl']:.2e}")


def atmosgen_ensemble(n: int, seed: int):
    """The stand-in ensemble of ``atmosgen`` without ``--input``: ``n``
    smooth perturbations of the 1976 StdAtmos T, H2O and O3 profiles
    (the JAX CLI's NumPy draws, so they are equal), NumPy (n, 66) each."""
    from ..atmos.profile import _std_atmos_table

    t = _std_atmos_table()
    z, T0, h2o, o3 = t[:, 1], t[:, 5], t[:, 6], t[:, 8]
    rng = np.random.default_rng(seed)
    zz = z / z.max()

    def perturb(base, scale):
        a = rng.normal(scale=scale, size=(n, 3))
        mod = (1.0 + a[:, :1] * np.exp(-zz * 4) + a[:, 1:2] * np.exp(-zz)
               + a[:, 2:] * zz)
        return base[None, :] * np.clip(mod, 0.3, 3.0)

    T = T0[None, :] * np.clip(
        1.0 + rng.normal(scale=0.02, size=(n, 1))
        * np.exp(-zz[None, :] * 3), 0.9, 1.1)
    return T, perturb(h2o, 0.3), perturb(o3, 0.2)


def run_atmosgen(args, device, data=None) -> dict:
    """Atmosphere-ensemble augmentation (``GenerativeModel_AtmosInputs.py``):
    air-mass clustering and a PCA+GMM model per air mass, on ``device``
    with a generator seeded by ``--seed``, in float64 on every device: the
    stand-in ensemble perturbs T by one amplitude, so its surface-T and
    lapse features are collinear and the fits' covariance prior is
    singular but for its 1e-6 regularisation, which float32 cannot resolve
    (in float32 the air-mass fit ends NaN, as JAX's does). ``data`` holds
    NumPy ``T``, ``H2O``, ``O3`` (n, 66) (the ``--input`` file's), else
    :func:`atmosgen_ensemble` of ``--n-ensemble`` members. Returns NumPy
    ``z``, ``P``, the inputs ``T_in``, ``H2O_in``, ``O3_in``, the
    generated ``T``, ``H2O``, ``O3``, ``airmass`` labels and ``loglik``,
    and ``n_air``."""
    from ..atmos.profile import _std_atmos_table
    from ..scene.generative import airmass_labels, gen_samples_per_airmass

    device, _ = _scene_device(device)
    dt = torch.float64
    t = _std_atmos_table()
    z, P = t[:, 1], t[:, 4]
    if data is not None:
        T, H2O, O3 = (as_numpy(data[k]) for k in ("T", "H2O", "O3"))
    else:
        T, H2O, O3 = atmosgen_ensemble(args.n_ensemble, args.seed)
    dev = lambda a: torch.as_tensor(a, dtype=dt, device=device)  # noqa
    Tt, Ht, Ot, zt, Pt = map(dev, (T, H2O, O3, z, P))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    n_air = min(args.n_airmass, T.shape[0])
    labels = airmass_labels(gen, zt, Pt, Tt, Ht, Ot, n_airmass=n_air)
    out = gen_samples_per_airmass(
        gen, zt, Pt, Tt, Ht, Ot, labels,
        n_pca=min(args.n_pca, T.shape[0] - 1, 3 * T.shape[1]),
        n_gmm=args.n_gmm, n_aug=args.n_aug)
    return {"z": z, "P": P, "T_in": T, "H2O_in": H2O, "O3_in": O3,
            "T": out["T"], "H2O": out["H2O"], "O3": out["O3"],
            "airmass": out["labels"], "loglik": out["ll"], "n_air": n_air}


def cmd_atmosgen(args):
    data = None
    if args.input:
        with np.load(args.input) as f:
            data = {k: np.asarray(f[k]) for k in ("T", "H2O", "O3")}
    out = run_atmosgen(args, args.device, data)
    print(f"augmented ensemble: {out['T_in'].shape[0]} -> "
          f"{out['T'].shape[0]} profiles ({out['n_air']} air masses, "
          f"x{args.n_aug} target)")
    if args.output:
        np.savez(args.output, **{k: out[k] for k in (
            "z", "P", "T", "H2O", "O3", "airmass", "loglik", "T_in",
            "H2O_in", "O3_in")})
        print(f"wrote {args.output}")


def _add_common(p):
    p.add_argument("--par", help="HITRAN .par line database")
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
                        "CUDA kernels (their plain versions on the CPU); "
                        "'jnp' runs the reference engine in plain PyTorch")


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
    p3.add_argument("--checkpoint", default=None,
                    help="directory of resumable per-batch checkpoints")
    p3.add_argument("--line-mixing", dest="line_mixing", action="store_true",
                    help="first-order Rosenkranz CO2 Q-branch line coupling")
    p3.add_argument("--mesh-spectrum", dest="mesh_spectrum", type=int,
                    default=1, help="spectral shards of the device mesh")
    p3.add_argument("--mesh-ensemble", dest="mesh_ensemble", type=int,
                    default=1, help="ensemble shards of the device mesh")
    p3.add_argument("--partition", default="weighted",
                    choices=["equal", "weighted"],
                    help="spectral-shard assignment of the --mesh-* path")
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

    p1 = sub.add_parser("planck", help="config 1: Planck sanity run")
    _add_common(p1)
    p1.set_defaults(fn=cmd_planck)

    def scene(name, help):
        q = sub.add_parser(name, help=help)
        q.add_argument("--output", default=None)
        q.add_argument("--device", default="cuda",
                       help="torch device the run uses (e.g. cuda, cpu)")
        return q

    p4 = scene("mako", "config 4: MAKO-channelized TUD")
    p4.add_argument("--input", required=True)
    p4.add_argument("--fwhm-sf", dest="fwhm_sf", type=float, default=1.0)
    p4.add_argument("--shift", type=float, default=0.0)
    p4.add_argument("--scale", type=float, default=1.0)
    p4.add_argument("--sort-atmos", dest="sort_atmos", action="store_true",
                    help="sort atmospheres by band-mean transmittance")
    p4.set_defaults(fn=cmd_mako)

    p6 = scene("radiance", "apparent-radiance ML dataset "
               "(Compute_LWIR_Apparent_Radiance path)")
    p6.add_argument("--input", required=True, help="TUD HDF5 from 'tud'")
    p6.add_argument("--seed", type=int, default=42)
    p6.add_argument("--n-materials", type=int, default=24)
    p6.add_argument("--dT-step", dest="dT_step", type=float, default=0.5)
    p6.set_defaults(fn=cmd_radiance)

    p5 = scene("hsi", "config 5: HSI radiance cubes")
    p5.add_argument("--input", required=True)
    p5.add_argument("--seed", type=int, default=0)
    p5.add_argument("--n-pixels", type=int, default=100)
    p5.add_argument("--n-materials", type=int, default=24)
    p5.add_argument("--n-emis", type=int, default=6)
    p5.add_argument("--n-mix", type=int, default=2)
    p5.add_argument("--n-atm", type=int, default=3)
    p5.add_argument("--dT", type=float, default=3.0)
    p5.set_defaults(fn=cmd_hsi)

    p7 = scene("emis", "emissivity DB build (ASTER-pipeline equivalent + "
               "mixtures + MAKO + features)")
    p7.add_argument("--input", default=None,
                    help="npz with X (nX,) and emis (n_mat, nX); default: "
                    "synthetic DB (ASTER 2.0 data is licensed)")
    p7.add_argument("--aster-dir", dest="aster_dir", default=None,
                    help="directory of ASTER/ECOSTRESS spectral-library "
                    "ASCII exports (Generate_ASTER_emissivity_DB.py:58-117)")
    p7.add_argument("--lambda-min", dest="lambda_min", type=float,
                    default=6.75, help="band lower edge [µm]")
    p7.add_argument("--lambda-max", dest="lambda_max", type=float,
                    default=14.5, help="band upper edge [µm]")
    p7.add_argument("--reflectance", action="store_true",
                    help="input spectra are reflectance (emis = 1 - R)")
    p7.add_argument("--n-materials", type=int, default=24)
    p7.add_argument("--mixtures", action="store_true",
                    help="add pairwise linear mixtures")
    p7.add_argument("--n-fractions", type=int, default=11)
    p7.add_argument("--mako", action="store_true",
                    help="also write a MAKO-channelized DB")
    p7.add_argument("--features", type=int, default=0, metavar="K",
                    help="run PCA/NMF/B-spline feature compression at K "
                    "components and report errors")
    p7.add_argument("--seed", type=int, default=0)
    p7.set_defaults(fn=cmd_emis)

    p8 = scene("atmosgen", "atmosphere-ensemble augmentation (PCA+GMM "
               "generative model, air-mass clustered)")
    p8.add_argument("--input", default=None,
                    help="npz with T/H2O/O3 (n, 66) profile ensembles; "
                    "default: perturbed 1976 StdAtmos ensemble")
    p8.add_argument("--n-ensemble", type=int, default=64)
    p8.add_argument("--n-airmass", type=int, default=5)
    p8.add_argument("--n-pca", type=int, default=15)
    p8.add_argument("--n-gmm", type=int, default=10)
    p8.add_argument("--n-aug", type=int, default=10)
    p8.add_argument("--seed", type=int, default=0)
    p8.set_defaults(fn=cmd_atmosgen)
    return p


def main(argv=None):
    from ..utils import enable_persistent_cache

    args = build_parser().parse_args(argv)
    enable_persistent_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
