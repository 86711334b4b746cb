"""This checkout's port against another checkout's, on one card, or its
kernels' IEEE instantiations against their FAST ones (the fast reciprocal).

    python3 kernel_ab.py --parent DIR [--out PATH] [--reps 5] [--rounds 1]
                         [--only SECTION,...]
    python3 kernel_ab.py --fast-ab [--out PATH] [--reps 5] [--rounds 1]
                         [--only SECTION,...]

Run from the repository root. ``DIR`` is another checkout (an unpacked
``git archive`` of an earlier commit). The measurements run in four
processes, in turns: the other checkout's, this one's, this one's, the
other's (``--rounds`` times). With ``--fast-ab`` all four are this
checkout's: the "other" side runs every builder with ``fast_rcp=False``
and every direct kernel call with ``fast=False`` (the IEEE
instantiations), "this" side with True (the FAST ones, the builders'
default), on the same inputs. Each process runs from its own checkout, imports that checkout's
``radtxfr_tpu_torch`` and ``chip_smoke.py`` (for the configurations),
builds that checkout's kernels there, and measures on inputs made from the
same seeds:

* the production member at full width, stage by stage as ``chip_smoke.py``
  phase 6 times it (line parameters, each K1 mode, the continuum, the OD,
  K2, the reduction, the member), and the plan build;
* every K1 pass of the differentiable OD builder (``full``), of the
  full-width XS lattice, of the HT lattice, and of the 1000-1010 cm^-1 XS
  builders (``lorentz``, ``doppler``, the correction passes and their
  ``*full`` variants), milliseconds summed per mode, with a SHA-256 of
  each output;
* K5 on every ``ht`` pass of the HT lattice (phase 9's) and of the
  layered HT OD (phase 9b's), and K6 on the ``ht`` passes of the HT
  Jacobian's builder (phase 9c's) for its batch of 8 one-hot T directions
  (``chip_smoke.ht_od_tangents``, ``one_hot_batch``), for one T
  direction over all layers (``linspace(0.5, 1.5)``) and for d OD / d
  T[3]'s direction, each with a SHA-256 of each output;
* K3 on every pass of the differentiable OD builder for the production
  Jacobian's batch (8 one-hot T directions, ``chip_smoke.one_hot_batch``)
  and for one T direction over all layers, and on the HT Jacobian's
  ``full`` passes for the one-hot batch (phase 9c's builder); K7 in each
  of its modes on ``make_od_plan``'s plan over phase 3e's 700-740 cm^-1
  sub-band and in ``full`` at full width (phase 11's plan and base
  state); each with a SHA-256 of each output;
* K4 on the HT Jacobian's ``sdvoigt`` passes (phase 9c's builder) for its
  one-hot batch, one T direction over all layers and d OD / d T[3]'s
  direction, and on the ``sdvoigt`` passes of the differentiable SD-Voigt
  OD at full width (phase 9d's) for its one-hot batch, each with a SHA-256
  of each output;
* K2 at the production shape in each mode the checkout has;
* d OD / d T[3] of the HT Jacobian (phase 9c's), over twice the calls;
* ``sharded``: K1 on the production member's passes, K3 on the
  Jacobian's one-hot batch and K4 on phase 9d's, each on plans of a grid
  padded for two spectral shards: unsharded (no tile offsets), with
  explicit zero offsets, and as the two shards with their tiles' offsets
  (the yardstick of the offset launch; a checkout whose plans take no
  offsets gives the unsharded launch only).

For the member, d OD / d T[3], K5's passes and the HT Jacobian's K3, K6
and K4 passes it also gives the milliseconds the card spends in kernels
during one call ("on the card": torch.profiler's CUDA kernel times,
summed; for a tangent pass its liveness table's reductions and the
kernel); the rest of a call's time the card waits on the host.

Each time is the median of ``--reps`` calls, each timed on its own with
CUDA events after a warm-up call. ``--only`` measures only the named
sections (``--help`` lists them): ``ht`` is d OD / d T[3], K3 and K6 of
the HT Jacobian, ``xs`` the full-width and sub-band XS lattices; the
others are named for their kernel or path.

It prints each number as other -> this (each the mean of its
processes), whether each kernel pass gave bit-identical outputs in all
four processes, and, given ``--out``, writes everything there as JSON with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile
import time


def events_ms(fn, reps):
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` calls, each
    timed on its own, after one warm-up; returns (ms, last result)."""
    import torch
    out = fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2], out


def device_ms(fn):
    """Milliseconds the card spends in kernels during one call of ``fn()``
    (the sum of torch.profiler's CUDA kernel times), or None where the
    profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages())
    return total / 1e3 or None


def digest(t):
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()


def child(out_path, reps, only=None, rcp=None):
    """Measure the checkout in the working directory (the sections
    ``only``, or all); write the JSON. ``rcp`` ("ieee" or "fast", with
    ``--fast-ab``) sets every builder's ``fast_rcp`` and every direct
    kernel call's ``fast``; None leaves the checkout's defaults (an older
    checkout's kernels take neither)."""
    sys.path[0] = os.getcwd()
    import numpy as np
    import torch

    import chip_smoke as cs
    from radtxfr_tpu_torch import _build
    from radtxfr_tpu_torch.atmos.profile import std_atmosphere
    from radtxfr_tpu_torch.core.constants import C1, C2
    from radtxfr_tpu_torch.core.grid import arange_drift_free
    from radtxfr_tpu_torch.kernels import fused_tud, fused_xsect
    from radtxfr_tpu_torch.kernels.linemixing_data import y_air_for_store
    from radtxfr_tpu_torch.lines.derived import derived_lwir_linelist
    from radtxfr_tpu_torch.lines.store import IsoTables
    from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
    from radtxfr_tpu_torch.products.od import (_line_species_cols,
                                               layer_line_params, make_ht_fn,
                                               make_od_fn, make_od_ht_fn,
                                               make_od_plan, make_xsect_fn)
    from radtxfr_tpu_torch.products.tud import (_layers_below,
                                                downwelling_quadrature,
                                                make_tud_fn)
    from radtxfr_tpu_torch.sensor.resolution import reduce_operator

    _build.library()
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    cs.warm_up(dev)
    res = {"ms": {}, "passes": {}}
    ms = res["ms"]
    want = lambda name: only is None or name in only  # noqa: E731
    # the builders' fast_rcp and the direct calls' fast, where asked
    bo = {} if rcp is None else {"fast_rcp": rcp == "fast"}
    ko = {} if rcp is None else {"fast": rcp == "fast"}

    def record(key, fn, card=False):
        """Time one kernel pass; its ms add up under ``key`` (``card``:
        also the card's kernel time of one call, ``device_ms``)."""
        t, out = events_ms(fn, reps)
        r = res["passes"].setdefault(key, {"ms": 0.0, "passes": 0,
                                           "sha": []})
        r["ms"] += t
        r["passes"] += 1
        r["sha"].append(digest(out))
        if card:
            r["card_ms"] = r.get("card_ms", 0.0) + (device_ms(fn) or 0.0)

    def k1(case, fn, prm, calls, Y=None):
        """K1's passes of ``calls``, and K5's (``ht``, also on the card)
        under their own key."""
        for call in calls:
            ht = call[2] == "ht"
            record(f"K5 {case}" if ht else f"K1 {case} {call[2]}",
                   lambda c=call, ht=ht: cs.ht_primal(c, prm, **ko) if ht
                   else fn.run_call(c, prm, Y), card=ht)

    iso = IsoTables.load(device=dev, dtype=f32)
    b64 = std_atmosphere(device=dev)
    if want("ht") or want("k4"):
        # d OD / d T[3] of the HT Jacobian (phase 9c), first: host-bound,
        # so measured before the rest of the process's allocations
        jac_store, extras = cs.ht_jac_case(dev)
        fn = make_od_ht_fn(jac_store, iso, arange_drift_free(*cs.HT_JAC_BAND),
                           b64, extras=extras, differentiable=True, **bo)
        e3 = torch.zeros_like(b64.T)
        e3[cs.HT_JAC_LAYER] = 1.0

        def jvp3():
            return torch.func.jvp(lambda T_: fn(T_, b64.p, b64.pl, b64.vmr),
                                  (b64.T,), (e3,))[1]

        if want("ht"):
            ms["ht jacobian dOD/dT[3]"], _ = events_ms(jvp3, 2 * reps)
            ms["ht jacobian dOD/dT[3] on the card"] = device_ms(jvp3)
        # K3, K6 and K4 on their passes for the batch of 8 one-hot T
        # directions; K6 and K4 also for one T direction over all layers
        # and for d OD / d T[3]'s direction
        hprm = fn.line_params(b64.T, b64.p, b64.pl, b64.vmr)
        htans = cs.ht_od_tangents(fn, b64, cs.one_hot_batch(dev))
        hdense = cs.ht_od_tangents(fn, b64, torch.linspace(
            0.5, 1.5, b64.n_layers, device=dev)[None])
        h3 = cs.ht_od_tangents(fn, b64, e3[None])
        kname = {"full": "K3", "ht": "K6", "sdvoigt": "K4"}
        for call in fn.calls:
            k = kname[call[2]]
            sets = {"one-hot": htans}
            if call[2] != "full":
                sets.update({"dense T": hdense, "dOD/dT[3]": h3})
            if want("k4" if k == "K4" else "ht"):
                for name, t in sets.items():
                    record(f"{k} ht jacobian {name}",
                           lambda c=call, t=t: cs.ht_tangent(c, hprm, t,
                                                             **ko),
                           card=True)
        del fn, jac_store, hprm, htans, hdense, h3

    if want("k4"):
        # K4 on the differentiable SD-Voigt OD's sdvoigt passes at full
        # width (phase 9d) for its batch of 8 one-hot T directions
        sd_store = synthetic_lines(cs.HT_LINES["n_lines"],
                                   nu_min=cs.HT_LINES["nu_min"],
                                   nu_max=cs.HT_LINES["nu_max"], seed=0,
                                   device=dev)
        sfn = make_od_fn(sd_store, iso, arange_drift_free(*cs.HT_BAND), b64,
                         profile="sdvoigt", differentiable=True, **bo)

        def sd_prm(T_):
            q = sfn.line_params(T_, b64.p, b64.pl, b64.vmr)[0]
            return q.shift0, q.strength, q.gamma_d, q.gamma_0, q.gamma_2

        sprm = sfn.line_params(b64.T, b64.p, b64.pl, b64.vmr)[0]
        stans = [t.contiguous() for t in torch.func.vmap(
            lambda v: torch.func.jvp(sd_prm, (b64.T,), (v,))[1])(
                cs.one_hot_batch(dev))]
        for call in sfn.calls:
            if call[2] == "sdvoigt":
                record("K4 sdvoigt od one-hot",
                       lambda c=call: cs.ht_tangent(c, sprm, stans, **ko),
                       card=True)
        del sfn, sd_store, sprm, stans

    if want("ht_layered"):
        # K5 on the layered HT OD's ht passes (phase 9b)
        lstore, lextras = cs.ht_layered_case(dev)
        lfn = make_od_ht_fn(lstore, iso, arange_drift_free(*cs.HT_BAND), b64,
                            extras=lextras, **bo)
        lprm = lfn.line_params(b64.T, b64.p, b64.pl, b64.vmr)
        k1("ht layered", lfn, lprm, [c for c in lfn.calls if c[2] == "ht"])
        del lfn, lstore, lprm

    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(*cs.FULL_BAND)
    T, p, pl, vmr = base.T, base.p, base.pl, base.vmr
    x = torch.as_tensor(X, dtype=f32, device=dev)
    if want("production") or want("jacobian") or want("k7") \
            or want("sharded"):
        store = derived_lwir_linelist(cs.FULL_BAND[0] - cs.MARGIN,
                                      cs.FULL_BAND[1] + cs.MARGIN,
                                      device=dev, dtype=f32)
    if want("production"):
        # the production member (phase 6)
        y = y_air_for_store(store.host_view())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        od_fn = make_od_fn(store, iso, X, base, continuum="mt_ckd",
                           line_mixing={"y_air": y}, **bo)
        torch.cuda.synchronize()
        ms["plan build"] = (time.perf_counter() - t0) * 1e3
        ms["line_params"], (prm, Y) = events_ms(
            lambda: od_fn.line_params(T, p, pl, vmr), reps)
        k1("production", od_fn, prm, od_fn.calls, Y)
        ms["continuum"], _ = events_ms(lambda: od_fn.cont(T, p, pl, vmr),
                                       reps)
        ms["od total"], od = events_ms(lambda: od_fn(T, p, pl, vmr), reps)
        tud_fn = make_tud_fn(base.z0.cpu().numpy(), cs.ALTITUDES, device=dev)
        ms["K2 tud"], tud = events_ms(lambda: tud_fn(x, od, T), reps)
        op = reduce_operator(X, 0.25, device=dev)
        ms["reduce"], _ = events_ms(lambda: (op(tud.tau[:, :, 0]),
                                             op(tud.Lu[:, :, 0]),
                                             op(tud.Ld)), reps)

        def member():
            t = tud_fn(x, od_fn(T, p, pl, vmr), T)
            return op(t.tau[:, :, 0]), op(t.Lu[:, :, 0]), op(t.Ld)

        ms["member"], _ = events_ms(member, reps)
        ms["member on the card"] = device_ms(member)
        del od_fn, od, tud, prm, Y

    if want("jacobian"):
        # the differentiable OD builder's full passes (the Jacobian path)
        # and K3 on them for the production batch (8 one-hot T directions)
        jac = make_od_fn(store, iso, X, base, continuum="mt_ckd",
                         differentiable=True, **bo)
        jprm = jac.line_params(T, p, pl, vmr)[0]
        k1("jacobian", jac, jprm, jac.calls)
        tans = [t.contiguous() for t in cs.t_tangents(
            jac, base, cs.one_hot_batch(dev))]
        dense = [t.contiguous() for t in cs.t_tangents(
            jac, base, torch.linspace(0.5, 1.5, base.n_layers,
                                      device=dev)[None])]
        for lay, dplan, _ in jac.calls:
            args = (dplan, lay, jprm.shift0, jprm.strength, jprm.gamma_d,
                    jprm.gamma_0, jprm.wing)
            record("K3 jacobian one-hot", lambda args=args:
                   fused_xsect.xsect_fused_jvp(*args, *tans, cs.N_WEI,
                                               **ko))
            record("K3 jacobian dense T", lambda args=args:
                   fused_xsect.xsect_fused_jvp(*args, *dense, cs.N_WEI,
                                               **ko))
        del jac, jprm, tans, dense

    if want("k7"):
        # K7: full at full width (phase 11), each mode on the sub-band (3e)
        cols = _line_species_cols(store.host_view(), base.mol_ids)
        plan = make_od_plan(store, iso, X, base)
        kprm = layer_line_params(store, iso, base, cols)
        record("K7 full width full",
               lambda: fused_xsect.xsect_unfused(plan, kprm, **ko))
        del plan, kprm
        sstore, siso, sX, sbase = cs.unfused_case(dev, cs.SUB_BAND)
        splan = make_od_plan(sstore, siso, sX, sbase)
        scols = _line_species_cols(sstore.host_view(), sbase.mol_ids)
        sprm = {m: layer_line_params(sstore, siso, sbase, scols, profile=m)
                for m in ("voigt", "lorentz", "doppler")}
        for m in fused_xsect.UNFUSED_MODES:
            record(f"K7 sub-band {m}", lambda m=m: fused_xsect.xsect_unfused(
                splan, sprm.get(m, sprm["voigt"]), m, **ko))
        del sstore, splan, sprm
    if want("sharded"):
        sharded_section(cs, record, store, iso, base, b64, dev, bo, ko)
    if want("production") or want("jacobian") or want("k7") \
            or want("sharded"):
        del store

    if want("k2"):
        # K2 at the production shape, in each mode this checkout has
        gen = torch.Generator(device=dev).manual_seed(0)
        od = 10.0 ** (5.0 * torch.rand((base.n_layers, X.size),
                                       generator=gen, device=dev,
                                       dtype=f32) - 4.0)
        inv_t = (1.0 / T).contiguous()
        mus = torch.ones(1, dtype=f32, device=dev)
        snap = torch.as_tensor(_layers_below(base.z0.cpu().numpy(),
                                             cs.ALTITUDES),
                               dtype=torch.int32, device=dev)
        sec, w = (torch.as_tensor(a, dtype=f32, device=dev)
                  for a in downwelling_quadrature(30))
        args = (od, x, inv_t, mus, snap, sec, w)
        ms["K2 planck"], _ = events_ms(lambda: fused_tud.tud_compose(*args),
                                       reps)
        if "B" in inspect.signature(fused_tud.tud_compose).parameters:
            nu = x * 100.0
            B = (((nu * nu * nu) * (C1 * 1e4))[None, :] / torch.expm1(
                (nu * C2)[None, :] * inv_t[:, None])).contiguous()
            ms["K2 B read"], _ = events_ms(
                lambda: fused_tud.tud_compose(*args, B=B), reps)
            del B
        del od, args

    Ts, ps = cs.xs_states(dev)
    if want("xs"):
        # the full-width XS lattice (the CLI's)
        a = cs.xs_args(cs.XS_CLI)
        xs_store = synthetic_lines(a.synthetic, nu_min=a.numin - cs.XS_WING,
                                   nu_max=a.numax + cs.XS_WING, seed=a.seed,
                                   device=dev)
        xs = make_xsect_fn(xs_store, iso,
                           arange_drift_free(a.numin, a.numax, a.dv),
                           cs.XS_T, np.ones_like(cs.XS_T), profile="sdvoigt",
                           wing_abs=cs.XS_WING, **bo)
        k1("xs lattice", xs, xs.line_params(Ts, ps), xs.all_calls())
        del xs, xs_store

        # the 1000-1010 cm^-1 XS builders (phase 3c)
        sub = cs.xs_lines(dev)
        Xs = arange_drift_free(*cs.XS_SUB)

        def build(**kw):
            return make_xsect_fn(sub, iso, Xs, cs.XS_T, np.ones_like(cs.XS_T),
                                 wing_abs=cs.XS_WING,
                                 tile=cs.XS_BENCH["tile"], **kw, **bo)

        main = build(profile="sdvoigt")
        full_calls = [(c[0], c[1], c[2] + "full")
                      for c in main.corr_calls[::3]]
        k1("xs sub-band", main, main.line_params(Ts, ps),
           main.all_calls() + full_calls)
        for prof in ("lorentz", "doppler"):
            fn = build(profile=prof)
            k1("xs sub-band", fn, fn.line_params(Ts, ps), fn.all_calls())
        del main, fn, sub

    if want("ht_lattice"):
        # the HT lattice (phase 8)
        ht_store, extras = cs.ht_lattice_case(dev)
        ht = make_ht_fn(ht_store, iso, arange_drift_free(*cs.HT_BAND),
                        cs.XS_T, np.ones_like(cs.XS_T), extras=extras, **bo)
        k1("ht lattice", ht, ht.line_params(Ts, ps), ht.all_calls())
        del ht, ht_store

    with open(out_path, "w") as f:
        json.dump(res, f)


def shard_variants(dplan, n_spec=2):
    """A padded-grid plan's launches for the ``sharded`` section: the
    unsharded call (no tile offsets), and, where the checkout's plans take
    offsets, the same call with explicit zero offsets and each of
    ``n_spec`` equal shards with its tiles' offsets (a tensor for every
    shard, so the kernel reads them); (label, plan) pairs."""
    import dataclasses

    import torch

    from radtxfr_tpu_torch.kernels import fused_xsect

    out = [("unsharded", dplan)]
    if "tile_off" not in {f.name for f in
                          dataclasses.fields(fused_xsect.DevicePlan)}:
        return out
    dev = dplan.starts.device
    nt = dplan.n_tiles // n_spec
    zeros = torch.zeros(dplan.n_tiles, dtype=torch.int32, device=dev)
    out.append(("zero offsets", dataclasses.replace(dplan, tile_off=zeros)))
    for s in range(n_spec):
        out.append(("shards", fused_xsect.shard_plan(
            dplan, starts=dplan.starts[s * nt:(s + 1) * nt],
            counts=dplan.counts[s * nt:(s + 1) * nt],
            k_offset=torch.full((nt,), s * nt * dplan.tile,
                                dtype=torch.int32, device=dev),
            n_tiles=nt, n_out=nt * dplan.tile)))
    return out


def sharded_section(cs, record, store, iso, base, b64, dev, bo, ko):
    """K1 (the production member's passes), K3 (the Jacobian's one-hot
    batch) and K4 (phase 9d's one-hot batch) on plans of a grid padded for
    2 spectral shards: unsharded, with zero offsets, and as the two shards
    with their offsets (their milliseconds summed under one key); ``bo``
    and ``ko`` the builders' and the direct calls' options (``child``)."""
    import torch

    from radtxfr_tpu_torch.core.grid import arange_drift_free
    from radtxfr_tpu_torch.kernels import fused_xsect
    from radtxfr_tpu_torch.kernels.fused_xsect import UniformGrid
    from radtxfr_tpu_torch.kernels.linemixing_data import y_air_for_store
    from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
    from radtxfr_tpu_torch.products.od import make_od_fn

    def padded(band):
        # make_od_local_fn's alignment for 2 shards: max(2 tile, tile,
        # 512) x 2 points at the default tile of 512
        g = UniformGrid.from_axis(arange_drift_free(*band))
        return UniformGrid(g.x0, g.dx, -(-g.n // 2048) * 2048)

    T, p, pl, vmr = base.T, base.p, base.pl, base.vmr
    g = padded(cs.FULL_BAND)
    od_fn = make_od_fn(store, iso, g, base, continuum="mt_ckd",
                       line_mixing={"y_air": y_air_for_store(
                           store.host_view())},
                       group_ratio=1.6, far_method="classic", **bo)
    prm, Y = od_fn.line_params(T, p, pl, vmr)
    for lay, dplan, mode in od_fn.calls:
        for label, plan in shard_variants(dplan):
            record(f"K1 sharded {mode} {label}", lambda c=(lay, plan, mode):
                   od_fn.run_call(c, prm, Y), card=True)
    del od_fn, prm, Y
    jac = make_od_fn(store, iso, g, base, continuum="mt_ckd",
                     differentiable=True, group_ratio=1.6,
                     far_method="classic", **bo)
    jprm = jac.line_params(T, p, pl, vmr)[0]
    tans = [t.contiguous() for t in cs.t_tangents(jac, base,
                                                   cs.one_hot_batch(dev))]
    for lay, dplan, _ in jac.calls:
        for label, plan in shard_variants(dplan):
            args = (plan, lay, jprm.shift0, jprm.strength, jprm.gamma_d,
                    jprm.gamma_0, jprm.wing)
            record(f"K3 sharded one-hot {label}", lambda args=args:
                   fused_xsect.xsect_fused_jvp(*args, *tans, cs.N_WEI,
                                               **ko),
                   card=True)
    del jac, jprm, tans
    sd_store = synthetic_lines(cs.HT_LINES["n_lines"],
                               nu_min=cs.HT_LINES["nu_min"],
                               nu_max=cs.HT_LINES["nu_max"], seed=0,
                               device=dev)
    sfn = make_od_fn(sd_store, iso, padded(cs.HT_BAND), b64,
                     profile="sdvoigt", differentiable=True, group_ratio=1.6,
                     **bo)

    def sd_prm(T_):
        q = sfn.line_params(T_, b64.p, b64.pl, b64.vmr)[0]
        return q.shift0, q.strength, q.gamma_d, q.gamma_0, q.gamma_2

    sprm = sfn.line_params(b64.T, b64.p, b64.pl, b64.vmr)[0]
    stans = [t.contiguous() for t in torch.func.vmap(
        lambda v: torch.func.jvp(sd_prm, (b64.T,), (v,))[1])(
            cs.one_hot_batch(dev))]
    for lay, dplan, mode in sfn.calls:
        if mode == "sdvoigt":
            for label, plan in shard_variants(dplan):
                record(f"K4 sharded one-hot {label}",
                       lambda c=(lay, plan, mode): cs.ht_tangent(
                           c, sprm, stans, **ko),
                       card=True)


# the sections ``--only`` takes: the names ``child`` asks ``want`` about
SECTIONS = tuple(dict.fromkeys(re.findall(r'want\("(\w+)"\)',
                                          inspect.getsource(child))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--fast-ab", action="store_true",
                    help="this checkout's IEEE instantiations (other) "
                    "against its FAST ones (this)")
    ap.add_argument("--rcp", choices=("ieee", "fast"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", help="write the results there as JSON")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the four processes this many times")
    ap.add_argument("--only", help="comma-separated sections to measure "
                    f"(of {', '.join(SECTIONS)}; default all)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    only = None if a.only is None else a.only.split(",")
    if only is not None and not set(only) <= set(SECTIONS):
        ap.error(f"--only: unknown section in {a.only!r}")
    if a.child:
        return child(a.child, a.reps, only, a.rcp)
    if not a.parent and not a.fast_ab:
        ap.error("--parent or --fast-ab is required")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"other": here if a.fast_ab else os.path.abspath(a.parent),
             "this": here}
    rcp = {"other": ["--rcp", "ieee"], "this": ["--rcp", "fast"]} \
        if a.fast_ab else {"other": [], "this": []}
    runs = {"other": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        order = ("other", "this", "this", "other") * a.rounds
        for i, who in enumerate(order):
            path = os.path.join(tmp, f"{i}.json")
            t0 = time.perf_counter()
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", path, "--reps", str(a.reps)]
                           + (["--only", a.only] if a.only else [])
                           + rcp[who],
                           cwd=trees[who], check=True)
            with open(path) as f:
                runs[who].append(json.load(f))
            print(f"[ab] {who} ({trees[who]}) measured in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    res = {"card": card, "other": ("IEEE instantiations (fast_rcp=False)"
                                   if a.fast_ab else trees["other"]),
           "this": ("FAST instantiations (fast_rcp=True)" if a.fast_ab
                    else "this checkout"),
           "runs": runs, "ms": {}, "passes": {}}

    def mean(vals):
        vals = [v for v in vals if v is not None]
        return sum(vals) / len(vals) if vals else None

    def fmt(vals):
        return " / ".join("-" if v is None else f"{v:.4f}" for v in vals)

    for key in runs["this"][0]["ms"]:
        per = {who: [r["ms"].get(key) for r in runs[who]] for who in runs}
        res["ms"][key] = {who: mean(v) for who, v in per.items()}
        print(f"[ab] {key}: {fmt([res['ms'][key]['other']])} -> "
              f"{fmt([res['ms'][key]['this']])} ms (each process: "
              f"{fmt(per['other'])} -> {fmt(per['this'])}) [{card}]",
              flush=True)
    for key in runs["this"][0]["passes"]:
        # a pass the other checkout does not have has no bit-identity
        # to report: None, printed "n/a (this side only)"
        shas = [r["passes"].get(key, {}).get("sha") for r in
                runs["other"] + runs["this"]]
        same = (None if None in shas
                else all(s == shas[0] for s in shas))
        o = mean(r["passes"].get(key, {}).get("ms") for r in runs["other"])
        t = mean(r["passes"][key]["ms"] for r in runs["this"])
        n = runs["this"][0]["passes"][key]["passes"]
        res["passes"][key] = {"other": o, "this": t, "identical": same,
                              "passes": n}
        on_card = ""
        if "card_ms" in runs["this"][0]["passes"][key]:
            oc, tc = (mean(r["passes"].get(key, {}).get("card_ms")
                           for r in runs[who]) for who in ("other", "this"))
            res["passes"][key].update(other_card=oc, this_card=tc)
            on_card = f" (on the card {fmt([oc])} -> {fmt([tc])})"
        print(f"[ab] {key} ({n} passes): {fmt([o])} -> {fmt([t])} ms"
              f"{on_card}, bit-identical "
              f"{'n/a (this side only)' if same is None else same} "
              f"[{card}]", flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
