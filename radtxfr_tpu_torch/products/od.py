"""Monochromatic optical depth of layered atmospheres (counterpart of
``radtxfr_tpu/products/od.py``: the production builder
``make_od_pallas_fn`` as :func:`make_od_fn`, with its static planning).

    OD_l(nu) = sum_lines u_l(mol(line)) S_line(T_l) profile(nu)

with u the species column density [molec/cm^2] of the layer.

The static work decomposition is the JAX package's, NumPy on the host:
layers grouped by wing bound, each line placed only in the nu-tiles its
own wing touches (packed plans), the Voigt lines split into a cheap
asymptotic far-wing pass over the whole window plus a narrow Weideman core
pass, and the line-mixing lines in a ``mix`` pass of their own. The plans
(and therefore the work) are identical to the JAX builder's; each pass is
one launch of the fused kernel K1 (:mod:`..kernels.fused_xsect`).

``differentiable=True`` builds the single-pass ``full`` plans instead (as
the JAX builder's ``two_pass=False``) and runs each pass through
:func:`~..kernels.fused_xsect.xsect_fused_diff`, so ``torch.func.jvp``
tangents of the OD go through the tangent kernel K3.

Not ported yet (each raises ``NotImplementedError``): the coarse-far
branch and SD-Voigt (ROADMAP M12), Hartmann-Tran (M13) and the pointwise
continuum models other than 'mt_ckd' (M4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.constants import (BARYE_PER_ATM, CM_PER_KM, C_LIGHT_CGS,
                              C_MASS_MOL, K_BOLTZMANN_CGS, PA_PER_ATM, T_REF)
from ..kernels.fused_xsect import (UniformGrid, device_plan,
                                   plan_buckets_packed, xsect_fused,
                                   xsect_fused_diff)
from ..kernels.lineparams import LineParams, compute_line_params
from ..kernels.linemixing import mixing_coefficient

__all__ = ["species_column", "make_od_fn", "OpticalDepthFn",
           "wing_bound_matrix", "core_wing_per_line", "core_y_matrix",
           "group_by_wing"]


def species_column(p_pa, T, pl_km, vmr):
    """Species column density [molec/cm^2] for a homogeneous layer."""
    p_barye = (p_pa / PA_PER_ATM) * BARYE_PER_ATM
    n_total = p_barye / (K_BOLTZMANN_CGS * T)  # [molec/cm^3]
    return vmr * n_total * pl_km * CM_PER_KM


def _line_species_cols(lines, mol_ids) -> np.ndarray:
    """Host-side: map each line's molecule id to its vmr column index."""
    lut = {m: i for i, m in enumerate(mol_ids)}
    line_mols = np.asarray(lines.mol_id)
    missing = set(np.unique(line_mols).tolist()) - set(lut)
    if missing:
        raise ValueError(f"lines contain molecules with no vmr column: "
                         f"{sorted(missing)}")
    return np.array([lut[int(m)] for m in line_mols], dtype=np.int64)


def _gd_coeff(lines, iso) -> np.ndarray:
    """Per-line Doppler-width coefficient: gamma_D = sqrt(T) * _gd_coeff."""
    nu0 = np.asarray(lines.nu0, dtype=np.float64)
    mass = np.asarray(iso.molar_mass)[np.asarray(lines.iso_row)]
    mass_g = mass * C_MASS_MOL * 1000.0
    return (np.sqrt(2.0 * K_BOLTZMANN_CGS * np.log(2.0) / mass_g)
            / C_LIGHT_CGS * nu0)


def wing_bound_matrix(lines, iso, atmos, wing_abs=0.0, wing_hw=50.0,
                      vmr_margin: float = 1.5) -> np.ndarray:
    """Host-side (nLay, nLines) upper bound on each line's wing cutoff.

    Replicates the wing rule of ``compute_line_params`` in NumPy to size the
    static bucketing; the self-broadening mix uses the state's vmr inflated
    by ``vmr_margin`` (``None`` for the fully conservative vmr = 1 bound).
    Runtime wings beyond the bound are clamped to it by the kernel.
    """
    nu0 = np.asarray(lines.nu0, dtype=np.float64)
    g_air = np.asarray(lines.gamma_air, dtype=np.float64)
    g_self = np.asarray(lines.gamma_self, dtype=np.float64)
    n_air = np.asarray(lines.n_air, dtype=np.float64)
    gd_coeff = _gd_coeff(lines, iso)

    T = np.asarray(atmos.T, dtype=np.float64)
    p_atm = np.asarray(atmos.p, dtype=np.float64) / PA_PER_ATM
    if vmr_margin is None:
        g_mix = np.broadcast_to(np.maximum(g_air, g_self), (T.size, nu0.size))
    else:
        cols = _line_species_cols(lines, atmos.mol_ids)
        x = np.asarray(atmos.vmr, dtype=np.float64)[:, cols]
        x = np.minimum(x * vmr_margin, 1.0)
        g_mix = g_air[None, :] * (1.0 - x) + g_self[None, :] * x
        g_mix = np.maximum(g_mix, g_air[None, :])  # n_self != n_air safety
    t_pow = (T_REF / T)[:, None] ** n_air[None, :]
    g0 = p_atm[:, None] * t_pow * g_mix
    gd = np.sqrt(T)[:, None] * gd_coeff[None, :]
    return np.maximum(wing_abs, wing_hw * np.maximum(g0, gd))


def core_wing_per_line(lines, iso, atmos) -> np.ndarray:
    """Per-line Weideman-core half-width bound (L,) [cm^-1]: the region
    |x| + y < 15 around the shifted centre plus the pressure-shift bound."""
    from ..kernels.faddeeva import REGION_BOUND

    t_max = float(np.asarray(atmos.T).max())
    gd_max = np.sqrt(t_max) * _gd_coeff(lines, iso)
    p_max = float(np.asarray(atmos.p).max()) / PA_PER_ATM
    shift_max = np.abs(np.asarray(lines.delta_air, dtype=np.float64)) * p_max
    return REGION_BOUND / np.sqrt(np.log(2.0)) * gd_max + shift_max


def core_y_matrix(lines, iso, atmos) -> np.ndarray:
    """Host-side (nLay, nLines) lower bound on the Voigt y parameter
    (a pair with y >= 15 has no Weideman core anywhere)."""
    g_lo = np.minimum(np.asarray(lines.gamma_air, dtype=np.float64),
                      np.asarray(lines.gamma_self, dtype=np.float64))
    n_air = np.asarray(lines.n_air, dtype=np.float64)
    gd_coeff = _gd_coeff(lines, iso)
    T = np.asarray(atmos.T, dtype=np.float64)
    p_atm = np.asarray(atmos.p, dtype=np.float64) / PA_PER_ATM
    t_pow = (T_REF / T)[:, None] ** n_air[None, :]
    g0 = p_atm[:, None] * t_pow * g_lo[None, :]
    gd = np.sqrt(T)[:, None] * gd_coeff[None, :]
    return np.sqrt(np.log(2.0)) * g0 / gd


def group_by_wing(wings: np.ndarray, max_groups: int = 4, ratio: float = 2.5):
    """Partition indices so each group's wings are within ``ratio`` of the
    group max (sorted descending, contiguous groups); list of
    (indices, group_max_wing)."""
    order = np.argsort(wings)[::-1]
    groups = []
    current = [order[0]]
    w_max = wings[order[0]]
    for idx in order[1:]:
        if wings[idx] * ratio < w_max and len(groups) < max_groups - 1:
            groups.append((np.array(current), float(w_max)))
            current, w_max = [idx], wings[idx]
        else:
            current.append(idx)
    groups.append((np.array(current), float(w_max)))
    return groups


def _pow2_tile(n: int, lo: int = 128, hi: int = 1024) -> int:
    """Round up to a power-of-two tile in [lo, hi]."""
    t = lo
    while t < n and t < hi:
        t *= 2
    return t


def _as_states(atmos_class):
    return (list(atmos_class) if isinstance(atmos_class, (list, tuple))
            else [atmos_class])


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def _host_planning_views(lines, iso, atmos_class):
    """Host NumPy views of everything static planning reads."""
    iso_h = dataclasses.replace(iso, **{f.name: _host(getattr(iso, f.name))
                                        for f in dataclasses.fields(iso)})
    states_h = [dataclasses.replace(s, **{
        f: _host(getattr(s, f)) for f in ("z0", "z1", "pl", "p", "T", "vmr")})
        for s in _as_states(atmos_class)]
    return lines.host_view(), iso_h, states_h


def _build_od_calls(lines, iso, atmos_class, g, wing_abs, wing_hw, max_groups,
                    tile, group_ratio, core_block=16, mix_idx=None,
                    two_pass: bool = True):
    """The static (layer-group x pass) call decomposition of the JAX
    builder's Voigt and line-mixing branches (``od.py:450-628`` there):
    a list of (layer indices, line indices, packed plan, mode).

    ``atmos_class`` may be one representative state or a list of envelope
    states; wing bounds are taken elementwise over all of them.
    ``two_pass=False`` gives each layer group one ``full`` pass over
    ``tile``-point tiles and no core passes.
    """
    from ..kernels.faddeeva import REGION_BOUND

    states = _as_states(atmos_class)
    W = np.max([wing_bound_matrix(lines, iso, s, wing_abs=wing_abs,
                                  wing_hw=wing_hw) for s in states], axis=0)
    nu0 = np.asarray(lines.nu0, dtype=np.float64)
    v_mask = np.ones(nu0.size, dtype=bool)
    calls = []

    if mix_idx is not None and len(mix_idx):
        # the mixing lines: one dense pass over each line's own window
        # (no exact cheap far-wing split applies to K + Y L)
        s_idx = np.sort(np.asarray(mix_idx, dtype=np.int64))
        v_mask[s_idx] = False
        W_s = W[:, s_idx]
        blk_cap = max(8, ((1 << 17) // tile) // 8 * 8)
        for lay_idx, _ in group_by_wing(W_s.max(axis=1), max_groups=max_groups,
                                        ratio=group_ratio):
            lay_idx = np.sort(lay_idx)
            w_line = W_s[lay_idx].max(axis=0)
            p = plan_buckets_packed(nu0[s_idx], g, w_line, tile=tile,
                                    block="auto")
            if p.block > blk_cap:
                p = plan_buckets_packed(nu0[s_idx], g, w_line, tile=tile,
                                        block=blk_cap)
            calls.append((lay_idx, s_idx, p, "mix"))

    v_idx = np.nonzero(v_mask)[0]
    if not v_idx.size:
        return calls
    nu0_v = nu0[v_idx]
    W_v = W[:, v_idx]
    lay_groups = group_by_wing(W_v.max(axis=1), max_groups=max_groups,
                               ratio=group_ratio)
    # the asym far-wing passes get twice the tile of the flop-heavy passes;
    # the block cap keeps block * tile <= 2**18 (the JAX builder's VMEM
    # guard, kept so both packages build identical plans)
    f_tile = 2 * tile if two_pass else tile
    f_cap = max(8, ((1 << 18) // f_tile) // 8 * 8)
    for lay_idx, _ in lay_groups:
        lay_idx = np.sort(lay_idx)
        w_line = W_v[lay_idx].max(axis=0)
        plan = plan_buckets_packed(nu0_v, g, w_line, tile=f_tile, block="auto")
        if plan.block > f_cap:
            plan = plan_buckets_packed(nu0_v, g, w_line, tile=f_tile,
                                       block=f_cap)
        calls.append((lay_idx, v_idx, plan,
                      "asym" if two_pass else "full"))
    if not two_pass:
        return calls

    # Core pass: the Weideman region exists only where y can drop below
    # hum1_wei's bound, so layer groups keep only lines whose y lower bound
    # is under it (with a 1.25 margin for runtime states), and adjacent
    # segments merge when the union costs less than a call's fixed overhead
    y_lo = np.min([core_y_matrix(lines, iso, s) for s in states],
                  axis=0)[:, v_idx]
    w_core_line = np.max([core_wing_per_line(lines, iso, s) for s in states],
                         axis=0)[v_idx]
    y_thresh = REGION_BOUND * 1.25
    ovh_pairs = 0.04 * W.shape[0] * nu0_v.size
    segs = []
    for lay_idx, _ in lay_groups:
        lay_idx = np.sort(lay_idx)
        m = (y_lo[lay_idx] < y_thresh).any(axis=0)
        if not m.any():
            continue
        if segs:
            p_idx, pm = segs[-1]
            um = pm | m
            uni = (len(p_idx) + len(lay_idx)) * int(um.sum())
            sep = len(p_idx) * int(pm.sum()) + len(lay_idx) * int(m.sum())
            if uni - sep <= ovh_pairs:
                segs[-1] = (np.concatenate([p_idx, lay_idx]), um)
                continue
        segs.append((lay_idx, m))
    for lay_idx, m in segs:
        cls_local = np.nonzero(m)[0]
        w_sub = w_core_line[cls_local]
        seg_tile = _pow2_tile(int(np.ceil(2.0 * float(w_sub.max()) / g.dx)),
                              lo=256, hi=min(512, max(256, tile)))
        core_plan = plan_buckets_packed(nu0_v[cls_local], g, w_sub,
                                        tile=seg_tile, block=core_block)
        calls.append((np.sort(lay_idx), v_idx[cls_local], core_plan, "core"))
    return calls


def _make_continuum_term(g, mol_ids, continuum, continuum_factors, device,
                         dtype):
    """Per-layer continuum-OD term fn(T, p_pa, pl, vmr) -> (nLay, nX), or
    None for ``continuum='none'``."""
    from ..atmos.continuum import (LAYERED_CONTINUUM_FACTORIES,
                                   check_h2o_table_coverage)

    if continuum == "none":
        return None
    factory = LAYERED_CONTINUUM_FACTORIES.get(continuum)
    if factory is None:
        raise NotImplementedError(
            f"continuum {continuum!r} is not ported: only 'mt_ckd' (the "
            "layered evaluator) is; the pointwise models are ROADMAP M4")
    check_h2o_table_coverage(g.x0, g.x0 + g.dx * (g.n - 1))
    cf = (torch.ones(7, dtype=dtype, device=device)
          if continuum_factors is None
          else torch.as_tensor(continuum_factors, dtype=dtype, device=device))
    if cf.shape != (7,):
        raise ValueError("continuum_factors must have 7 elements")
    layered = factory(g.values(), tuple(mol_ids), device=device, dtype=dtype)

    def term(T, p_pa, pl, vmr):
        return layered(T, p_pa, pl, vmr, cf).to(dtype)

    return term


class OpticalDepthFn:
    """``(T, p_pa, pl, vmr) -> (nLay, nX)`` layer OD with the static plans
    of one line list, grid and atmosphere class baked in (see
    :func:`make_od_fn`). ``calls`` lists the kernel passes as
    (layer indices int32, :class:`~..kernels.fused_xsect.DevicePlan`, mode).
    Every operation on the state is differentiable in forward mode; the
    ``full`` passes carry their tangents through K3.
    """

    def __init__(self, lines, iso, calls, cols, n_x, n_weideman, wing_abs,
                 wing_hw, line_mixing, cont):
        self.lines, self.iso = lines, iso
        self.calls = calls
        self.cols = cols
        self.n_x = n_x
        self.n_weideman = n_weideman
        self.wing_abs, self.wing_hw = wing_abs, wing_hw
        self.cont = cont
        dev, dt = lines.sw.device, lines.sw.dtype
        self.y_air = self.y_self = None
        self.n_T = 0.0
        if line_mixing is not None:
            self.y_air = torch.as_tensor(np.asarray(line_mixing["y_air"]),
                                         dtype=dt, device=dev)
            if line_mixing.get("y_self") is not None:
                self.y_self = torch.as_tensor(
                    np.asarray(line_mixing["y_self"]), dtype=dt, device=dev)
            self.n_T = float(line_mixing.get("n_T", 0.0))

    def line_params(self, T, p_pa, pl, vmr):
        """(nLay, L) Voigt parameters with the OD strength scaling, and the
        (nLay, L) mixing coefficients (None without line mixing)."""
        p_atm = p_pa / PA_PER_ATM
        u = species_column((p_atm * PA_PER_ATM)[:, None], T[:, None],
                           pl[:, None], vmr)
        x_self = vmr[:, self.cols]
        prm = compute_line_params(self.lines, self.iso, T[:, None],
                                  p_atm[:, None], vmr_self=x_self,
                                  wing_abs=self.wing_abs,
                                  wing_hw=self.wing_hw,
                                  strength_scale=u[:, self.cols])
        Y = None
        if self.y_air is not None:
            Y = mixing_coefficient(self.y_air, p_atm[:, None], T[:, None],
                                   y_self=self.y_self, x_self=x_self,
                                   n_T=self.n_T)
        return prm, Y

    def run_call(self, call, prm: LineParams, Y, kernel=xsect_fused):
        """One pass of ``calls``: (len(layers), nX) line OD; a ``full``
        pass goes through the differentiable call, unless ``kernel`` names
        another function (the plain version, in the checks)."""
        lay, dplan, mode = call
        if mode == "full" and kernel is xsect_fused:
            return xsect_fused_diff(dplan, lay, prm.shift0, prm.strength,
                                    prm.gamma_d, prm.gamma_0, prm.wing,
                                    self.n_weideman)
        return kernel(dplan, lay, prm.shift0, prm.strength, prm.gamma_d,
                      prm.gamma_0, prm.wing, Y if mode == "mix" else None,
                      mode, self.n_weideman)

    def __call__(self, T, p_pa, pl, vmr):
        prm, Y = self.line_params(T, p_pa, pl, vmr)
        out = torch.zeros((T.shape[0], self.n_x), dtype=prm.strength.dtype,
                          device=prm.strength.device)
        for call in self.calls:
            # each call's layers are distinct rows, so every element takes
            # one addition; in place, and it carries forward-mode tangents
            out.index_add_(0, call[0], self.run_call(call, prm, Y))
        if Y is not None:
            # first-order mixing can leave small negative excursions next
            # to a Q branch (a truncation artefact; LTE absorption is
            # nonnegative): clamp before the continuum, as the JAX builders
            out = torch.clamp(out, min=0.0)
        if self.cont is not None:
            out = out + self.cont(T, p_pa, pl, vmr)
        return out


def make_od_fn(lines, iso, grid, atmos_class, wing_abs=0.0, wing_hw=50.0,
               max_groups: int = 8, tile: int = 512, n_weideman: int = 16,
               group_ratio: float = 4.0, core_block: int = 16,
               continuum: str = "none", continuum_factors=None,
               line_mixing: dict | None = None, profile: str = "voigt",
               differentiable: bool = False) -> OpticalDepthFn:
    """Build the layer-OD function with static packed plans (the counterpart
    of ``make_od_pallas_fn``, with its defaults).

    ``lines``/``iso`` live on the device and in the dtype the OD is computed
    in (float32 launches the CUDA kernels on a card; CPU tensors run the
    plain versions, float32 or float64). ``grid`` is a uniform axis or a
    :class:`UniformGrid`; ``atmos_class`` one representative state (or a
    list of envelope states) sizing the plans. ``line_mixing`` carries
    ``y_air`` (and optionally ``y_self``, ``n_T``) for first-order mixing.
    ``differentiable=True`` builds single-pass ``full`` plans whose passes
    carry ``torch.func.jvp`` tangents through K3 (Voigt, no line mixing,
    as the JAX builder).
    """
    if profile != "voigt":
        raise NotImplementedError(
            f"profile {profile!r} is not ported: SD-Voigt is ROADMAP M12, "
            "Hartmann-Tran M13, Lorentz/Doppler M14")
    if differentiable and line_mixing is not None:
        # the JAX builder routes mixing Jacobians to its jnp engine
        raise NotImplementedError(
            "differentiable OD with line mixing: the differentiable kernels "
            "have no mixing tangent (the JAX package's mixing Jacobians ride "
            "its jnp engine, ROADMAP M11)")
    if wing_abs > 0.0 and line_mixing is None:
        # the JAX builder may route this case to its coarse-far branch
        raise NotImplementedError(
            "wing_abs > 0 without line mixing (the JAX builder's coarse-far "
            "branch, K1 corr:* modes) is ROADMAP M12")
    g = grid if isinstance(grid, UniformGrid) else UniformGrid.from_axis(
        np.asarray(grid))
    dev, dt = lines.sw.device, lines.sw.dtype
    mix_idx = None
    if line_mixing is not None:
        mix_idx = np.nonzero(np.asarray(line_mixing["y_air"]) != 0.0)[0]
    lines_h, iso_h, states_h = _host_planning_views(lines, iso, atmos_class)
    mol_ids = tuple(states_h[0].mol_ids)
    cols = torch.as_tensor(_line_species_cols(lines_h, mol_ids), device=dev)
    calls = [
        (torch.as_tensor(lay, dtype=torch.int32, device=dev),
         device_plan(plan, line_idx, lines_h.nu0, device=dev, dtype=dt), mode)
        for lay, line_idx, plan, mode in _build_od_calls(
            lines_h, iso_h, states_h, g, wing_abs, wing_hw, max_groups, tile,
            group_ratio, core_block=core_block, mix_idx=mix_idx,
            two_pass=not differentiable)]
    cont = _make_continuum_term(g, mol_ids, continuum, continuum_factors,
                                dev, dt)
    return OpticalDepthFn(lines, iso, calls, cols, g.n, n_weideman, wing_abs,
                          wing_hw, line_mixing, cont)
