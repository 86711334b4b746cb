"""Monochromatic optical depth of layered atmospheres and cross-section
lattices (counterpart of ``radtxfr_tpu/products/od.py``: the builders
``make_od_pallas_fn`` as :func:`make_od_fn` and ``make_xsect_pallas_fn`` as
:func:`make_xsect_fn`, with their static planning, and
:func:`compute_od_layers`).

    OD_l(nu) = sum_lines u_l(mol(line)) S_line(T_l) profile(nu)

with u the species column density [molec/cm^2] of the layer (a lattice's
cross-sections: u = 1, the states as layers).

The static work decomposition is the JAX package's, NumPy on the host:
layers grouped by wing bound, each line placed only in the nu-tiles its
own wing touches (packed plans), the Voigt lines split into a cheap
asymptotic far-wing pass over the whole window plus a narrow Weideman core
pass, the SD-Voigt lines likewise (``sdvoigt_asym`` + ``sdvoigt_core``),
the line-mixing lines in a ``mix`` pass of their own and the Lorentz and
Doppler profiles in single passes. Statically exact absolute wings
(``wing_abs`` dominating every halfwidth wing) take the coarse-far route:
the far field on an R-times coarser grid, a cubic upsample, and correction
passes ``corr:R:*`` near line centres and window edges, beside the classic
core passes. The plans (and therefore the work) are identical to the JAX
builders'; each pass is one launch of the fused kernel K1
(:mod:`..kernels.fused_xsect`).

``differentiable=True`` builds the single-pass ``full`` (and, for
``profile='sdvoigt'``, ``sdvoigt``) plans instead (as the JAX builder's
``two_pass=False``) and runs each pass through
:func:`~..kernels.fused_xsect.xsect_fused_diff` or
:func:`~..kernels.fused_xsect.xsect_fused_sdvoigt_diff`, so
``torch.func.jvp`` tangents of the OD go through the tangent kernels K3 and
K4.

``fast_rcp`` (True by default, as in JAX's builders) runs every kernel a
builder launches in its FAST instantiation, the TPU kernels' approximate
reciprocal plus one Newton step at the line shapes' reciprocals (K1, K3,
K4, K5; K6 divides in IEEE, as JAX's tangent kernel); the plain versions
that CPU tensors run divide in IEEE either way, as JAX's interpret mode.
``compute_od_layers(engine='pallas', plan=...)`` takes it as an evaluation
option for K7 (False unless given, as ``xsect_pallas``).

:func:`make_od_local_fn` (``make_od_pallas_local_fn`` there) is the
spectrum-sharded builder: the same plans on a grid padded so that no tile
straddles a shard, each shard running its slice of the tiles (contiguous,
or dealt by op-weighted work) at their global grid offsets
(:class:`LocalOpticalDepthFn`, :class:`ShardOD`); the sharded ensemble and
Jacobian builders of :mod:`..dist.fused_ensemble` run it per mesh entry.

The Hartmann-Tran builders :func:`make_ht_fn` (a (T, p) lattice,
``make_ht_pallas_fn``) and :func:`make_od_ht_fn` (a layered atmosphere,
``make_od_ht_pallas_fn``) resolve the HT columns with hapi's fallbacks and
route each line by its resolved columns: live eta/nuVC/Shift2 to the HT
kernel K5 (:mod:`..kernels.fused_ht`; K6 for its tangents), Gamma2 != 0 to
K1 ``sdvoigt``, the rest to K1 ``full`` (pcqsdhc's exact degenerations);
on the lattice the two cheap subsets take the coarse-far route where the
absolute wing allows it.

The layered-OD library API, :func:`compute_od_layers` (the README's quick
start), routes as the JAX function does: ``engine='pallas'`` with a
prebuilt :func:`make_od_plan` (a shared-block plan, reused over an
ensemble) runs :func:`layer_line_params` and the unfused kernel K7
(:func:`~..kernels.fused_xsect.xsect_unfused`); without a plan the
builders above; any other engine the reference engine layer by layer
(:func:`compute_od_layer` for Voigt, SD-Voigt, Lorentz and Doppler;
:func:`~..kernels.ht_driver.ht_xsect_from_params` for HT). Its continuum
is the pointwise :func:`~..atmos.continuum.continuum_od`.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from .. import arrays_on, as_numpy
from ..core.constants import (BARYE_PER_ATM, CM_PER_KM, C_LIGHT_CGS,
                              C_MASS_MOL, K_BOLTZMANN_CGS, P_REF, PA_PER_ATM,
                              T_REF)
from ..atmos.profile import AtmosphericState
from ..kernels.fused_ht import xsect_ht_diff, xsect_ht_plain
from ..kernels.fused_xsect import (BucketPlan, UniformGrid,
                                   corr_r_supported, cubic_weights,
                                   _ops_per_eval, device_plan, is_sd_mode,
                                   plan_buckets, plan_buckets_packed,
                                   plan_executed_evals, shard_plan,
                                   xsect_fused,
                                   xsect_fused_diff, xsect_fused_sdvoigt_diff,
                                   xsect_unfused)
from ..kernels.ht_driver import (_complex_of, ht_params,
                                 ht_xsect_from_params, resolve_ht_columns)
from ..kernels.htp_real import HT_CONST_KEYS, ht_line_constants
from ..kernels.lineparams import LineParams, compute_line_params
from ..kernels.linemixing import mixing_coefficient, xsect_voigt_mixing
from ..kernels.xsect import xsect_from_params
from ..utils.profiling import span

__all__ = ["species_column", "compute_od_layer", "compute_od_layers",
           "layer_line_params", "max_wing_per_layer", "max_wing_bound",
           "make_od_plan", "make_od_fn", "OpticalDepthFn", "make_od_local_fn",
           "LocalOpticalDepthFn", "ShardOD", "shard_slice", "make_xsect_fn",
           "CrossSectionFn", "wing_bound_matrix", "core_wing_per_line",
           "core_y_matrix", "sdvoigt_core_bound", "group_by_wing",
           "group_layers_by_wing",
           "ht_wing_bounds", "make_ht_fn", "make_od_ht_fn",
           "HTCrossSectionFn", "HTOpticalDepthFn"]

def species_column(p_pa, T, pl_km, vmr, device=None):
    """Species column density [molec/cm^2] for a homogeneous layer; NumPy
    arguments join a tensor argument's device, else ``device`` (None: the
    card)."""
    p_pa, T, pl_km, vmr = arrays_on(p_pa, T, pl_km, vmr, device=device)
    p_barye = (p_pa / PA_PER_ATM) * BARYE_PER_ATM
    n_total = p_barye / (K_BOLTZMANN_CGS * T)  # [molec/cm^3]
    return vmr * n_total * pl_km * CM_PER_KM


def _line_species_cols(lines, mol_ids) -> np.ndarray:
    """Host-side: map each line's molecule id to its vmr column index."""
    lut = {m: i for i, m in enumerate(mol_ids)}
    line_mols = as_numpy(lines.mol_id)
    missing = set(np.unique(line_mols).tolist()) - set(lut)
    if missing:
        raise ValueError(f"lines contain molecules with no vmr column: "
                         f"{sorted(missing)}")
    return np.array([lut[int(m)] for m in line_mols], dtype=np.int64)


def _gd_coeff(lines, iso) -> np.ndarray:
    """Per-line Doppler-width coefficient: gamma_D = sqrt(T) * _gd_coeff."""
    nu0 = as_numpy(lines.nu0, np.float64)
    mass = as_numpy(iso.molar_mass)[as_numpy(lines.iso_row)]
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
    nu0 = as_numpy(lines.nu0, np.float64)
    g_air = as_numpy(lines.gamma_air, np.float64)
    g_self = as_numpy(lines.gamma_self, np.float64)
    n_air = as_numpy(lines.n_air, np.float64)
    gd_coeff = _gd_coeff(lines, iso)

    T = as_numpy(atmos.T, np.float64)
    p_atm = as_numpy(atmos.p, np.float64) / PA_PER_ATM
    if vmr_margin is None:
        g_mix = np.broadcast_to(np.maximum(g_air, g_self), (T.size, nu0.size))
    else:
        cols = _line_species_cols(lines, atmos.mol_ids)
        x = as_numpy(atmos.vmr, np.float64)[:, cols]
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

    t_max = float(as_numpy(atmos.T).max())
    gd_max = np.sqrt(t_max) * _gd_coeff(lines, iso)
    p_max = float(as_numpy(atmos.p).max()) / PA_PER_ATM
    shift_max = np.abs(as_numpy(lines.delta_air, np.float64)) * p_max
    return REGION_BOUND / np.sqrt(np.log(2.0)) * gd_max + shift_max


def core_y_matrix(lines, iso, atmos) -> np.ndarray:
    """Host-side (nLay, nLines) lower bound on the Voigt y parameter
    (a pair with y >= 15 has no Weideman core anywhere)."""
    g_lo = np.minimum(as_numpy(lines.gamma_air, np.float64),
                      as_numpy(lines.gamma_self, np.float64))
    n_air = as_numpy(lines.n_air, np.float64)
    gd_coeff = _gd_coeff(lines, iso)
    T = as_numpy(atmos.T, np.float64)
    p_atm = as_numpy(atmos.p, np.float64) / PA_PER_ATM
    t_pow = (T_REF / T)[:, None] ** n_air[None, :]
    g0 = p_atm[:, None] * t_pow * g_lo[None, :]
    gd = np.sqrt(T)[:, None] * gd_coeff[None, :]
    return np.sqrt(np.log(2.0)) * g0 / gd


def sdvoigt_core_bound(lines, iso, atmos, margin: float = 1.15) -> np.ndarray:
    """Host-side (nLay, L) upper bound on the SD-Voigt core half-width.

    Outside |dnu| >= |delta p| + Gamma2 (2c^2 + 30c + 225) both pcqsdhc CPF
    points have |Z| >= 15, in hum1_wei's asymptotic region and past the
    CPF3 sub-case, so the double-asymptotic ``sdvoigt_asym`` pass is exact
    there; c = Gamma_D / (2 sqrt(ln2) Gamma2) at the nominal and at half
    the nominal Gamma2 (the self-diluent mix shrinks it), the larger bound
    kept; ``margin`` pads for states moderately outside the envelope.
    """
    sd = as_numpy(lines.sd_air, np.float64)
    ga = as_numpy(lines.gamma_air, np.float64)
    p_atm = as_numpy(atmos.p, np.float64)[:, None] / PA_PER_ATM
    g2_nom = np.maximum(sd * ga, 1e-30)[None, :] * p_atm
    k = (np.sqrt(as_numpy(atmos.T, np.float64))[:, None]
         * _gd_coeff(lines, iso)[None, :]) / (2.0 * np.sqrt(np.log(2.0)))

    def radius(g2):
        c = k / g2
        return g2 * (2.0 * c * c + 30.0 * c + 225.0)

    b = np.maximum(radius(g2_nom), radius(0.5 * g2_nom))
    shift = (np.abs(as_numpy(lines.delta_air, np.float64))[None, :]
             * p_atm)
    return margin * (shift + b)


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


def _layer_params(lines, iso, T, p_pa, pl, vmr, cols, wing_abs, wing_hw,
                  profile):
    """(nLay, L) line parameters of every layer with the OD strength
    scaling (species column x path), the counterpart of ``vmap`` over
    ``compute_line_params`` in ``layer_line_params``; ``cols`` (L,) long
    maps each line to its vmr column."""
    p_atm = p_pa / PA_PER_ATM
    u = species_column((p_atm * PA_PER_ATM)[:, None], T[:, None],
                       pl[:, None], vmr)
    return compute_line_params(lines, iso, T[:, None], p_atm[:, None],
                               vmr_self=vmr[:, cols], wing_abs=wing_abs,
                               wing_hw=wing_hw, strength_scale=u[:, cols],
                               profile=profile)


def layer_line_params(lines, iso, atmos, species_cols, wing_abs=0.0,
                      wing_hw=50.0, profile="voigt") -> LineParams:
    """:class:`LineParams` with (n_layers, n_lines) tensors whose
    ``strength`` includes the species column density x path length, on the
    device and in the dtype of ``lines``; ``species_cols`` maps each line to
    its vmr column (:func:`_line_species_cols`)."""
    cols = torch.as_tensor(as_numpy(species_cols), dtype=torch.long,
                           device=lines.sw.device)
    return _layer_params(lines, iso, atmos.T, atmos.p, atmos.pl, atmos.vmr,
                         cols, wing_abs, wing_hw, profile)


def max_wing_per_layer(lines, iso, atmos, wing_abs=0.0,
                       wing_hw=50.0) -> np.ndarray:
    """Host-side per-layer upper bound on line wing cutoffs (nL,)
    [cm^-1]."""
    lines_h, iso_h, (atmos_h,) = _host_planning_views(lines, iso, atmos)
    return wing_bound_matrix(lines_h, iso_h, atmos_h, wing_abs,
                             wing_hw).max(axis=1)


def max_wing_bound(lines, iso, atmos, wing_abs=0.0, wing_hw=50.0) -> float:
    """Host-side upper bound on every line's wing over all layers."""
    return float(max_wing_per_layer(lines, iso, atmos, wing_abs,
                                    wing_hw).max())


#: the JAX package's older name of :func:`group_by_wing`
group_layers_by_wing = group_by_wing


def _uniform_grid(grid) -> UniformGrid:
    return (grid if isinstance(grid, UniformGrid)
            else UniformGrid.from_axis(grid))


def make_od_plan(lines, iso, grid, atmos, wing_abs=0.0, wing_hw=50.0,
                 tile: int = 1024, block: int = 256) -> BucketPlan:
    """The static shared-block plan (:func:`plan_buckets`) of one line
    list, grid and atmosphere class, built once and reused over an
    ensemble by ``compute_od_layers(engine='pallas', plan=...)``: every
    line's wing bounded by :func:`max_wing_bound` of ``atmos``."""
    mw = max_wing_bound(lines, iso, atmos, wing_abs=wing_abs,
                        wing_hw=wing_hw)
    return plan_buckets(lines.host_view().nu0, _uniform_grid(grid), mw,
                        tile=tile, block=block)


def _pow2_tile(n: int, lo: int = 128, hi: int = 1024) -> int:
    """Round up to a power-of-two tile in [lo, hi]."""
    t = lo
    while t < n and t < hi:
        t *= 2
    return t


def _as_states(atmos_class):
    return (list(atmos_class) if isinstance(atmos_class, (list, tuple))
            else [atmos_class])


def _host_planning_views(lines, iso, atmos_class):
    """Host NumPy views of everything static planning reads."""
    iso_h = dataclasses.replace(iso, **{
        f.name: as_numpy(getattr(iso, f.name))
        for f in dataclasses.fields(iso)})
    states_h = [dataclasses.replace(s, **{
        f: as_numpy(getattr(s, f))
        for f in ("z0", "z1", "pl", "p", "T", "vmr")})
        for s in _as_states(atmos_class)]
    return lines.host_view(), iso_h, states_h


def _build_od_calls(lines, iso, atmos_class, g, wing_abs, wing_hw, max_groups,
                    tile, group_ratio, core_block=16, mix_idx=None,
                    two_pass: bool = True, profile: str = "voigt",
                    wing_passes: bool = True, far_tile=None, far_block=None,
                    core_tile=None):
    """The static (layer-group x pass) call decomposition of the JAX
    builders (``od.py:450-628`` there): a list of (layer indices, line
    indices, packed plan, mode).

    ``atmos_class`` may be one representative state or a list of envelope
    states; wing bounds are taken elementwise over all of them.
    ``profile='sdvoigt'`` gives the lines with ``sd_air != 0`` SD-Voigt
    passes (``sdvoigt_asym`` over the windows plus ``sdvoigt_core`` within
    :func:`sdvoigt_core_bound`, or one ``sdvoigt`` pass without
    ``two_pass``) and the rest the Voigt passes; 'lorentz' and 'doppler'
    one dense pass each. ``two_pass=False`` gives each Voigt layer group one
    ``full`` pass over ``tile``-point tiles and no core passes.
    ``wing_passes=False`` plans the core passes only (the coarse-far route
    replaces the window passes; the JAX builders plan and then drop them).
    ``far_tile``/``far_block`` size the Voigt window passes (default
    ``2 * tile`` with ``two_pass``, else ``tile``, and a block capped at
    ``block * tile <= 2**18``; a given block is not capped) and
    ``core_tile`` the Voigt core passes (default: the power of two in
    [256, 512] that spans a segment's widest core), as JAX's.
    """
    from ..kernels.faddeeva import REGION_BOUND

    states = _as_states(atmos_class)
    W = np.max([wing_bound_matrix(lines, iso, s, wing_abs=wing_abs,
                                  wing_hw=wing_hw) for s in states], axis=0)
    nu0 = np.asarray(lines.nu0, dtype=np.float64)
    if profile == "sdvoigt":
        sd_mask = np.asarray(lines.sd_air, dtype=np.float64) != 0.0
        special = [(np.nonzero(sd_mask)[0], "sdvoigt")]
        v_mask = ~sd_mask
    elif profile == "voigt":
        special = []
        v_mask = np.ones(nu0.size, dtype=bool)
    elif profile in ("lorentz", "doppler"):
        # single dense passes: both forms are a handful of operations
        special = [(np.arange(nu0.size), profile)]
        v_mask = np.zeros(nu0.size, dtype=bool)
    else:
        raise NotImplementedError(
            f"profile {profile!r}: these builders implement 'voigt', "
            "'sdvoigt', 'lorentz' and 'doppler'; Hartmann-Tran is built by "
            "make_ht_fn and make_od_ht_fn")
    if mix_idx is not None and len(mix_idx):
        if profile != "voigt":
            raise NotImplementedError("line mixing composes with Voigt only")
        mix_idx = np.sort(np.asarray(mix_idx, dtype=np.int64))
        special.append((mix_idx, "mix"))
        v_mask[mix_idx] = False
    calls = []

    for s_idx, s_mode in special:
        if not s_idx.size:
            continue
        # the special lines: dense passes over each line's own window; the
        # block cap keeps block * tile <= 2**17 (the JAX builder's VMEM
        # guard, kept so both packages build identical plans)
        W_s = W[:, s_idx]
        blk_cap = max(8, ((1 << 17) // tile) // 8 * 8)
        sd_split = two_pass and s_mode == "sdvoigt"
        if sd_split:
            B_core = np.max([sdvoigt_core_bound(lines, iso, s)
                             for s in states], axis=0)[:, s_idx]
        for lay_idx, _ in group_by_wing(W_s.max(axis=1), max_groups=max_groups,
                                        ratio=group_ratio):
            lay_idx = np.sort(lay_idx)
            w_line = W_s[lay_idx].max(axis=0)

            def packed(w, t, blk):
                p = plan_buckets_packed(nu0[s_idx], g, w, tile=t, block=blk)
                if blk == "auto" and p.block > blk_cap:
                    p = plan_buckets_packed(nu0[s_idx], g, w, tile=t,
                                            block=blk_cap)
                return p

            if sd_split:
                if wing_passes:
                    calls.append((lay_idx, s_idx,
                                  packed(w_line, tile, "auto"),
                                  "sdvoigt_asym"))
                w_core = np.minimum(w_line, B_core[lay_idx].max(axis=0))
                c_tile = _pow2_tile(int(np.ceil(2.0 * w_core.max() / g.dx)),
                                    lo=256, hi=min(512, max(256, tile)))
                # the SD core keeps half the Voigt core's block, as JAX
                calls.append((lay_idx, s_idx,
                              packed(w_core, c_tile, max(8, core_block // 2)),
                              "sdvoigt_core"))
            elif wing_passes:
                calls.append((lay_idx, s_idx, packed(w_line, tile, "auto"),
                              s_mode))

    v_idx = np.nonzero(v_mask)[0]
    if not v_idx.size:
        return calls
    nu0_v = nu0[v_idx]
    W_v = W[:, v_idx]
    lay_groups = group_by_wing(W_v.max(axis=1), max_groups=max_groups,
                               ratio=group_ratio)
    # the asym far-wing passes get twice the tile of the flop-heavy passes;
    # the block cap keeps block * tile <= 2**18
    f_tile = far_tile or (2 * tile if two_pass else tile)
    f_block = far_block or "auto"
    f_cap = max(8, ((1 << 18) // f_tile) // 8 * 8)
    for lay_idx, _ in (lay_groups if wing_passes else []):
        lay_idx = np.sort(lay_idx)
        w_line = W_v[lay_idx].max(axis=0)
        plan = plan_buckets_packed(nu0_v, g, w_line, tile=f_tile,
                                   block=f_block)
        if f_block == "auto" and plan.block > f_cap:
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
        seg_tile = core_tile or _pow2_tile(
            int(np.ceil(2.0 * float(w_sub.max()) / g.dx)),
            lo=256, hi=min(512, max(256, tile)))
        core_plan = plan_buckets_packed(nu0_v[cls_local], g, w_sub,
                                        tile=seg_tile, block=core_block)
        calls.append((np.sort(lay_idx), v_idx[cls_local], core_plan, "core"))
    return calls


def _coarse_near_width(coarse_r, dx, near_width):
    """Near-zone half-width of the coarse-far scheme: the cubic upsample of
    a smooth 1/d^2-class wing errs by ~2.8 (R dx / d)^4 of the local wing
    value, so d >= 41 R dx keeps it under 1e-6 per line."""
    return max(float(near_width), 41.0 * int(coarse_r) * dx)


def _coarse_far_min_wing(g, coarse_r, near_width, tile_corr=512):
    """Smallest statically safe ``wing_abs`` for the coarse-far scheme: a
    line's near-zone plan and its window-edge band plans (the cubic
    stencil's (2R + 2) dx reach about nu0 +- wing_abs) must never share a
    ``tile_corr`` tile, or the correction (masked only by the true window)
    would apply twice there."""
    R = int(coarse_r)
    nw = _coarse_near_width(R, g.dx, near_width)
    return nw + (2 * R + 2 + int(tile_corr) + 4) * g.dx


def _coarse_tile_corr(g, coarse_r, near_width, wing_abs,
                      lo: int = 512, hi: int = 2048) -> int:
    """The widest power-of-two correction tile (a multiple of R) whose
    near/edge disjointness bound still clears ``wing_abs``, floored at
    ``lo`` (eligibility itself is checked by the builders at ``lo``)."""
    tc = hi
    while tc > lo and (tc % int(coarse_r)
                       or _coarse_far_min_wing(g, coarse_r, near_width,
                                               tile_corr=tc)
                       > float(wing_abs)):
        tc //= 2
    return max(tc, lo)


def _coarse_upsample(out_c, n_fine, R):
    """Uniform 4-point Lagrange-cubic upsample of the coarse far field
    (nLay, n_coarse), column 0 one coarse step left of the fine origin:
    fine point i in segment j = i // R interpolates columns j .. j+3 with
    the weights the correction passes subtract (a float32 gather and
    multiply-adds, not a matrix product)."""
    j, (wm1, w0, w1, w2) = cubic_weights(n_fine, R, out_c.dtype,
                                         out_c.device)
    return (out_c[:, j] * wm1 + out_c[:, j + 1] * w0
            + out_c[:, j + 2] * w1 + out_c[:, j + 3] * w2)


def _build_coarse_far_calls(lines_h, g, wing_abs, profile, coarse_r,
                            near_width, tile_coarse, tile_corr,
                            subsets=None):
    """The coarse-far decomposition for statically exact absolute wings:
    (coarse grid, coarse calls, correction calls), each call (line
    indices, packed plan, mode). ``subsets`` (line indices, far mode,
    correction kind) replaces the routing by the store's ``sd_air`` column
    (the HT builder routes by its resolved columns).

    The far field of every line runs in the guarded asymptotic form
    (``asym``/``sdvoigt_asym``) on the extended coarse grid (x0 - R dx,
    R dx, (n - 1)//R + 4 points: one extra node each side, so every fine
    point has its four-node stencil); the correction passes ``corr:R:*``
    make the upsampled field exact within ``near_width`` of each centre
    and across the window-edge discontinuity (bands of 2 R dx + 2 dx about
    nu0 +- wing_abs, the stencil's reach).
    """
    R = int(coarse_r)
    if tile_corr % R:
        raise ValueError(f"correction tile ({tile_corr}) must be a "
                         f"multiple of coarse_r ({R})")
    g_c = UniformGrid(x0=g.x0 - g.dx * R, dx=g.dx * R, n=(g.n - 1) // R + 4)
    nu0 = np.asarray(lines_h.nu0, dtype=np.float64)
    if subsets is None and profile == "sdvoigt":
        sd_mask = np.asarray(lines_h.sd_air, dtype=np.float64) != 0.0
        subsets = [(np.nonzero(sd_mask)[0], "sdvoigt_asym", "sdvoigt"),
                   (np.nonzero(~sd_mask)[0], "asym", "voigt")]
    elif subsets is None:
        subsets = [(np.arange(nu0.size), "asym", "voigt")]
    coarse_calls, corr_calls = [], []
    h = R * g.dx
    for idx, far_mode, corr_kind in subsets:
        if not idx.size:
            continue
        nu_s = nu0[idx]
        coarse_calls.append((idx, plan_buckets_packed(
            nu_s, g_c, float(wing_abs), tile=tile_coarse, block="auto"),
            far_mode))
        corr_calls.append((idx, plan_buckets_packed(
            nu_s, g, float(near_width), tile=tile_corr, block="auto"),
            f"corr:{R}:{corr_kind}"))
        for side in (-1.0, 1.0):
            corr_calls.append((idx, plan_buckets_packed(
                nu_s, g, 2.0 * h + 2.0 * g.dx, tile=tile_corr, block="auto",
                place_center=nu_s + side * float(wing_abs)),
                f"corr:{R}:{corr_kind}"))
    return g_c, coarse_calls, corr_calls


def _make_continuum_term(g, mol_ids, continuum, continuum_factors, device,
                         dtype, n_local=None):
    """Per-layer continuum-OD term ``fn(T, p_pa, pl, vmr, k_offset=0,
    k_index=None) -> (nLay, n_local or nX)``, or None for
    ``continuum='none'``: 'mt_ckd' through its layer-hoisted evaluator, the
    other models of ``CONTINUUM_MODELS`` pointwise. ``n_local`` and
    ``k_offset`` select a contiguous slice of the grid (a spectral shard's
    width and first point), ``k_index`` explicit global point indices (the
    weighted partition's permuted shard): only those points are evaluated,
    at the values the whole grid has there."""
    from ..atmos.continuum import (CONTINUUM_MODELS,
                                   LAYERED_CONTINUUM_FACTORIES,
                                   check_h2o_table_coverage,
                                   continuum_factors_tensor)

    if continuum == "none":
        return None
    if continuum == "mt_ckd":
        check_h2o_table_coverage(g.x0, g.x0 + g.dx * (g.n - 1))
    cf = continuum_factors_tensor(continuum_factors, continuum, dtype,
                                  device)
    mol_ids = tuple(mol_ids)
    n = g.n if n_local is None else int(n_local)

    def points(k_offset, k_index):
        # the global grid indices to evaluate (None: the whole grid)
        if k_index is not None:
            return torch.as_tensor(k_index).to(device=device,
                                               dtype=torch.long).reshape(-1)
        if n_local is None and isinstance(k_offset, int) and k_offset == 0:
            return None
        return k_offset + torch.arange(n, device=device)

    factory = LAYERED_CONTINUUM_FACTORIES.get(continuum)
    if factory is not None:
        layered = factory(g.values(), mol_ids, device=device, dtype=dtype)

        def term(T, p_pa, pl, vmr, k_offset=0, k_index=None):
            return layered(T, p_pa, pl, vmr, cf,
                           k=points(k_offset, k_index)).to(dtype)

        return term
    cfn = CONTINUUM_MODELS[continuum]
    nu_all = torch.as_tensor(g.values(), dtype=dtype, device=device)

    def term(T, p_pa, pl, vmr, k_offset=0, k_index=None):
        k = points(k_offset, k_index)
        nu = nu_all if k is None else nu_all[k]
        return cfn(nu, T[:, None], p_pa[:, None], vmr, mol_ids, pl[:, None],
                   cf).to(dtype)

    return term


def _merge(out, part, layers=None):
    """``out += part`` in place, or on ``layers`` only (``index_add_``):
    the span ``k1.merge``. The pass ``part`` comes as an argument, so it
    is freed as soon as it is added."""
    with span("k1.merge"):
        if layers is None:
            out += part
        else:
            out.index_add_(0, layers, part)


class _Passes:
    """The kernel passes of one set of static plans and how they sum.

    ``calls`` are the classic passes, ``coarse_calls`` and ``corr_calls``
    the coarse-far route's (empty off it), each (layer or state indices
    int32, :class:`~..kernels.fused_xsect.DevicePlan`, mode); the coarse
    plans lie on ``grid_coarse``. ``fast_rcp`` goes to every kernel a pass
    launches. The four builders set ``work_report``, the passes' plan work
    as JAX's builders list it (:func:`_work_report`).
    """

    def __init__(self, calls, coarse_calls, corr_calls, grid, grid_coarse,
                 coarse_r, n_weideman, fast_rcp):
        self.calls = calls
        self.coarse_calls = coarse_calls
        self.corr_calls = corr_calls
        self.grid, self.grid_coarse = grid, grid_coarse
        self.coarse_r = coarse_r
        self.n_x = grid.n
        self.n_weideman = n_weideman
        self.fast_rcp = bool(fast_rcp)

    def all_calls(self):
        """Every pass: the coarse, correction and classic calls."""
        return [*self.coarse_calls, *self.corr_calls, *self.calls]

    def run_call(self, call, prm: LineParams, Y=None, kernel=xsect_fused):
        """One pass: (len(layers), its plan's n_out). The ``full``,
        ``sdvoigt`` and ``ht`` passes go through their differentiable calls
        (K1 or K5 for the value, K3, K4 or K6 for tangents), unless
        ``kernel`` names another function (the plain version, in the
        checks: an ``ht`` pass then runs K5's plain version), each with the
        builder's ``fast_rcp``. Span ``k1.<mode>``."""
        lay, dplan, mode = call
        with span("k1." + mode):
            plain = kernel is not xsect_fused
            fast = self.fast_rcp
            if mode == "ht":
                fn = xsect_ht_plain if plain else xsect_ht_diff
                return fn(dplan, lay, prm.strength, prm.wing, prm.ht_consts,
                          self.n_weideman, fast)
            if mode == "full" and not plain:
                return xsect_fused_diff(dplan, lay, prm.shift0, prm.strength,
                                        prm.gamma_d, prm.gamma_0, prm.wing,
                                        self.n_weideman, fast)
            if mode == "sdvoigt" and not plain:
                return xsect_fused_sdvoigt_diff(
                    dplan, lay, prm.shift0, prm.strength, prm.gamma_d,
                    prm.gamma_0, prm.gamma_2, prm.wing, self.n_weideman, fast)
            return kernel(dplan, lay, prm.shift0, prm.strength, prm.gamma_d,
                          prm.gamma_0, prm.wing, Y if mode == "mix" else None,
                          mode, self.n_weideman,
                          gamma_2=prm.gamma_2 if is_sd_mode(mode) else None,
                          fast=fast)

    def line_sum(self, prm: LineParams, Y=None):
        """(nLay, nX) sum of the passes: the coarse far field upsampled,
        plus the correction passes, plus each classic pass on its layers
        (``index_add_``: in place, one addition per element, and it
        carries forward-mode tangents). Span ``k1.upsample``."""
        n = prm.strength.shape[0]
        dt, dev = prm.strength.dtype, prm.strength.device
        if self.coarse_calls:
            out_c = torch.zeros((n, self.grid_coarse.n), dtype=dt, device=dev)
            for call in self.coarse_calls:
                _merge(out_c, self.run_call(call, prm))
            with span("k1.upsample"):
                out = _coarse_upsample(out_c, self.n_x, self.coarse_r)
            for call in self.corr_calls:
                _merge(out, self.run_call(call, prm))
        else:
            out = torch.zeros((n, self.n_x), dtype=dt, device=dev)
        for call in self.calls:
            _merge(out, self.run_call(call, prm, Y), call[0])
        return out


class OpticalDepthFn(_Passes):
    """``(T, p_pa, pl, vmr) -> (nLay, nX)`` layer OD with the static plans
    of one line list, grid and atmosphere class baked in (see
    :func:`make_od_fn`). Every operation on the state is differentiable in
    forward mode; the ``full`` passes carry their tangents through K3.
    """

    def __init__(self, lines, iso, passes, cols, profile, wing_abs, wing_hw,
                 line_mixing, cont):
        super().__init__(**passes)
        self.lines, self.iso = lines, iso
        self.cols = cols
        self.profile = profile
        self.wing_abs, self.wing_hw = wing_abs, wing_hw
        self.cont = cont
        dev, dt = lines.sw.device, lines.sw.dtype
        self.y_air = self.y_self = None
        self.n_T = 0.0
        if line_mixing is not None:
            self.y_air = torch.as_tensor(as_numpy(line_mixing["y_air"]),
                                         dtype=dt, device=dev)
            if line_mixing.get("y_self") is not None:
                self.y_self = torch.as_tensor(
                    as_numpy(line_mixing["y_self"]), dtype=dt, device=dev)
            self.n_T = float(line_mixing.get("n_T", 0.0))

    def line_params(self, T, p_pa, pl, vmr):
        """(nLay, L) line parameters with the OD strength scaling, and the
        (nLay, L) mixing coefficients (None without line mixing). Span
        ``od.line_params``."""
        with span("od.line_params"):
            prm = _layer_params(self.lines, self.iso, T, p_pa, pl, vmr,
                                self.cols, self.wing_abs, self.wing_hw,
                                self.profile)
            Y = None
            if self.y_air is not None:
                Y = mixing_coefficient(self.y_air,
                                       (p_pa / PA_PER_ATM)[:, None],
                                       T[:, None], y_self=self.y_self,
                                       x_self=vmr[:, self.cols], n_T=self.n_T)
            return prm, Y

    def __call__(self, T, p_pa, pl, vmr):
        """Span ``od``, holding ``od.line_params``, the passes' ``k1.*``
        and ``od.continuum`` (the continuum term and its addition)."""
        with span("od"):
            # NumPy columns join the store in its dtype, as the line
            # parameters cast the tensor route's
            T, p_pa, pl, vmr = arrays_on(T, p_pa, pl, vmr,
                                         device=self.lines.sw.device,
                                         dtype=self.lines.sw.dtype)
            prm, Y = self.line_params(T, p_pa, pl, vmr)
            out = self.line_sum(prm, Y)
            if Y is not None:
                # first-order mixing can leave small negative excursions
                # next to a Q branch (a truncation artefact; LTE absorption
                # is nonnegative): clamp before the continuum, as the JAX
                # builders
                out = torch.clamp(out, min=0.0)
            if self.cont is not None:
                with span("od.continuum"):
                    out = out + self.cont(T, p_pa, pl, vmr)
            return out


class CrossSectionFn(_Passes):
    """``(T, p_atm) -> (nStates, nX)`` float cross-sections [cm^2/molec] of
    a (T, p) lattice with the static plans baked in (see
    :func:`make_xsect_fn`): the states are the kernels' layers."""

    def __init__(self, lines, iso, passes, profile, wing_abs, wing_hw):
        super().__init__(**passes)
        self.lines, self.iso = lines, iso
        self.profile = profile
        self.wing_abs, self.wing_hw = wing_abs, wing_hw

    def line_params(self, T, p_atm):
        """(nStates, L) line parameters in HITRAN units (no column factor;
        ``vmr_self = 0``: hapi's default Diluent {'air': 1}). Span
        ``xsect.line_params``."""
        with span("xsect.line_params"):
            return compute_line_params(self.lines, self.iso, T[:, None],
                                       p_atm[:, None], vmr_self=0.0,
                                       wing_abs=self.wing_abs,
                                       wing_hw=self.wing_hw,
                                       profile=self.profile)

    def __call__(self, T, p_atm):
        """Span ``xsect``."""
        with span("xsect"):
            return self.line_sum(self.line_params(T, p_atm))


def _device_passes(calls, coarse, lines_h, g, coarse_r, n_weideman, n_lay,
                   device, dtype, fast_rcp):
    """The host plans of :func:`_build_od_calls` (and of the coarse-far
    route, ``coarse`` = (coarse grid, coarse calls, correction calls) or
    None) as :class:`_Passes` keyword arguments on ``device``, with the
    builder's ``fast_rcp``."""
    dev_plan = lambda plan, idx: device_plan(  # noqa: E731
        plan, idx, lines_h.nu0, device=device, dtype=dtype)
    as_lay = lambda lay: torch.as_tensor(  # noqa: E731
        np.asarray(lay), dtype=torch.int32, device=device)
    g_c, coarse_calls, corr_calls = coarse or (None, [], [])
    all_lay = np.arange(n_lay)
    return dict(
        calls=[(as_lay(lay), dev_plan(plan, idx), mode)
               for lay, idx, plan, mode in calls],
        coarse_calls=[(as_lay(all_lay), dev_plan(plan, idx), mode)
                      for idx, plan, mode in coarse_calls],
        corr_calls=[(as_lay(all_lay), dev_plan(plan, idx), mode)
                    for idx, plan, mode in corr_calls],
        grid=g, grid_coarse=g_c, coarse_r=int(coarse_r),
        n_weideman=n_weideman, fast_rcp=fast_rcp)


def _work_report(calls, coarse, n_weideman, n_lay):
    """The builder's ``work_report`` (``od.py:884-908`` there): one
    ``{"mode", "evals", "n_weideman"}`` entry per kernel pass, the classic
    passes first, then the coarse and the correction passes, with ``evals``
    the plan's dense (layer x slot x point) work
    (:func:`~..kernels.fused_xsect.plan_executed_evals`; the coarse-far
    passes run over all ``n_lay`` layers or states). Those are JAX's
    figures, integer for integer; what the CUDA kernels evaluate after
    culling is less (``chip_smoke.py``'s ``window_counts``)."""
    _, coarse_calls, corr_calls = coarse or (None, [], [])
    entry = lambda mode, plan, n: {  # noqa: E731
        "mode": mode, "evals": plan_executed_evals(plan, n),
        "n_weideman": n_weideman}
    return ([entry(mode, plan, len(lay)) for lay, _, plan, mode in calls]
            + [entry(mode, plan, n_lay)
               for _, plan, mode in [*coarse_calls, *corr_calls]])


def _hw_wing_max(lines_h, iso_h, states_h, wing_hw, vmr_margin) -> float:
    """The largest halfwidth wing of any line over the class states."""
    return float(np.max([wing_bound_matrix(lines_h, iso_h, st, wing_abs=0.0,
                                           wing_hw=wing_hw,
                                           vmr_margin=vmr_margin)
                         for st in states_h]))


def _coarse_route(lines_h, g, wing_abs, tile, far_method, coarse_r, allowed,
                  hw_wing, profile, subsets=None, near_width=4.0):
    """The coarse-far decomposition of a builder, or None for the classic
    route: ``far_method`` 'auto' takes it where it is statically exact
    (``hw_wing()``, the largest halfwidth wing over the class states, is
    within ``wing_abs``) and ``wing_abs`` clears both 16 coarse steps and
    the near/edge disjointness bound, 'coarse' requires it (raising where it
    is not), 'classic' never; ``allowed`` is the builder's own precondition
    and ``subsets`` its routing (:func:`_build_coarse_far_calls`);
    ``near_width`` [cm^-1] floors the near zone's half-width
    (:func:`_coarse_near_width`). The
    correction kernel's ``coarse_r`` must divide its 256-point slice and be
    at least 8 (:func:`~..kernels.fused_xsect.corr_r_supported`), on the CPU
    too."""
    if far_method not in ("auto", "coarse", "classic"):
        raise ValueError(f"far_method must be 'auto', 'coarse' or "
                         f"'classic', got {far_method!r}")
    min_wing = _coarse_far_min_wing(g, coarse_r, near_width)
    use = (far_method != "classic" and allowed and float(wing_abs) > 0.0
           and corr_r_supported(coarse_r)
           and float(wing_abs) >= max(16.0 * coarse_r * g.dx, min_wing)
           and hw_wing() <= float(wing_abs))
    if far_method == "coarse" and not use:
        raise ValueError(
            "far_method='coarse' requires profile voigt/sdvoigt with "
            "two_pass (no line mixing, not differentiable) or the HT "
            "lattice, a coarse_r that divides 256 and is at least 8 (got "
            f"{coarse_r!r}) and a wing_abs that dominates every line's "
            "halfwidth wing over the class states while clearing the "
            "near-zone/edge-band plan-disjointness bound "
            f"({min_wing:.3g} cm^-1 here); got wing_abs={wing_abs!r}")
    if not use:
        return None
    nw = _coarse_near_width(coarse_r, g.dx, near_width)
    return _build_coarse_far_calls(
        lines_h, g, wing_abs, profile, coarse_r, nw,
        tile_coarse=min(tile, 512),
        tile_corr=_coarse_tile_corr(g, coarse_r, nw, wing_abs),
        subsets=subsets)


def _check_build_opts(**sizes):
    """Refuse tile or block sizes that are not positive integers (None
    or 0 keeps the planner's own choice, as in the JAX planner)."""
    for name, v in sizes.items():
        if v is not None and v != 0 and (isinstance(v, bool) or not isinstance(
                v, (int, np.integer)) or v < 1):
            raise ValueError(f"{name} must be a positive integer (a kernel "
                             f"launch covers whole tiles of line-slot "
                             f"blocks), got {v!r}")


def make_od_fn(lines, iso, grid, atmos_class, wing_abs=0.0, wing_hw=50.0,
               max_groups: int = 8, tile: int = 512, n_weideman: int = 16,
               two_pass: bool = True, far_tile: int | None = None,
               far_block: int | None = None, group_ratio: float = 4.0,
               core_tile: int | None = None, core_block: int = 16,
               fast_rcp: bool = True, profile: str = "voigt",
               continuum: str = "none", continuum_factors=None,
               differentiable: bool = False,
               line_mixing: dict | None = None, far_method: str = "auto",
               coarse_r: int = 64, near_width: float = 4.0) -> OpticalDepthFn:
    """Build the layer-OD function with static packed plans (the counterpart
    of ``make_od_pallas_fn``, with its defaults).

    ``lines``/``iso`` live on the device and in the dtype the OD is computed
    in (float32 launches the CUDA kernels on a card; CPU tensors run the
    plain versions, float32 or float64). ``grid`` is a uniform axis or a
    :class:`UniformGrid`; ``atmos_class`` one representative state (or a
    list of envelope states) sizing the plans. ``profile`` is 'voigt',
    'sdvoigt', 'lorentz' or 'doppler'. ``line_mixing`` carries ``y_air``
    (and optionally ``y_self``, ``n_T``) for first-order mixing (Voigt
    only). ``differentiable=True`` builds single-pass ``full`` plans whose
    passes carry ``torch.func.jvp`` tangents through K3, and for
    ``profile='sdvoigt'`` single-pass ``sdvoigt`` plans for the lines with
    ``sd_air != 0`` whose tangents go through K4 (no line mixing, as the
    JAX builder). Absolute wings (``wing_abs``) that
    dominate every halfwidth wing and clear the coarse-far disjointness
    bound take the coarse-far route (``far_method`` 'auto'; 'coarse'
    requires it, 'classic' never; ``coarse_r`` and ``near_width``: see
    :func:`_build_coarse_far_calls`).

    The planning options are the JAX builder's, with its defaults and
    meaning: ``two_pass=False`` plans single ``full`` passes (no core
    passes; ``differentiable`` implies it), ``far_tile``/``far_block`` size
    the window passes and ``core_tile`` the core passes
    (:func:`_build_od_calls`); ``fast_rcp`` runs every kernel with the fast
    reciprocal (the CPU's plain versions divide in IEEE either way).
    """
    _check_build_opts(tile=tile, far_tile=far_tile, far_block=far_block,
                      core_tile=core_tile, core_block=core_block)
    if profile == "ht":
        raise NotImplementedError(
            "profile 'ht': the layered Hartmann-Tran OD is make_od_ht_fn")
    if differentiable and line_mixing is not None:
        # the JAX builder routes mixing Jacobians to its jnp engine
        raise NotImplementedError(
            "differentiable OD with line mixing: the differentiable kernels "
            "have no mixing tangent; mixing Jacobians are forward-mode AD "
            "through compute_od_layers(engine='jnp', line_mixing=...), as in "
            "the JAX package (ROADMAP queue 1 item 3)")
    if differentiable and profile not in ("voigt", "sdvoigt"):
        raise NotImplementedError(
            f"differentiable OD with profile {profile!r}: the tangent "
            "kernels are the Voigt (K3) and SD-Voigt (K4) ones; the JAX "
            "package has no Lorentz or Doppler tangent")
    g = _uniform_grid(grid)
    dev, dt = lines.sw.device, lines.sw.dtype
    mix_idx = None
    if line_mixing is not None:
        mix_idx = np.nonzero(as_numpy(line_mixing["y_air"]) != 0.0)[0]
    lines_h, iso_h, states_h = _host_planning_views(lines, iso, atmos_class)
    mol_ids = tuple(states_h[0].mol_ids)
    cols = torch.as_tensor(_line_species_cols(lines_h, mol_ids), device=dev)
    # the tangent kernels implement the single-pass blends
    two_pass = two_pass and not differentiable
    coarse = _coarse_route(
        lines_h, g, wing_abs, tile, far_method, coarse_r,
        allowed=(profile in ("voigt", "sdvoigt") and two_pass
                 and line_mixing is None),
        hw_wing=lambda: _hw_wing_max(lines_h, iso_h, states_h, wing_hw, 1.5),
        profile=profile, near_width=near_width)
    # on the coarse-far route the wing passes give way to the coarse far
    # field and its corrections; the classic per-line-tight core passes stay
    calls = _build_od_calls(lines_h, iso_h, states_h, g, wing_abs, wing_hw,
                            max_groups, tile, group_ratio,
                            core_block=core_block, mix_idx=mix_idx,
                            two_pass=two_pass, profile=profile,
                            wing_passes=coarse is None, far_tile=far_tile,
                            far_block=far_block, core_tile=core_tile)
    n_lay = int(states_h[0].T.size)
    passes = _device_passes(calls, coarse, lines_h, g, coarse_r, n_weideman,
                            n_lay, dev, dt, fast_rcp)
    cont = _make_continuum_term(g, mol_ids, continuum, continuum_factors,
                                dev, dt)
    fn = OpticalDepthFn(lines, iso, passes, cols, profile, wing_abs, wing_hw,
                        line_mixing, cont)
    fn.work_report = _work_report(calls, coarse, n_weideman, n_lay)
    return fn


def _weighted_chunk_assignment(calls, n_pad, n_shards, n_weideman):
    """(n_shards, chunks_per_shard) chunk ids balancing op-weighted work
    (``od.py:1812-1845`` there): chunks span the largest call tile, a
    chunk's work sums each call's ``counts x block x tile x n_lay x
    ops_per_eval(mode)`` over its tiles, and chunks go by greedy
    longest-processing-time (the same stable argsort) under equal
    cardinality, so every shard runs the same number of tiles."""
    A = max(plan.tile for _, _, plan, _ in calls)
    nc = n_pad // A
    if nc % n_shards:
        raise AssertionError("chunk count not divisible by shard count")
    work = np.zeros(nc, dtype=np.float64)
    for lay_idx, _, plan, mode in calls:
        t = plan.tile
        per_tile = (plan.counts.astype(np.float64) * plan.block * t
                    * len(lay_idx) * _ops_per_eval(n_weideman, mode))
        work += per_tile.reshape(nc, A // t).sum(axis=1)
    cap = nc // n_shards
    loads = np.zeros(n_shards)
    fill = np.zeros(n_shards, dtype=np.int64)
    assign = np.empty((n_shards, cap), dtype=np.int64)
    for c in np.argsort(-work, kind="stable"):
        open_s = np.nonzero(fill < cap)[0]
        s = open_s[np.argmin(loads[open_s])]
        assign[s, fill[s]] = c
        fill[s] += 1
        loads[s] += work[c]
    assign.sort(axis=1)
    return assign


def shard_slice(tree, s: int, device=None):
    """Shard ``s``'s slice of a sharded builder's per-shard data (every
    tensor of the dicts, lists and tuples of ``tree`` indexed by ``s`` on
    its leading shard axis: what ``shard_map`` hands each device there), on
    ``device`` (None: where it lies)."""
    if isinstance(tree, dict):
        return {k: shard_slice(v, s, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_slice(v, s, device) for v in tree)
    return tree[s] if device is None else tree[s].to(device)


class LocalOpticalDepthFn(OpticalDepthFn):
    """One spectral shard's layer OD (see :func:`make_od_local_fn`):
    ``fn(T, p_pa, pl, vmr, local_spec, k_offset) -> (nLay, n_local)``, the
    shard's points in local order (a contiguous slice from global index
    ``k_offset``, or, for the weighted partition, ``point_index[s]``).
    ``bind(local_spec, k_offset)`` makes the shard's plans once
    (:class:`ShardOD`): bind before ``torch.func`` transforms, whose
    wrapped tensors have no storage to hand a kernel. ``to(device)`` gives
    the same function on another device (its plans, lines and tables moved
    there, the host planning reused)."""

    def __init__(self, *args, n_local, partition, point_index, rebuild,
                 plan_digest):
        super().__init__(*args)
        self.n_local = n_local
        self.partition = partition
        #: (n_shards, n_local) global grid index of each shard's points
        #: (the weighted partition), else None
        self.point_index = point_index
        #: SHA-256 of the host plans (:func:`_plan_digest`): processes
        #: sharing one mesh compare it before they split the work
        self.plan_digest = plan_digest
        self._rebuild = rebuild

    def to(self, device) -> "LocalOpticalDepthFn":
        device = torch.device(device)
        if device == self.lines.sw.device:
            return self
        return self._rebuild(device)

    def bind(self, local_spec, k_offset=0) -> "ShardOD":
        return ShardOD(self, local_spec, k_offset)

    def __call__(self, T, p_pa, pl, vmr, local_spec, k_offset=0):
        return self.bind(local_spec, k_offset)(T, p_pa, pl, vmr)


class ShardOD:
    """A :class:`LocalOpticalDepthFn` bound to one shard:
    ``fn(T, p_pa, pl, vmr) -> (nLay, n_local)``. ``calls`` are the passes
    on the shard's plans (:func:`~..kernels.fused_xsect.shard_plan`: its
    tiles' blocks and global grid offsets), summed as the unsharded
    builder sums them; the continuum evaluates the shard's points."""

    def __init__(self, fn: LocalOpticalDepthFn, local_spec, k_offset=0):
        self.fn = fn
        n = fn.n_local
        if isinstance(local_spec, dict):
            call_spec = list(local_spec["calls"])
            self.cont_kw = dict(k_index=local_spec["point_idx"])
        else:
            call_spec = [(st, ct, k_offset) for st, ct in local_spec]
            self.cont_kw = dict(k_offset=k_offset)
        self.calls = [(lay, shard_plan(dplan, starts=st, counts=ct,
                                       k_offset=off, n_tiles=n // dplan.tile,
                                       n_out=n), mode)
                      for (lay, dplan, mode), (st, ct, off)
                      in zip(fn.calls, call_spec)]

    def __call__(self, T, p_pa, pl, vmr):
        """Span ``od``, with the unsharded builder's spans inside."""
        fn = self.fn
        with span("od"):
            T, p_pa, pl, vmr = arrays_on(T, p_pa, pl, vmr,
                                         device=fn.lines.sw.device,
                                         dtype=fn.lines.sw.dtype)
            prm, Y = fn.line_params(T, p_pa, pl, vmr)
            out = torch.zeros((T.shape[0], fn.n_local),
                              dtype=prm.strength.dtype,
                              device=prm.strength.device)
            for call in self.calls:
                _merge(out, fn.run_call(call, prm, Y), call[0])
            if Y is not None:
                # first-order mixing's negative excursions, clamped before
                # the continuum (as the unsharded builder)
                out = torch.clamp(out, min=0.0)
            if fn.cont is not None:
                with span("od.continuum"):
                    out = out + fn.cont(T, p_pa, pl, vmr, **self.cont_kw)
            return out


def _lines_on(lines, iso, device):
    """``lines`` and ``iso`` with every tensor on ``device`` (the float64
    host columns shared)."""
    mv = lambda obj, names: dataclasses.replace(obj, **{  # noqa: E731
        f: getattr(obj, f).to(device) for f in names})
    return (mv(lines, [f.name for f in dataclasses.fields(lines)
                       if f.name != "host"]),
            mv(iso, [f.name for f in dataclasses.fields(iso)]))


def _plan_digest(calls, host_spec) -> str:
    """SHA-256 of a sharded builder's host plans: every call's layers,
    lines, mode and bucket plan (grid, sizes, block ranges, slots, wing
    bounds) and the shards' spec (block ranges, tile offsets, the weighted
    partition's point index)."""
    h = hashlib.sha256()

    def add(v):
        if isinstance(v, (dict, list, tuple)):
            items = v.items() if isinstance(v, dict) else enumerate(v)
            h.update(f"{type(v).__name__}{len(v)}".encode())
            for k, x in items:
                h.update(repr(k).encode())
                add(x)
        elif isinstance(v, BucketPlan):
            add({f.name: getattr(v, f.name) for f in dataclasses.fields(v)})
        elif isinstance(v, np.ndarray) or torch.is_tensor(v):
            a = np.ascontiguousarray(as_numpy(v))
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(a.tobytes())
        else:
            h.update(repr(v).encode())

    add([(lay, idx, plan, mode) for lay, idx, plan, mode in calls])
    add(host_spec)
    return h.hexdigest()


def make_od_local_fn(lines, iso, grid, atmos_class, n_shards: int,
                     wing_abs=0.0, wing_hw=50.0, max_groups: int = 8,
                     tile: int = 512, n_weideman: int = 16,
                     two_pass: bool = True, far_tile: int | None = None,
                     far_block: int | None = None, group_ratio: float = 1.6,
                     fast_rcp: bool = True, profile: str = "voigt",
                     continuum: str = "none", continuum_factors=None,
                     line_mixing: dict | None = None,
                     partition: str = "equal",
                     differentiable: bool = False):
    """Per-shard OD over a spectrum-sharded grid (the counterpart of
    ``make_od_pallas_local_fn``, with its arguments and defaults).

    Every shard runs the same static plans, built on a padded global grid
    whose tiles never straddle a shard boundary; what differs per shard is
    data: its slice of the per-tile block ranges and its tiles' global grid
    offsets (K1, K3 and K4 take them per tile, ``DevicePlan.tile_off``).
    Returns ``(local_fn, spec_data, padded_grid)``:

    * ``local_fn(T, p_pa, pl, vmr, local_spec, k_offset) -> (nLay,
      n_local)`` (:class:`LocalOpticalDepthFn`), ``local_spec`` shard s's
      slice of ``spec_data`` (:func:`shard_slice`), ``k_offset`` its first
      global point ``s * n_local`` (unused by the weighted partition);
    * ``spec_data``: for ``partition='equal'`` (contiguous equal slices) a
      list over the kernel calls of (starts, counts), each (n_shards,
      local tiles) int32; for ``'weighted'`` (chunks of the largest call
      tile dealt to shards by greedy longest-processing-time on each
      call's op-weighted work, equal chunk counts) ``{"calls": [(starts,
      counts, tile offsets), ...], "point_idx": (n_shards, n_local)}``,
      the shards' points then a permutation of the global grid
      (``local_fn.point_index``: ``out_global[:, point_index[s]] =
      out_shard_s``);
    * ``padded_grid``: the :class:`UniformGrid` padded to a multiple of
      ``max(far tile or 2 tile, tile, 512) * n_shards`` points
      (``n_local = padded_grid.n // n_shards``; slice the trailing padding
      off after gathering).

    The continuum evaluates only the shard's points. ``differentiable``
    builds single-pass plans whose passes carry ``torch.func.jvp`` tangents
    through K3 and K4 (Voigt and SD-Voigt, no line mixing).
    """
    _check_build_opts(tile=tile, far_tile=far_tile, far_block=far_block)
    g0 = _uniform_grid(grid)
    # pad so that every call's tile divides the shard's points: the far
    # pass uses far_tile (2 tile with two_pass), the core pass <= max(512,
    # tile), all powers of two; the alignment is taken before
    # differentiable drops two_pass, as in the JAX builder
    f_tile_eff = far_tile or (2 * tile if two_pass else tile)
    align = max(f_tile_eff, tile, 512) * n_shards
    n_pad = -(-g0.n // align) * align
    g = UniformGrid(x0=g0.x0, dx=g0.dx, n=n_pad)
    n_local = n_pad // n_shards
    if differentiable:
        if profile not in ("voigt", "sdvoigt") or line_mixing is not None:
            raise NotImplementedError(
                "differentiable sharded OD supports the Voigt and SD-Voigt "
                "profiles without line mixing")
        two_pass = False
    mix_idx = None
    if line_mixing is not None:
        mix_idx = np.nonzero(as_numpy(line_mixing["y_air"]) != 0.0)[0]
    lines_h, iso_h, states_h = _host_planning_views(lines, iso, atmos_class)
    mol_ids = tuple(states_h[0].mol_ids)
    calls = _build_od_calls(lines_h, iso_h, states_h, g, wing_abs, wing_hw,
                            max_groups, tile, group_ratio, mix_idx=mix_idx,
                            two_pass=two_pass, profile=profile,
                            far_tile=far_tile, far_block=far_block)
    for _, _, plan, _ in calls:
        if n_local % plan.tile:
            raise AssertionError(
                f"plan tile {plan.tile} does not divide the per-shard point "
                f"count {n_local}; alignment bug")

    point_index = None
    if partition == "equal":
        host_spec = [(plan.starts.reshape(n_shards, -1),
                      plan.counts.reshape(n_shards, -1))
                     for _, _, plan, _ in calls]
    elif partition == "weighted":
        assign = _weighted_chunk_assignment(calls, n_pad, n_shards,
                                            n_weideman)
        A = n_pad // (assign.shape[0] * assign.shape[1])
        host_calls = []
        for _, _, plan, _ in calls:
            t = plan.tile
            tpc, nt_loc = A // t, n_local // t
            gt = (assign[:, :, None] * tpc
                  + np.arange(tpc)).reshape(n_shards, nt_loc)
            offs = (gt * t - np.arange(nt_loc) * t).astype(np.int32)
            host_calls.append((plan.starts[gt], plan.counts[gt], offs))
        point_index = (assign[:, :, None] * A
                       + np.arange(A)).reshape(n_shards, n_local)
        host_spec = {"calls": host_calls,
                     "point_idx": point_index.astype(np.int32)}
    else:
        raise ValueError(f"unknown partition {partition!r}")
    digest = _plan_digest(calls, host_spec)

    def build(device):
        lines_d, iso_d = _lines_on(lines, iso, device)
        dt = lines_d.sw.dtype
        cols = torch.as_tensor(_line_species_cols(lines_h, mol_ids),
                               device=device)
        passes = _device_passes(calls, None, lines_h, g, 1, n_weideman,
                                int(np.asarray(states_h[0].T).size), device,
                                dt, fast_rcp)
        cont = _make_continuum_term(g, mol_ids, continuum, continuum_factors,
                                    device, dt, n_local=n_local)
        return LocalOpticalDepthFn(
            lines_d, iso_d, passes, cols, profile, wing_abs, wing_hw,
            line_mixing, cont, n_local=n_local, partition=partition,
            point_index=point_index, rebuild=build, plan_digest=digest)

    dev = lines.sw.device
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                    dtype=torch.int32, device=dev)
    if isinstance(host_spec, dict):
        spec_data = {"calls": [tuple(i32(a) for a in c)
                               for c in host_spec["calls"]],
                     "point_idx": i32(host_spec["point_idx"])}
    else:
        spec_data = [tuple(i32(a) for a in c) for c in host_spec]
    return build(dev), spec_data, g


def make_xsect_fn(lines, iso, grid, T_class, p_atm_class,
                  profile: str = "voigt", wing_abs=0.0, wing_hw=50.0,
                  max_groups: int = 8, tile: int = 512, n_weideman: int = 16,
                  two_pass: bool = True, group_ratio: float = 4.0,
                  fast_rcp: bool = True, far_method: str = "auto",
                  coarse_r: int = 64,
                  near_width: float = 4.0) -> CrossSectionFn:
    """Build the (T_states, p_atm_states) -> (nStates, nX) cross-section
    function [cm^2/molec] of a (T, p) lattice (the counterpart of
    ``make_xsect_pallas_fn``, with its defaults): the reference's
    XS-table generator (``misc/RT_gen_AbsXS_files.py:15-31,87-92``,
    SD-Voigt at 0.0025 cm^-1 with 350 cm^-1 absolute wings). The states
    are the fused kernel's layers: the whole lattice evaluates in one set
    of launches. HITRAN units; ``vmr_self = 0`` (hapi's default diluent).

    ``T_class``/``p_atm_class`` are the envelope states the static plans
    are sized on; the returned function takes states of the same count
    whose wings stay within them. ``far_method`` 'coarse' evaluates the far
    wings on a ``coarse_r``-decimated grid with exact correction passes
    near line centres and window edges (~R x less wing work) and requires
    statically exact wings and a ``coarse_r`` that divides 256 and is at
    least 8; 'auto' takes it where those hold and ``wing_abs`` spans many
    tiles; 'classic' never; ``near_width`` floors the near zone's
    half-width. ``fast_rcp``: the kernels' fast reciprocal
    (:func:`make_od_fn`). ``profile`` 'ht' is :func:`make_ht_fn`.
    """
    _check_build_opts(tile=tile)
    if profile == "ht":
        raise NotImplementedError(
            "profile 'ht': the Hartmann-Tran lattice is make_ht_fn")
    g = _uniform_grid(grid)
    dev, dt = lines.sw.device, lines.sw.dtype
    T_c = as_numpy(T_class, np.float64).ravel()
    p_c = as_numpy(p_atm_class, np.float64).ravel()
    mol_ids = tuple(int(m) for m in np.unique(lines.host["mol_id"]))
    n = T_c.size
    pseudo = AtmosphericState.from_numpy(
        z0=np.zeros(n), z1=np.ones(n), pl=np.ones(n), p=p_c * PA_PER_ATM,
        T=T_c, vmr=np.zeros((n, len(mol_ids))), mol_ids=mol_ids,
        device="cpu", dtype=torch.float64)
    lines_h, iso_h, states_h = _host_planning_views(lines, iso, pseudo)
    coarse = _coarse_route(
        lines_h, g, wing_abs, tile, far_method, coarse_r,
        allowed=profile in ("voigt", "sdvoigt") and two_pass,
        hw_wing=lambda: _hw_wing_max(lines_h, iso_h, states_h, wing_hw, None),
        profile=profile, near_width=near_width)
    calls = _build_od_calls(lines_h, iso_h, states_h, g, wing_abs, wing_hw,
                            max_groups, tile, group_ratio, two_pass=two_pass,
                            profile=profile, wing_passes=coarse is None)
    passes = _device_passes(calls, coarse, lines_h, g, coarse_r, n_weideman,
                            n, dev, dt, fast_rcp)
    fn = CrossSectionFn(lines, iso, passes, profile, wing_abs, wing_hw)
    fn.work_report = _work_report(calls, coarse, n_weideman, n)
    return fn


# --------------------------------------------------------------------------
# Hartmann-Tran
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HTParams:
    """(nLay, L) per-(state or layer, line) Hartmann-Tran parameters: the
    K1 passes of the degenerate lines read the Voigt/SD-Voigt fields, the
    ``ht`` passes the strength, the wing and the 11 constants of
    :func:`~..kernels.htp_real.ht_line_constants` (``HT_CONST_KEYS``
    order)."""

    strength: torch.Tensor
    gamma_d: torch.Tensor
    gamma_0: torch.Tensor
    shift0: torch.Tensor
    gamma_2: torch.Tensor
    wing: torch.Tensor
    ht_consts: tuple


def _ht_line_params(resolved, lines, iso, T, p_atm, wing_abs, wing_hw,
                    abun=None, strength_scale=1.0) -> HTParams:
    prm = ht_params(resolved, lines, iso, T, p_atm, wing_abs=wing_abs,
                    wing_hw=wing_hw, abun=abun,
                    strength_scale=strength_scale)
    k = ht_line_constants(prm["gamma_d"], prm["gamma0"], prm["gamma2"],
                          prm["shift0"], prm["shift2"], prm["nuvc"],
                          prm["eta_r"], prm["eta_i"])
    c = lambda a: a.contiguous()  # noqa: E731
    return HTParams(strength=c(prm["strength"]), gamma_d=c(prm["gamma_d"]),
                    gamma_0=c(prm["gamma0"]), shift0=c(prm["shift0"]),
                    gamma_2=c(prm["gamma2"]), wing=c(prm["wing"]),
                    ht_consts=tuple(c(k[key]) for key in HT_CONST_KEYS))


def ht_wing_bounds(resolved, lines_h, iso, T_states, p_atm_states,
                   wing_abs=0.0, wing_hw=50.0) -> np.ndarray:
    """(nStates, nLines) hapi wing bounds from resolved HT columns
    (``od.py:1193-1214``): max(wing_abs, wing_hw max(Gamma0(T, p),
    GammaD(T))) with the diluent-summed Gamma0, in NumPy on the host. The
    isotopologue tables, the lines and the states may lie on any device
    (copied to the host, as JAX's ``jax.device_get(iso)``)."""
    gd_coeff = _gd_coeff(lines_h, iso)
    T_c = as_numpy(T_states, np.float64).ravel()
    p_c = as_numpy(p_atm_states, np.float64).ravel()
    W = np.zeros((T_c.size, as_numpy(lines_h.nu0).size))
    for r, (T_s, p_s) in enumerate(zip(T_c, p_c)):
        g0 = np.zeros_like(W[0])
        for abun, g0db, ndb, *_ in resolved:
            g0 = g0 + abun * as_numpy(g0db) * (p_s / P_REF) \
                * (T_REF / T_s) ** as_numpy(ndb)
        gd = np.sqrt(T_s) * gd_coeff
        W[r] = np.maximum(wing_abs, wing_hw * np.maximum(g0, gd))
    return W


def _ht_subsets(resolved, n_lines, tile, differentiable=False):
    """The per-line routing of the HT builders (``od.py:1265-1278``):
    (mode, line indices, block cap) for the live-HT lines (eta, nuVC or
    Shift2 non-zero in a diluent's resolved columns: K5), the SD-Voigt
    degenerations (Gamma2 non-zero: K1 ``sdvoigt``) and the shifted Voigt
    ones (K1 ``full``). The caps are the JAX builders' VMEM guards, a
    quarter and a half of them for ``differentiable`` (``:1491-1496``):
    they shape the plans, which stay integer-exact with JAX's."""
    g2_any = np.zeros(n_lines, dtype=bool)
    full_m = np.zeros(n_lines, dtype=bool)
    for *_, g2db, d2db, nuvc_db, _kap, eta_db in resolved:
        g2_any |= np.asarray(g2db) != 0.0
        full_m |= ((np.asarray(d2db) != 0.0) | (np.asarray(nuvc_db) != 0.0)
                   | (np.asarray(eta_db) != 0.0))
    cap_ht = max(8, ((1 << 16) // tile) // 8 * 8)
    cap_sd = max(8, ((1 << 17) // tile) // 8 * 8)
    if differentiable:
        cap_ht = max(8, cap_ht // 4)
        cap_sd = max(8, cap_sd // 2)
    return [("ht", np.nonzero(full_m)[0], cap_ht),
            ("sdvoigt", np.nonzero(~full_m & g2_any)[0], cap_sd),
            ("full", np.nonzero(~full_m & ~g2_any)[0], cap_sd)]


def _ht_group_calls(nu0, g, W, mode, idx, cap, tile, max_groups,
                    group_ratio):
    """One subset's passes, a plan per layer group of similar wings."""
    W_s = W[:, idx]
    calls = []
    for lay_idx, _ in group_by_wing(W_s.max(axis=1), max_groups=max_groups,
                                    ratio=group_ratio):
        lay_idx = np.sort(lay_idx)
        w_line = W_s[lay_idx].max(axis=0)
        plan = plan_buckets_packed(nu0[idx], g, w_line, tile=tile,
                                   block="auto")
        if plan.block > cap:
            plan = plan_buckets_packed(nu0[idx], g, w_line, tile=tile,
                                       block=cap)
        calls.append((lay_idx, idx, plan, mode))
    return calls


class HTCrossSectionFn(_Passes):
    """``(T, p_atm) -> (nStates, nX)`` Hartmann-Tran cross-sections
    [cm^2/molec] of a (T, p) lattice with the static plans baked in (see
    :func:`make_ht_fn`)."""

    def __init__(self, lines, iso, passes, resolved, wing_abs, wing_hw):
        super().__init__(**passes)
        self.lines, self.iso = lines, iso
        self.resolved = resolved
        self.wing_abs, self.wing_hw = wing_abs, wing_hw

    def line_params(self, T, p_atm) -> HTParams:
        """(nStates, L) HT parameters in HITRAN units. Span
        ``xsect.line_params``."""
        with span("xsect.line_params"):
            return _ht_line_params(self.resolved, self.lines, self.iso,
                                   T[:, None], p_atm[:, None], self.wing_abs,
                                   self.wing_hw)

    def __call__(self, T, p_atm):
        """Span ``xsect``."""
        with span("xsect"):
            return self.line_sum(self.line_params(T, p_atm))


class HTOpticalDepthFn(_Passes):
    """``(T, p_pa, pl, vmr) -> (nLay, nX)`` Hartmann-Tran layer OD with the
    static plans baked in (see :func:`make_od_ht_fn`); differentiable in
    forward mode, the ``ht``, ``sdvoigt`` and ``full`` passes carrying their
    tangents through K6, K4 and K3."""

    def __init__(self, lines, iso, passes, resolved, cols, wing_abs,
                 wing_hw, cont):
        super().__init__(**passes)
        self.lines, self.iso = lines, iso
        self.resolved, self.cols = resolved, cols
        self.wing_abs, self.wing_hw = wing_abs, wing_hw
        self.cont = cont

    def line_params(self, T, p_pa, pl, vmr) -> HTParams:
        """(nLay, L) HT parameters with the layer's air/self diluent mix
        ``[1 - x_self, x_self]`` and column-density strengths. Span
        ``od.line_params``."""
        with span("od.line_params"):
            p_atm = p_pa / PA_PER_ATM
            u = species_column((p_atm * PA_PER_ATM)[:, None], T[:, None],
                               pl[:, None], vmr)
            x_self = vmr[:, self.cols]
            return _ht_line_params(self.resolved, self.lines, self.iso,
                                   T[:, None], p_atm[:, None], self.wing_abs,
                                   self.wing_hw, abun=[1.0 - x_self, x_self],
                                   strength_scale=u[:, self.cols])

    def __call__(self, T, p_pa, pl, vmr):
        """Span ``od``, as :class:`OpticalDepthFn`'s."""
        with span("od"):
            T, p_pa, pl, vmr = arrays_on(T, p_pa, pl, vmr,
                                         device=self.lines.sw.device,
                                         dtype=self.lines.sw.dtype)
            out = self.line_sum(self.line_params(T, p_pa, pl, vmr))
            if self.cont is not None:
                with span("od.continuum"):
                    out = out + self.cont(T, p_pa, pl, vmr)
            return out


def make_ht_fn(lines, iso, grid, T_class, p_atm_class, diluent=None,
               extras=None, wing_abs=0.0, wing_hw=50.0, tile: int = 128,
               n_weideman: int = 16, max_groups: int = 4,
               group_ratio: float = 4.0, fast_rcp: bool = True,
               far_method: str = "auto", coarse_r: int = 64,
               near_width: float = 4.0) -> HTCrossSectionFn:
    """Build the (T_states, p_atm_states) -> (nStates, nX) Hartmann-Tran
    cross-section function [cm^2/molec] (the counterpart of
    ``make_ht_pallas_fn``, with its defaults): hapi's
    ``absorptionCoefficient_HT`` (``misc/hapi.py:10302-10650``) over a
    (T, p) lattice, HITRAN units, hapi's window.

    The HT columns resolve with hapi's fallbacks from the store and the
    NumPy ``extras`` dict (:func:`~..kernels.ht_driver.resolve_ht_columns`;
    ``diluent`` defaults to ``{'air': 1}``). Lines with live eta, nuVC or
    Shift2 run the HT kernel K5; the others pcqsdhc's exact degenerations,
    K1 ``sdvoigt`` (Gamma2 != 0) or ``full``. With an absolute wing that
    dominates every halfwidth wing and clears the coarse-far disjointness
    bound, those two subsets take the coarse-far route (``far_method``
    'auto'; 'coarse' requires it, 'classic' never; ``coarse_r`` must divide
    256 and be at least 8; ``near_width`` floors the near zone), while the
    live-HT lines keep their full windows. ``fast_rcp``: the kernels'
    fast reciprocal (:func:`make_od_fn`).
    """
    _check_build_opts(tile=tile)
    if diluent is None:
        diluent = {"air": 1.0}
    g = _uniform_grid(grid)
    dev, dt = lines.sw.device, lines.sw.dtype
    T_c = as_numpy(T_class, np.float64).ravel()
    p_c = as_numpy(p_atm_class, np.float64).ravel()
    mol_ids = tuple(int(m) for m in np.unique(lines.host["mol_id"]))
    n = T_c.size
    pseudo = AtmosphericState.from_numpy(
        z0=np.zeros(n), z1=np.ones(n), pl=np.ones(n), p=p_c * PA_PER_ATM,
        T=T_c, vmr=np.zeros((n, len(mol_ids))), mol_ids=mol_ids,
        device="cpu", dtype=torch.float64)
    lines_h, iso_h, states_h = _host_planning_views(lines, iso, pseudo)
    resolved = resolve_ht_columns(lines, extras, diluent)
    W = ht_wing_bounds(resolved, lines_h, iso_h, T_c, p_c,
                       wing_abs=wing_abs, wing_hw=wing_hw)
    nu0 = np.asarray(lines_h.nu0, dtype=np.float64)
    subsets = _ht_subsets(resolved, nu0.size, tile)

    # the coarse-far route for the two degenerate subsets, eligible by the
    # diluent-summed HT wing bounds
    cf_subsets = [(idx, "sdvoigt_asym" if mode == "sdvoigt" else "asym",
                   "sdvoigt" if mode == "sdvoigt" else "voigt")
                  for mode, idx, _ in subsets[1:] if idx.size]
    coarse = _coarse_route(
        lines_h, g, wing_abs, tile, far_method, coarse_r, allowed=True,
        hw_wing=lambda: float(ht_wing_bounds(
            resolved, lines_h, iso_h, T_c, p_c, wing_abs=0.0,
            wing_hw=wing_hw).max()),
        profile="ht", subsets=cf_subsets, near_width=near_width)
    if not cf_subsets:
        coarse = None
    coarse_modes = ("sdvoigt", "full") if coarse else ()

    calls = []
    for mode, idx, cap in subsets:
        if not idx.size:
            continue
        if mode in coarse_modes:
            # the coarse far field replaces the wing passes; the core
            # corrections stay as classic passes on per-line tight windows
            core_w = np.max([core_wing_per_line(lines_h, iso_h, st)
                             for st in states_h], axis=0)[idx]
            if mode == "sdvoigt":
                core_w = np.maximum(core_w, np.max(
                    [sdvoigt_core_bound(lines_h, iso_h, st)
                     for st in states_h], axis=0)[:, idx].max(axis=0))
            core_w = np.minimum(core_w, float(wing_abs))
            c_tile = _pow2_tile(int(np.ceil(2.0 * core_w.max() / g.dx)),
                                lo=256, hi=512)
            calls.append((np.arange(n), idx,
                          plan_buckets_packed(nu0[idx], g, core_w,
                                              tile=c_tile, block=16),
                          "sdvoigt_core" if mode == "sdvoigt" else "core"))
            continue
        calls += _ht_group_calls(nu0, g, W, mode, idx, cap, tile, max_groups,
                                 group_ratio)
    passes = _device_passes(calls, coarse, lines_h, g, coarse_r, n_weideman,
                            n, dev, dt, fast_rcp)
    fn = HTCrossSectionFn(lines, iso, passes, resolved, wing_abs, wing_hw)
    fn.work_report = _work_report(calls, coarse, n_weideman, n)
    return fn


def make_od_ht_fn(lines, iso, grid, atmos_class, extras=None, wing_abs=0.0,
                  wing_hw=50.0, tile: int = 128, n_weideman: int = 16,
                  max_groups: int = 8, group_ratio: float = 4.0,
                  fast_rcp: bool = True, continuum: str = "none",
                  continuum_factors=None,
                  differentiable: bool = False) -> HTOpticalDepthFn:
    """Build the (T, p_pa, pl, vmr) -> (nLay, nX) Hartmann-Tran layer OD
    (the counterpart of ``make_od_ht_pallas_fn``, with its defaults): the
    routing of :func:`make_ht_fn` with atmosphere layers in the role of
    lattice states, the HT columns resolved for both diluents and mixed
    per layer as ``[1 - x_self, x_self]`` (the line's own-molecule vmr),
    column-density strengths, and the continuum term. The plans are sized
    on ``atmos_class`` with the air+self column sum (a bound on any mix).
    ``differentiable=True`` plans with the JAX builder's tangent-kernel
    block caps; the passes carry ``torch.func.jvp`` tangents through K6
    (``ht``), K4 (``sdvoigt``) and K3 (``full``) either way.
    ``fast_rcp``: the kernels' fast reciprocal (K5, K4, K3 and K1; K6
    divides in IEEE, as JAX's).
    """
    _check_build_opts(tile=tile)
    g = _uniform_grid(grid)
    dev, dt = lines.sw.device, lines.sw.dtype
    lines_h, iso_h, states_h = _host_planning_views(lines, iso, atmos_class)
    mol_ids = tuple(states_h[0].mol_ids)
    cols = torch.as_tensor(_line_species_cols(lines_h, mol_ids), device=dev)
    # placeholder abundances: the layer's mix is supplied per call
    resolved = resolve_ht_columns(lines, extras, {"air": 1.0, "self": 1.0})
    W = np.max([ht_wing_bounds(resolved, lines_h, iso_h, np.asarray(s.T),
                               np.asarray(s.p) / PA_PER_ATM,
                               wing_abs=wing_abs, wing_hw=wing_hw)
                for s in states_h], axis=0)
    nu0 = np.asarray(lines_h.nu0, dtype=np.float64)
    calls = []
    for mode, idx, cap in _ht_subsets(resolved, nu0.size, tile,
                                      differentiable):
        if idx.size:
            calls += _ht_group_calls(nu0, g, W, mode, idx, cap, tile,
                                     max_groups, group_ratio)
    n_lay = int(states_h[0].T.size)
    passes = _device_passes(calls, None, lines_h, g, 64, n_weideman, n_lay,
                            dev, dt, fast_rcp)
    cont = _make_continuum_term(g, mol_ids, continuum, continuum_factors,
                                dev, dt)
    fn = HTOpticalDepthFn(lines, iso, passes, resolved, cols, wing_abs,
                          wing_hw, cont)
    fn.work_report = _work_report(calls, None, n_weideman, n_lay)
    return fn


# --------------------------------------------------------------------------
# the layered-OD library API (compute_od_layers and its engines)
# --------------------------------------------------------------------------

def compute_od_layer(lines, iso, grid, T, p_pa, pl_km, vmr_row, species_cols,
                     profile: str = "voigt", wing_abs=0.0, wing_hw=50.0,
                     chunk: int = 512) -> torch.Tensor:
    """OD spectrum (nX,) of one homogeneous layer by the reference engine
    (:func:`~..kernels.xsect.xsect_from_params`) on the ``grid`` tensor:
    ``T``, ``p_pa`` and ``pl_km`` scalars, ``vmr_row`` (nM,), and
    ``species_cols`` (L,) each line's vmr column. ``profile`` reaches both
    the parameter rules and the line shape. NumPy values join the
    store's device in its dtype."""
    T, p_pa, pl_km, vmr_row = arrays_on(T, p_pa, pl_km, vmr_row,
                                        device=lines.sw.device,
                                        dtype=lines.sw.dtype)
    cols = torch.as_tensor(as_numpy(species_cols), dtype=torch.long,
                           device=vmr_row.device)
    u = species_column(p_pa, T, pl_km, vmr_row)
    params = compute_line_params(lines, iso, T, p_pa / PA_PER_ATM,
                                 vmr_self=vmr_row[cols], wing_abs=wing_abs,
                                 wing_hw=wing_hw, strength_scale=u[cols],
                                 profile=profile)
    return xsect_from_params(grid, params, profile=profile, chunk=chunk)


def _grid_values(grid) -> np.ndarray:
    """The float64 host values of an axis or a :class:`UniformGrid`."""
    return (grid.values() if isinstance(grid, UniformGrid)
            else as_numpy(grid).astype(np.float64))


#: the Pallas kernels' evaluation options that have no counterpart here
_TPU_ONLY_OPTS = {
    "interpret": "the port runs a kernel's plain version for CPU inputs",
}


def _od_layers_pallas(lines, iso, grid, atmos, profile="voigt",
                      wing_abs=0.0, wing_hw=50.0, plan=None, **pallas_opts):
    """``compute_od_layers(engine='pallas')`` (``_od_layers_pallas``
    there): a prebuilt ``plan`` runs the unfused kernel K7 on the layers'
    line parameters (Voigt only, kernel options only: ``n_weideman`` and
    ``fast_rcp``, False unless given, as ``xsect_pallas``); otherwise the
    builders (:func:`make_od_fn`, :func:`make_od_ht_fn`) plan and run the
    state."""
    if profile == "ht":
        if plan is not None:
            raise ValueError("prebuilt plan= supports Voigt only")
        fn = make_od_ht_fn(lines, iso, grid, atmos, wing_abs=wing_abs,
                           wing_hw=wing_hw, **pallas_opts)
        return fn(atmos.T, atmos.p, atmos.pl, atmos.vmr)
    if profile not in ("voigt", "sdvoigt", "lorentz", "doppler"):
        raise NotImplementedError(
            "pallas engine implements 'voigt', 'sdvoigt', 'lorentz', "
            f"'doppler' and 'ht'; use engine='jnp' for {profile!r}")
    if plan is None:
        fn = make_od_fn(lines, iso, grid, atmos, profile=profile,
                        wing_abs=wing_abs, wing_hw=wing_hw, **pallas_opts)
        return fn(atmos.T, atmos.p, atmos.pl, atmos.vmr)
    if profile != "voigt":
        raise ValueError(
            "prebuilt plan= supports Voigt only; sdvoigt needs the "
            "per-profile call split of make_od_fn(profile=...)")
    # with a prebuilt plan only kernel options apply; plan-building options
    # would be silently ignored, so they are refused
    eval_opts = {k: pallas_opts.pop(k) for k in ("n_weideman",)
                 if k in pallas_opts}
    if "fast_rcp" in pallas_opts:
        eval_opts["fast"] = bool(pallas_opts.pop("fast_rcp"))
    for k, why in _TPU_ONLY_OPTS.items():
        if pallas_opts.pop(k, False):
            raise NotImplementedError(f"{k}: {why}")
    if pallas_opts:
        raise ValueError(
            f"options {sorted(pallas_opts)} affect plan construction and "
            f"have no effect with a prebuilt plan=; build the plan with "
            f"them (make_od_plan/make_od_fn) instead")
    if _grid_values(grid).size != plan.grid.n:
        raise ValueError(f"the plan covers {plan.grid.n} grid points, the "
                         f"grid {_grid_values(grid).size}")
    cols = _line_species_cols(lines.host_view(), atmos.mol_ids)
    params = layer_line_params(lines, iso, atmos, cols, wing_abs=wing_abs,
                               wing_hw=wing_hw)
    return xsect_unfused(plan, params, **eval_opts)


def compute_od_layers(lines, iso, grid, atmos, profile: str = "voigt",
                      wing_abs: float = 0.0, wing_hw: float = 50.0,
                      chunk: int = 512, engine: str = "jnp", plan=None,
                      pallas_opts: dict | None = None,
                      continuum: str = "none", continuum_factors=None,
                      line_mixing: dict | None = None,
                      ht_extras: dict | None = None) -> torch.Tensor:
    """(nL, nX) optical-depth tensor of a layered atmosphere, on the device
    and in the dtype of ``lines`` (the counterpart of ``compute_od_layers``,
    with its signature, defaults and routing).

    ``engine='pallas'``: with a prebuilt ``plan`` (:func:`make_od_plan`,
    reused over an ensemble) the layers' line parameters go through the
    unfused kernel K7 (Voigt, 24 Weideman terms unless
    ``pallas_opts={'n_weideman': n}``); without one, :func:`make_od_fn`
    (Voigt, SD-Voigt, Lorentz, Doppler, ``line_mixing``) or
    :func:`make_od_ht_fn` (``profile='ht'``, ``ht_extras``) plans and runs
    the state, ``pallas_opts`` passed to them. Any other engine (the
    default ``'jnp'``, ``'auto'``) runs the reference engine layer by layer
    (:func:`compute_od_layer`; with ``line_mixing``, the Voigt mixing
    engine clamped at zero; ``profile='ht'``, the complex pcqsdhc with
    the air/self diluent mix [1 - x_self, x_self] of each layer and
    ``ht_extras``' columns); it runs under forward-mode AD
    (``torch.func.jvp``), line mixing included. ``continuum`` adds
    :func:`~..atmos.continuum.continuum_od` of that model ('mt_ckd'
    evaluated pointwise), ``continuum_factors`` the 7 TAPE5 record-1.2a
    scale factors. CUDA inputs run the kernels; CPU inputs their plain
    versions.
    """
    dev, dt = lines.sw.device, lines.sw.dtype
    if engine == "pallas":
        opts = dict(pallas_opts or {})
        if line_mixing is not None:
            if profile == "ht":
                raise NotImplementedError(
                    "line mixing composes with Voigt only")
            opts.setdefault("line_mixing", line_mixing)
        if profile == "ht" and ht_extras is not None:
            opts.setdefault("extras", ht_extras)
        od = _od_layers_pallas(lines, iso, grid, atmos, profile=profile,
                               wing_abs=wing_abs, wing_hw=wing_hw, plan=plan,
                               **opts)
    else:
        if line_mixing is not None and profile != "voigt":
            raise NotImplementedError("line mixing composes with Voigt only")
        cols = _line_species_cols(lines.host_view(), atmos.mol_ids)
        X = torch.as_tensor(_grid_values(grid), dtype=dt, device=dev)
        layers = zip(atmos.T, atmos.p, atmos.pl, atmos.vmr)
        if profile == "ht":
            resolved = resolve_ht_columns(lines, ht_extras,
                                          {"air": 1.0, "self": 1.0})
            od = torch.stack([
                _ht_layer(lines, iso, X, resolved, T, p, pl, vmr, cols,
                          wing_abs, wing_hw, chunk)
                for T, p, pl, vmr in layers])
        elif line_mixing is None:
            od = torch.stack([
                compute_od_layer(lines, iso, X, T, p, pl, vmr, cols,
                                 profile=profile, wing_abs=wing_abs,
                                 wing_hw=wing_hw, chunk=chunk)
                for T, p, pl, vmr in layers])
        else:
            od = torch.clamp(torch.stack([
                _mixing_layer(lines, iso, X, T, p, pl, vmr, cols,
                              line_mixing, wing_abs, wing_hw, chunk)
                for T, p, pl, vmr in layers]), min=0.0)
    if continuum != "none":
        from ..atmos.continuum import continuum_od

        nu = torch.as_tensor(_grid_values(grid), dtype=od.dtype,
                             device=od.device)
        od = od + continuum_od(nu, atmos, model=continuum,
                               continuum_factors=continuum_factors
                               ).to(od.dtype)
    return od


def _ht_layer(lines, iso, X, resolved, T, p_pa, pl, vmr, cols, wing_abs,
              wing_hw, chunk):
    """One layer's HT OD by the reference engine (the HT branch of
    ``compute_od_layers`` there): the diluent mix [1 - x_self, x_self],
    the species column as the strength scale."""
    cols_t = torch.as_tensor(cols, dtype=torch.long, device=X.device)
    x_self = vmr[cols_t]
    u = species_column(p_pa, T, pl, vmr)
    prm = ht_params(resolved, lines, iso, T, p_pa / PA_PER_ATM,
                    wing_abs=wing_abs, wing_hw=wing_hw,
                    complex_dtype=_complex_of(X.dtype),
                    abun=[1.0 - x_self, x_self])
    return ht_xsect_from_params(X, lines.nu0, prm, chunk=chunk,
                                strength_scale=u[cols_t])


def _mixing_layer(lines, iso, X, T, p_pa, pl, vmr, cols, line_mixing,
                  wing_abs, wing_hw, chunk):
    """One layer's OD with first-order line mixing by the reference engine
    (the mixing branch of ``compute_od_layers`` there), before the clamp:
    first-order mixing can leave small negative excursions next to a Q
    branch (a truncation artefact; LTE absorption is nonnegative)."""
    dt, dev = X.dtype, X.device
    cols_t = torch.as_tensor(cols, dtype=torch.long, device=dev)
    as_t = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        as_numpy(a), dtype=dt, device=dev)
    p_atm = p_pa / PA_PER_ATM
    u = species_column(p_pa, T, pl, vmr)
    prm = compute_line_params(lines, iso, T, p_atm, vmr_self=vmr[cols_t],
                              wing_abs=wing_abs, wing_hw=wing_hw,
                              strength_scale=u[cols_t])
    Y = mixing_coefficient(as_t(line_mixing["y_air"]), p_atm, T,
                           y_self=as_t(line_mixing.get("y_self")),
                           x_self=vmr[cols_t],
                           n_T=float(line_mixing.get("n_T", 0.0)))
    return xsect_voigt_mixing(X, prm, Y, chunk=chunk)
