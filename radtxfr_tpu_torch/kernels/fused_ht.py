"""The layered Hartmann-Tran line-shape accumulation (K5) and its
forward-mode derivative (K6): the counterpart of the HT part of
``radtxfr_tpu/kernels/pallas_xsect.py`` (``_make_fused_ht_kernel``,
``_make_fused_ht_jvp_kernel``, ``xsect_ht_pallas``,
``xsect_fused_ht_diff``; ``:925-1209``).

For each plan slot and layer the pass adds, inside hapi's window
-wingu < u <= wingu (wingu = min(wing, the plan's wing cap)/dx),

    strength * pcqsdhc_real(u dx, the 11 constants of the (layer, line))

with the constants of :func:`~.htp_real.ht_line_constants`
(:data:`~.htp_real.HT_CONST_KEYS` order). :func:`xsect_ht` launches K5
(``csrc/fused_ht.cu``) for CUDA tensors and runs :func:`xsect_ht_plain`
for CPU tensors; :func:`xsect_ht_jvp` likewise K6 or
:func:`xsect_ht_jvp_plain`, the directional derivative w.r.t. the strength
and the 11 constants for a batch of directions, non-finite tangents zeroed
(``pallas_xsect.py:1127``). Launches count in
:data:`~.fused_xsect.LAUNCHES` under ``"ht"`` (``"ht+fast"``: K5's FAST
instantiation, ``fast=True``, JAX's ``fast_rcp``) and ``"ht_jvp"``; K6 has
no FAST instantiation (JAX's tangent kernel forces ``fast=False``). On
the CPU the plain versions divide in IEEE, as JAX's interpret mode; on
the card :func:`xsect_ht_plain` with ``fast`` takes K5's FAST reciprocal
(``fused_xsect.plain_rcp``), to hold that instantiation against.

:func:`xsect_ht_diff` is the differentiable pass (a
:class:`torch.autograd.Function` in the ``setup_context`` form, like
:func:`~.fused_xsect.xsect_fused_diff`): K5 for the value, K6 for
``torch.func.jvp`` tangents, whose ``vmap`` rule makes a batch of
directions K6's direction axis. The wing's tangent is dropped.
"""

from __future__ import annotations

import torch

from .. import _build
from .faddeeva import weideman_coeffs
from .fused_xsect import (_JVP_MAX_DIRS, DevicePlan, _check_call, _count,
                          _off_ptr, _plain_steps, _tangent_launches,
                          _weideman_table, diff_pass, launch_key, plain_rcp)
from .htp_real import HT_CONST_KEYS, _pcqsdhc_terms, pcqsdhc_real

__all__ = ["xsect_ht", "xsect_ht_plain", "xsect_ht_jvp",
           "xsect_ht_jvp_plain", "xsect_ht_diff", "HT_JVP_DIRS"]

#: tangent directions one K6 launch carries at most, as K3's (K6's rows are
#: (direction, layer) pairs, each evaluating one direction's tangent); a
#: batch of more runs in chunks of this many
HT_JVP_DIRS = _JVP_MAX_DIRS
#: the plain versions keep a few hundred temporaries per element: their
#: steps take this fraction of the Voigt plain version's elements (each
#: step's operations are launched one by one, so steps are as large as the
#: memory allows)
_PLAIN_SHRINK = 2
_N_CONST = len(HT_CONST_KEYS)


def _slot_params(dplan: DevicePlan, lay_idx, strength, wing, consts):
    """(nl, n_slots) strength, wingu and constants of each (layer, slot),
    padding slots filled as the Pallas wrapper pads them (strength 0,
    cte 1, the other constants 0, wing 0)."""
    lay = lay_idx.long()
    valid = dplan.line >= 0
    safe = torch.where(valid, dplan.line, 0).long()
    dt, dev = strength.dtype, strength.device

    def take(a, fill):
        return torch.where(valid, a[lay][:, safe],
                           torch.tensor(fill, dtype=dt, device=dev))

    k = {key: take(c, 1.0 if key == "cte" else 0.0)
         for key, c in zip(HT_CONST_KEYS, consts)}
    w = torch.minimum(wing[lay][:, safe], dplan.wcap.to(dt))
    wingu = torch.where(valid, w / dplan.dx,
                        torch.tensor(0.0, dtype=dt, device=dev))
    return take(strength, 0.0), wingu, k


def _check_consts(dplan, consts):
    """The HT passes run on the DevicePlan of a packed plan (as
    ``xsect_ht_pallas`` requires one, ``pallas_xsect.py:1035-1037``) with
    the 11 constants."""
    if not isinstance(dplan, DevicePlan):
        raise ValueError("the HT passes need the DevicePlan of a packed plan "
                         "(device_plan(plan_buckets_packed(...)))")
    if len(consts) != _N_CONST:
        raise ValueError(f"expected the {_N_CONST} HT constants "
                         f"{HT_CONST_KEYS}, got {len(consts)}")


def xsect_ht_plain(dplan: DevicePlan, lay_idx, strength, wing, consts,
                   n_weideman: int = 16, fast: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K5, in the parameters' dtype on their
    device: (len(lay_idx), n_out). ``strength``, ``wing`` and the 11
    ``consts`` are (nLay, L) rows over the full line list; the plan's slots
    index them through ``dplan.line``. ``fast``: the FAST instantiation's
    reciprocal at the w(Z) forms on float32 card tensors, IEEE division
    otherwise (``fused_xsect.plain_rcp``)."""
    _check_consts(dplan, consts)
    s, wingu, k = _slot_params(dplan, lay_idx, strength, wing, consts)
    nl = s.shape[0]
    L_w, a_w = weideman_coeffs(n_weideman)
    rcp = plain_rcp(fast, s)
    out = torch.zeros((nl, dplan.n_tiles, dplan.tile), dtype=s.dtype,
                      device=s.device)
    for t_i, slots, u in _plain_steps(dplan, nl * _PLAIN_SHRINK, s.dtype):
        kk = {key: v[:, slots][..., None] for key, v in k.items()}
        wu = wingu[:, slots][..., None]
        val = s[:, slots][..., None] * _pcqsdhc_terms(u * dplan.dx, kk,
                                                      a_w, L_w, rcp)
        mask = (u > -wu) & (u <= wu)
        out[:, t_i] += torch.where(mask, val, 0.0).sum(dim=2)
    return out.reshape(nl, -1)[:, :dplan.n_out]


def xsect_ht_jvp_plain(dplan: DevicePlan, lay_idx, strength, wing, consts,
                       strength_t, consts_t,
                       n_weideman: int = 16) -> torch.Tensor:
    """Plain PyTorch version of K6: ``torch.func.jvp`` of
    ``strength * pcqsdhc_real`` per (layer, slot, point) w.r.t. the strength
    and the 11 constants, non-finite tangents zeroed, masked and summed
    (the JAX kernel's definition, ``pallas_xsect.py:1107-1129``), the
    directions under one ``vmap``; layers without a non-zero tangent are
    zero, as in K6. Tangents are (nd, nLay, L); returns (nd, len(lay_idx),
    n_out)."""
    _check_consts(dplan, consts)
    _check_consts(dplan, consts_t)
    s, wingu, k = _slot_params(dplan, lay_idx, strength, wing, consts)
    nd, nl = strength_t.shape[0], s.shape[0]
    dt, dev = s.dtype, s.device
    lay = lay_idx.long()
    out = torch.zeros((nd, nl, dplan.n_tiles, dplan.tile), dtype=dt,
                      device=dev)
    live = torch.zeros(nl, dtype=torch.bool, device=dev)
    for t in (strength_t, *consts_t):
        live |= (t[:, lay] != 0).any(dim=2).any(dim=0)
    rows = torch.nonzero(live).reshape(-1)
    if rows.numel() == 0 or nd == 0:
        return out.reshape(nd, nl, -1)[:, :, :dplan.n_out]
    valid = dplan.line >= 0
    safe = torch.where(valid, dplan.line, 0).long()

    def take_t(a):
        return torch.where(valid, a[:, lay[rows]][:, :, safe],
                           torch.zeros((), dtype=dt, device=dev))

    s_t = take_t(strength_t)
    k_t = [take_t(c) for c in consts_t]
    s, wingu = s[rows], wingu[rows]
    k = {key: v[rows] for key, v in k.items()}
    L_w, a_w = weideman_coeffs(n_weideman)
    for t_i, slots, u in _plain_steps(dplan, rows.numel() * _PLAIN_SHRINK
                                      * (nd + 1), dt):
        dnu = u * dplan.dx
        wu = wingu[:, slots][..., None]

        def f(sc, cv):
            return sc * pcqsdhc_real(dnu, dict(zip(HT_CONST_KEYS, cv)),
                                     wei_a=a_w, wei_L=L_w)

        prim = (s[:, slots][..., None],
                tuple(k[key][:, slots][..., None] for key in HT_CONST_KEYS))
        tan = torch.func.vmap(lambda st, ct: torch.func.jvp(
            f, prim, (st, ct))[1])(s_t[:, :, slots][..., None],
                                   tuple(c[:, :, slots][..., None]
                                         for c in k_t))
        tan = torch.where(torch.isfinite(tan), tan, 0.0)
        mask = (u > -wu) & (u <= wu)
        out[:, rows[:, None], t_i] += torch.where(mask, tan, 0.0).sum(dim=3)
    return out.reshape(nd, nl, -1)[:, :, :dplan.n_out]


def _ht_params(strength, wing, consts) -> dict:
    """The kernels' (nLay, L) parameter rows, in the order of their C
    entries: strength, wing, the 11 constants."""
    return dict(strength=strength, wing=wing,
                **dict(zip(HT_CONST_KEYS, consts)))


def xsect_ht(dplan: DevicePlan, lay_idx, strength, wing, consts,
             n_weideman: int = 16, fast: bool = False) -> torch.Tensor:
    """One HT pass: (len(lay_idx), n_out) float32 (``xsect_ht_pallas``).

    CPU tensors run :func:`xsect_ht_plain`. CUDA tensors launch K5 on the
    current stream (``fast``: its FAST instantiation, JAX's ``fast_rcp``);
    anything it does not take (another dtype than float32, non-contiguous
    or mismatched shapes, mixed devices) raises, as does a non-zero CUDA
    error from the launch.
    """
    if strength.device.type == "cpu":
        return xsect_ht_plain(dplan, lay_idx, strength, wing, consts,
                              n_weideman, fast)
    _check_consts(dplan, consts)
    params = _ht_params(strength, wing, consts)
    _check_call(dplan, lay_idx, params, n_weideman)
    dev = strength.device
    n_lay_call = lay_idx.numel()
    n_lay, n_lines = strength.shape
    out = torch.empty((n_lay_call, dplan.n_out), dtype=torch.float32,
                      device=dev)
    if n_lay_call == 0 or dplan.n_out == 0:
        return out
    wei = _weideman_table(n_weideman, dev)
    err = _build.entry("radtxfr_fused_ht", fast)(
        dplan.starts.data_ptr(), dplan.counts.data_ptr(),
        dplan.k_line.data_ptr(), dplan.frac0.data_ptr(),
        dplan.line.data_ptr(), dplan.wcap.data_ptr(), _off_ptr(dplan),
        lay_idx.data_ptr(), n_lay_call,
        *(p.data_ptr() for p in params.values()), n_lay,
        n_lines, wei.data_ptr(), n_weideman, dplan.tile, dplan.block,
        dplan.n_tiles, dplan.n_out, dplan.dx, out.data_ptr(),
        _build.launch_stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_ht kernel (fast={fast}) launch failed "
                           f"with CUDA error {err}")
    _count(launch_key("ht", fast), dplan)
    return out


def xsect_ht_jvp(dplan: DevicePlan, lay_idx, strength, wing, consts,
                 strength_t, consts_t, n_weideman: int = 16) -> torch.Tensor:
    """The tangent of one HT pass for nd directions: (nd, len(lay_idx),
    n_out) float32 from (nd, nLay, L) tangents of the strength and the 11
    constants.

    CPU tensors run :func:`xsect_ht_jvp_plain`. CUDA tensors launch K6
    (one CTA per (128-point slice, 4 (direction, layer) rows), the rows
    whose direction has no non-zero tangent on their layer written as zeros
    without staging) once per :data:`HT_JVP_DIRS` directions on the current
    stream; anything it does not take raises, as does a non-zero CUDA error
    from a launch.
    """
    if strength.device.type == "cpu":
        return xsect_ht_jvp_plain(dplan, lay_idx, strength, wing, consts,
                                  strength_t, consts_t, n_weideman)
    _check_consts(dplan, consts)
    _check_consts(dplan, consts_t)
    return _tangent_launches(
        "radtxfr_fused_ht_jvp", "ht_jvp", dplan, lay_idx,
        _ht_params(strength, wing, consts),
        dict(strength_t=strength_t,
             **{f"{k}_t": t for k, t in zip(HT_CONST_KEYS, consts_t)}),
        n_weideman)


# --------------------------------------------------------------------------
# the differentiable pass (torch.func.jvp / vmap)
# --------------------------------------------------------------------------

# K5 with K6 (IEEE whatever fast, as JAX's); prm (strength, wing, the 11
# constants)
_HT = diff_pass(
    "HT",
    lambda dplan, lay, n, fast, s, w, *consts: xsect_ht(
        dplan, lay, s, w, consts, n, fast),
    lambda dplan, lay, n, fast, prm, tans: xsect_ht_jvp(
        dplan, lay, prm[0], prm[1], prm[2:], tans[0], tans[1:], n),
    diff=(0, *range(2, 2 + _N_CONST)))


def xsect_ht_diff(dplan: DevicePlan, lay_idx, strength, wing, consts,
                  n_weideman: int = 16, fast: bool = False) -> torch.Tensor:
    """The HT pass, differentiable in forward mode: K5 for the value (its
    FAST instantiation with ``fast``), K6 for ``torch.func.jvp`` tangents
    through the strength and the 11 constants (a ``vmap`` over directions
    becomes K6's direction axis; IEEE division, as JAX's tangent kernel).
    (len(lay_idx), n_out)."""
    _check_consts(dplan, consts)
    return _HT.apply(dplan, lay_idx, n_weideman, fast, strength, wing,
                     *consts)
