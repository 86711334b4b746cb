"""Fused TUD composition (K2): tau / Lu / Ld in one pass per column.

Counterpart of ``radtxfr_tpu/kernels/pallas_tud.py``. :func:`tud_compose`
launches the hand-written CUDA kernel (``csrc/fused_tud.cu``) for CUDA
tensors and runs the plain PyTorch version :func:`tud_compose_plain` for
CPU tensors; :data:`LAUNCHES` counts kernel launches.

Both modes of the Pallas kernel: the Planck source computed in-kernel from
the wavenumbers and the reciprocal layer temperatures, B = c1 1e4 nu^3 /
expm1(c2 nu / T_l) with nu = 100 x (the units of ``pallas_tud.py:110-113``),
or, given ``B`` (nL, nX), read from it (``planck=False``).

Beyond JAX (whose Pallas kernel is forward only, ``pallas_tud.py:47-49``):
K2's tangent mode, :func:`tud_compose_jvp` (plain version
:func:`tud_compose_jvp_plain`), the forward-mode derivative of the Planck
mode in the layer ODs and temperatures for a batch of directions in one
launch, and :func:`tud_compose_diff`, the Planck mode differentiable under
``torch.func.jvp`` and ``vmap``: K2 for the value, the tangent mode for
the tangents, a ``vmap`` over directions its direction axis.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import check_tensor
from ..core.constants import C1, C2

__all__ = ["tud_compose", "tud_compose_plain", "tud_compose_jvp",
           "tud_compose_jvp_plain", "tud_compose_diff", "check_launch_shape",
           "LAUNCHES"]

#: kernel launches since the last reset (plain runs not counted), per mode:
#: ``tud`` (Planck source in-kernel), ``tud_b`` (``B`` an input) and
#: ``tud_jvp`` (the tangent mode, one a batch of directions)
LAUNCHES = {"tud": 0, "tud_b": 0, "tud_jvp": 0}

#: sensor altitudes the kernel takes (one 64-bit mask per layer)
MAX_ALTITUDES = 64
#: columns a CTA (csrc: TPB) and the dynamic shared memory a CTA may take
#: on sm_90 (227 KB)
TPB = 64
MAX_SMEM = 227 * 1024
#: directions the tangent mode carries at once, and the downwelling angles
#: one chunk of its sensitivity sweep holds (csrc: DCH, TACH)
DCH = 8
TACH = 32


def smem_bytes(n_lay, n_zs, n_mu):
    """Dynamic shared memory of one kernel CTA: a 64-bit altitude mask a
    layer boundary, the source of its TPB columns a layer, and its staged
    tau and Lu."""
    return 8 * (n_lay + 1) + 4 * TPB * (n_lay + 2 * n_zs * n_mu)


def smem_bytes_jvp(n_lay, n_angles):
    """Dynamic shared memory of one tangent-mode CTA: the altitude masks,
    the prefix OD and the downwelling's two sensitivities of its TPB
    columns a layer (one sensitivity in the prefix OD's place when one
    chunk of :data:`TACH` holds every angle), and a chunk's DCH
    temperature tangents a layer."""
    per = 3 if n_angles > TACH else 2
    return 8 * (n_lay + 1) + 4 * (per * TPB + DCH) * n_lay


def check_launch_shape(n_lay, n_zs, n_mu, jvp_angles=None):
    """Raise ValueError for a shape the kernel (given ``jvp_angles``, its
    tangent mode with that many downwelling angles) cannot take: more than
    :data:`MAX_ALTITUDES` altitudes, or a CTA's shared memory over
    :data:`MAX_SMEM`."""
    if n_zs > MAX_ALTITUDES:
        raise ValueError(f"the fused composition takes at most "
                         f"{MAX_ALTITUDES} sensor altitudes, got {n_zs}")
    jvp = jvp_angles is not None
    need = (smem_bytes_jvp(n_lay, jvp_angles) if jvp
            else smem_bytes(n_lay, n_zs, n_mu))
    if need > MAX_SMEM:
        raise ValueError(f"the fused composition{'s tangent' if jvp else ''}"
                         f" of {n_lay} layers and {n_zs} altitudes x {n_mu} "
                         f"secants needs {need} bytes of shared memory a "
                         f"CTA, over the card's {MAX_SMEM}")


def tud_compose_plain(od, x, inv_t, mus, snap, sec, w, return_od=False,
                      B=None):
    """Plain PyTorch version of the fused composition.

    ``od`` (nL, nX); ``x`` (nX,) wavenumbers [cm^-1]; ``inv_t`` (nL,)
    reciprocal layer temperatures; ``mus`` (nMu,) slant secants; ``snap``
    (nZs,) int layer count below each sensor altitude; ``sec``/``w`` (nA,)
    downwelling secants and normalized weights; ``B`` (nL, nX), when given,
    the Planck source (``x`` and ``inv_t`` are then not read). Returns tau,
    Lu (nX, nZs, nMu) and Ld (nX,) in ``od``'s dtype.
    """
    n_lay, n_x = od.shape
    mus = [float(m) for m in torch.as_tensor(mus).tolist()]
    snap = [int(s) for s in torch.as_tensor(snap).tolist()]
    if B is None:
        nu = x * 100.0
        a3 = (nu * nu * nu) * (C1 * 1e4)
        B = a3[None, :] / torch.expm1((nu * C2)[None, :] * inv_t[:, None])
    tau = torch.empty((n_x, len(snap), len(mus)), dtype=od.dtype,
                      device=od.device)
    lu_out = torch.empty_like(tau)
    for zi, s in enumerate(snap):
        if s == 0:
            tau[:, zi, :] = 0.0 if return_od else 1.0
            lu_out[:, zi, :] = 0.0
    for j, m in enumerate(mus):
        t = torch.exp(od * -m)
        cum = torch.zeros(n_x, dtype=od.dtype, device=od.device)
        lu = torch.zeros_like(cum)
        for l in range(n_lay):
            lu = t[l] * lu + (1.0 - t[l]) * B[l]
            cum = cum + od[l]
            for zi, s in enumerate(snap):
                if s == l + 1:
                    tau[:, zi, j] = (cum * m if return_od
                                     else torch.exp(cum * -m))
                    lu_out[:, zi, j] = lu
    ld = torch.zeros((sec.shape[0], n_x), dtype=od.dtype, device=od.device)
    for l in range(n_lay - 1, -1, -1):
        t = torch.exp(od[l][None, :] * -sec[:, None])
        ld = t * ld + (1.0 - t) * B[l][None, :]
    return tau, lu_out, (ld * w[:, None]).sum(dim=0)


def _check_launch(od, mus, snap, sec, w):
    """(device, nL, nX, nMu, nZs, nA) of a launch's OD and geometry; raises
    unless ``od`` is (nL, nX) and all are contiguous float32 (``snap``
    int32) on one CUDA device."""
    if od.device.type != "cuda":
        raise ValueError(f"unsupported device {od.device}")
    if od.dim() != 2:
        raise ValueError(f"od must be (nL, nX), got {tuple(od.shape)}")
    dev, f32 = od.device, torch.float32
    n_lay, n_x = od.shape
    check_tensor("od", od, f32, dev, (n_lay, n_x))
    check_tensor("mus", mus, f32, dev, (mus.numel(),))
    check_tensor("snap", snap, torch.int32, dev, (snap.numel(),))
    check_tensor("sec", sec, f32, dev, (sec.numel(),))
    check_tensor("w", w, f32, dev, (sec.numel(),))
    return dev, n_lay, n_x, mus.numel(), snap.numel(), sec.numel()


def tud_compose(od, x, inv_t, mus, snap, sec, w, return_od=False, B=None):
    """The fused composition: (tau, Lu, Ld) as in :func:`tud_compose_plain`.

    CPU tensors run the plain version. CUDA tensors launch the CUDA kernel
    on the current stream: ``od``, ``x``, ``inv_t`` (both unused and may be
    None when ``B`` is given), ``B``, ``mus``, ``sec`` and ``w`` float32 and
    ``snap`` int32, all contiguous on one device, in a shape that
    :func:`check_launch_shape` accepts; anything else raises, as does a
    non-zero CUDA error from the launch.
    """
    if od.device.type == "cpu":
        return tud_compose_plain(od, x, inv_t, mus, snap, sec, w, return_od,
                                 B)
    dev, n_lay, n_x, n_mu, n_zs, n_a = _check_launch(od, mus, snap, sec, w)
    f32 = torch.float32
    if B is None:
        check_tensor("x", x, f32, dev, (n_x,))
        check_tensor("inv_t", inv_t, f32, dev, (n_lay,))
        src, aux = x, inv_t
    else:
        check_tensor("B", B, f32, dev, (n_lay, n_x))
        src, aux = B, B
    check_launch_shape(n_lay, n_zs, n_mu)
    tau = torch.empty((n_x, n_zs, n_mu), dtype=f32, device=dev)
    lu = torch.empty_like(tau)
    ld = torch.empty((n_x,), dtype=f32, device=dev)
    if n_x == 0:
        return tau, lu, ld
    err = _build.library().radtxfr_fused_tud(
        od.data_ptr(), src.data_ptr(), aux.data_ptr(), int(B is None),
        n_lay, n_x, mus.data_ptr(), n_mu, snap.data_ptr(), n_zs,
        sec.data_ptr(), w.data_ptr(), n_a, int(bool(return_od)),
        tau.data_ptr(), lu.data_ptr(), ld.data_ptr(),
        _build.launch_stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_tud kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES["tud" if B is None else "tud_b"] += 1
    return tau, lu, ld


def _planck_and_slope(x, inv_t):
    """The source B (nL, nX) as K2 computes it and its temperature
    derivative dB/dT = B (x_l / T_l) (1 + 1 / expm1(x_l)), x_l = c2 nu /
    T_l."""
    nu = x * 100.0
    a3 = (nu * nu * nu) * (C1 * 1e4)
    xt = (nu * C2)[None, :] * inv_t[:, None]
    em1 = torch.expm1(xt)
    B = a3[None, :] / em1
    return B, B * (xt * inv_t[:, None]) * (1.0 + 1.0 / em1)


def tud_compose_jvp_plain(od, x, inv_t, mus, snap, sec, w, dod, dT):
    """Plain PyTorch version of K2's tangent mode, in the kernel's
    arithmetic.

    The arguments of :func:`tud_compose_plain` (the Planck source computed
    from ``x`` and ``inv_t``; transmittance, not path OD), and ``dod`` (nD,
    nL, nX) and ``dT`` (nD, nL), the directions' tangents of the layer ODs
    and temperatures. Returns the tangents of tau, Lu (nX, nZs, nMu) and Ld
    (nX,) (the primal is :func:`tud_compose_plain`'s): dtau, dLu (nD, nX,
    nZs, nMu) and dLd (nD, nX), in ``od``'s dtype. The up pass carries each
    direction's tangent layer by layer (dLu <- t dLu + dt (Lu - B) + (1 - t)
    dB, dt = -m t dod); Ld's tangent comes from its sensitivities to each
    layer's OD and source (``csrc/fused_tud.cu``, sweep B).
    """
    n_lay, n_x = od.shape
    n_d = dod.shape[0]
    opts = dict(dtype=od.dtype, device=od.device)
    mus = [float(m) for m in torch.as_tensor(mus).tolist()]
    snap = [int(s) for s in torch.as_tensor(snap).tolist()]
    B, dbdt = _planck_and_slope(x, inv_t)
    dB = dbdt[None] * dT[:, :, None]
    dtau = torch.empty((n_d, n_x, len(snap), len(mus)), **opts)
    dlu_out = torch.empty_like(dtau)
    for zi, s in enumerate(snap):
        if s == 0:
            dtau[:, :, zi, :] = 0.0
            dlu_out[:, :, zi, :] = 0.0
    for j, m in enumerate(mus):
        cum = torch.zeros(n_x, **opts)
        lu = torch.zeros_like(cum)
        dcum = torch.zeros((n_d, n_x), **opts)
        dlu = torch.zeros_like(dcum)
        for l in range(n_lay):
            t = torch.exp(od[l] * -m)
            diff = lu - B[l]
            dlu = t * (dlu - dB[:, l]) + (-m * t * diff) * dod[:, l] + dB[:, l]
            lu = B[l] + t * diff
            cum = cum + od[l]
            dcum = dcum + dod[:, l]
            for zi, s in enumerate(snap):
                if s == l + 1:
                    dtau[:, :, zi, j] = (-m * dcum) * torch.exp(cum * -m)
                    dlu_out[:, :, zi, j] = dlu
    # Ld's sensitivities, top down: T_a(l) = exp(-sec_a cum_l), cum_l the
    # OD below layer l; Ld = sum_a w_a sum_l (T_a(l) - T_a(l+1)) B_l
    cum = torch.cumsum(od, dim=0)
    below = torch.cat([torch.zeros((1, n_x), **opts), cum[:-1]])
    top = cum[-1] if n_lay else torch.zeros(n_x, **opts)
    sec_c, w_c = sec[:, None], w[:, None]
    tp = w_c * torch.exp(-sec_c * top[None, :])
    v = torch.zeros((sec.shape[0], n_x), **opts)
    s_od = torch.empty((n_lay, n_x), **opts)
    s_b = torch.empty_like(s_od)
    for l in range(n_lay - 1, -1, -1):
        tn = w_c * torch.exp(-sec_c * below[l][None, :])
        d = tn - tp
        s_od[l] = (sec_c * (tp * B[l] - v)).sum(dim=0)
        s_b[l] = d.sum(dim=0)
        v = v + d * B[l]
        tp = tn
    dld = (s_od[None] * dod).sum(dim=1) + (s_b[None] * dB).sum(dim=1)
    return dtau, dlu_out, dld


def tud_compose_jvp(od, x, inv_t, mus, snap, sec, w, dod, dT):
    """K2's tangent mode: (dtau, dLu, dLd) as in
    :func:`tud_compose_jvp_plain`, for every direction of ``dod`` (nD, nL,
    nX) and ``dT`` (nD, nL) in one launch.

    CPU tensors run the plain version. CUDA tensors launch the kernel's
    tangent mode on the current stream: the tensors of
    :func:`tud_compose`'s Planck mode, and ``dod`` and ``dT`` float32, all
    contiguous on one device, in a shape that :func:`check_launch_shape`
    (``jvp_angles``) accepts; anything else raises, as does a non-zero CUDA
    error from the launch. The primal is K2's (:func:`tud_compose`).
    """
    if od.device.type == "cpu":
        return tud_compose_jvp_plain(od, x, inv_t, mus, snap, sec, w, dod,
                                     dT)
    dev, n_lay, n_x, n_mu, n_zs, n_a = _check_launch(od, mus, snap, sec, w)
    f32 = torch.float32
    check_tensor("x", x, f32, dev, (n_x,))
    check_tensor("inv_t", inv_t, f32, dev, (n_lay,))
    n_d = dod.shape[0] if dod.dim() == 3 else -1
    check_tensor("dod", dod, f32, dev, (n_d, n_lay, n_x))
    check_tensor("dT", dT, f32, dev, (n_d, n_lay))
    check_launch_shape(n_lay, n_zs, n_mu, jvp_angles=n_a)
    dtau = torch.empty((n_d, n_x, n_zs, n_mu), dtype=f32, device=dev)
    dlu = torch.empty_like(dtau)
    dld = torch.empty((n_d, n_x), dtype=f32, device=dev)
    if n_x == 0:
        return dtau, dlu, dld
    err = _build.library().radtxfr_fused_tud_jvp(
        od.data_ptr(), x.data_ptr(), inv_t.data_ptr(), n_lay, n_x,
        mus.data_ptr(), n_mu, snap.data_ptr(), n_zs, sec.data_ptr(),
        w.data_ptr(), n_a, dod.data_ptr(), dT.data_ptr(), n_d,
        dtau.data_ptr(), dlu.data_ptr(), dld.data_ptr(),
        _build.launch_stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_tud tangent kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES["tud_jvp"] += 1
    return dtau, dlu, dld


# --------------------------------------------------------------------------
# the Planck mode, differentiable in forward mode (torch.func.jvp / vmap)
# --------------------------------------------------------------------------

def _unbatched(what, in_dims):
    if any(d is not None for d in in_dims):
        raise NotImplementedError(
            f"{what}: vmap over the layer ODs, wavenumbers, temperatures or "
            "geometry (a batch of states) is not supported; batch tangent "
            "directions instead")


def _tangents(od, x, T, mus, snap, sec, w, dod, dT):
    """(dtau, dLu, dLd) of the (nD, nL, nX) and (nD, nL) tangents."""
    return tud_compose_jvp(od, x, (1.0 / T).contiguous(), mus, snap, sec, w,
                           dod, dT)


class _ComposeTangent(torch.autograd.Function):
    """The tangents of :class:`_Compose` (one direction; under ``vmap`` the
    batch is the tangent mode's direction axis)."""

    @staticmethod
    def forward(od, x, T, mus, snap, sec, w, dod, dT):
        return tuple(a[0] for a in _tangents(
            od, x, T, mus, snap, sec, w, dod[None].contiguous(),
            dT[None].contiguous()))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, od, x, T, mus, snap, sec, w, dod, dT):
        _unbatched("the composition's tangent", in_dims[:7])
        dod, dT = (t.expand((info.batch_size,) + t.shape) if d is None
                   else t.movedim(d, 0)
                   for t, d in zip((dod, dT), in_dims[7:]))
        return (_tangents(od, x, T, mus, snap, sec, w, dod.contiguous(),
                          dT.contiguous()), (0, 0, 0))


class _Compose(torch.autograd.Function):
    """K2's Planck mode with a forward-mode rule: the tangents of the layer
    ODs and temperatures (a missing one zero; the wavenumbers and geometry
    take none) through the tangent mode."""

    @staticmethod
    def forward(od, x, T, mus, snap, sec, w):
        return tud_compose(od, x, (1.0 / T).contiguous(), mus, snap, sec, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, dod, _dx, dT, *_geometry):
        od, x, T, mus, snap, sec, w = ctx.saved_tensors
        dod = torch.zeros_like(od) if dod is None else dod
        dT = torch.zeros_like(T) if dT is None else dT
        return _ComposeTangent.apply(od, x, T, mus, snap, sec, w, dod, dT)

    @staticmethod
    def vmap(info, in_dims, od, x, T, mus, snap, sec, w):
        _unbatched("the composition", in_dims)
        return (_Compose.forward(od, x, T, mus, snap, sec, w),
                (None, None, None))


def tud_compose_diff(od, x, T, mus, snap, sec, w):
    """K2's Planck mode (transmittance), differentiable in forward mode:
    (tau, Lu, Ld) of :func:`tud_compose` from the layer temperatures ``T``
    (nL,) (not their reciprocals), K2 for the value and the tangent mode
    for ``torch.func.jvp`` tangents in ``od`` and ``T``; a ``vmap`` over
    directions of a ``jvp`` becomes the tangent mode's direction axis (one
    launch a batch). CPU tensors run both plain versions."""
    return _Compose.apply(od, x, T, mus, snap, sec, w)
