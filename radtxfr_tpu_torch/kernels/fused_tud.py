"""Fused TUD composition (K2): tau / Lu / Ld in one pass per column.

Counterpart of ``radtxfr_tpu/kernels/pallas_tud.py``. :func:`tud_compose`
launches the hand-written CUDA kernel (``csrc/fused_tud.cu``) for CUDA
tensors and runs the plain PyTorch version :func:`tud_compose_plain` for
CPU tensors; :data:`LAUNCHES` counts kernel launches. Forward only, as in
JAX (``pallas_tud.py:47-49``).

Both modes of the Pallas kernel: the Planck source computed in-kernel from
the wavenumbers and the reciprocal layer temperatures, B = c1 1e4 nu^3 /
expm1(c2 nu / T_l) with nu = 100 x (the units of ``pallas_tud.py:110-113``),
or, given ``B`` (nL, nX), read from it (``planck=False``).
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import check_tensor
from ..core.constants import C1, C2

__all__ = ["tud_compose", "tud_compose_plain", "check_launch_shape",
           "LAUNCHES"]

#: kernel launches since the last reset (plain runs not counted), per mode:
#: ``tud`` (Planck source in-kernel) and ``tud_b`` (``B`` an input)
LAUNCHES = {"tud": 0, "tud_b": 0}

#: sensor altitudes the kernel takes (one 64-bit mask per layer)
MAX_ALTITUDES = 64
#: columns a CTA (csrc: TPB) and the dynamic shared memory a CTA may take
#: on sm_90 (227 KB)
TPB = 64
MAX_SMEM = 227 * 1024


def smem_bytes(n_lay, n_zs, n_mu):
    """Dynamic shared memory of one kernel CTA: a 64-bit altitude mask a
    layer boundary, the source of its TPB columns a layer, and its staged
    tau and Lu."""
    return 8 * (n_lay + 1) + 4 * TPB * (n_lay + 2 * n_zs * n_mu)


def check_launch_shape(n_lay, n_zs, n_mu):
    """Raise ValueError for a shape the kernel cannot take: more than
    :data:`MAX_ALTITUDES` altitudes, or a CTA's shared memory over
    :data:`MAX_SMEM`."""
    if n_zs > MAX_ALTITUDES:
        raise ValueError(f"the fused composition takes at most "
                         f"{MAX_ALTITUDES} sensor altitudes, got {n_zs}")
    need = smem_bytes(n_lay, n_zs, n_mu)
    if need > MAX_SMEM:
        raise ValueError(f"the fused composition of {n_lay} layers and "
                         f"{n_zs} altitudes x {n_mu} secants needs {need} "
                         f"bytes of shared memory a CTA, over the card's "
                         f"{MAX_SMEM}")


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
    if od.device.type != "cuda":
        raise ValueError(f"unsupported device {od.device}")
    dev = od.device
    if od.dim() != 2:
        raise ValueError(f"od must be (nL, nX), got {tuple(od.shape)}")
    n_lay, n_x = od.shape
    f32 = torch.float32
    check_tensor("od", od, f32, dev, (n_lay, n_x))
    if B is None:
        check_tensor("x", x, f32, dev, (n_x,))
        check_tensor("inv_t", inv_t, f32, dev, (n_lay,))
        src, aux = x, inv_t
    else:
        check_tensor("B", B, f32, dev, (n_lay, n_x))
        src, aux = B, B
    check_tensor("mus", mus, f32, dev, (mus.numel(),))
    check_tensor("snap", snap, torch.int32, dev, (snap.numel(),))
    check_tensor("sec", sec, f32, dev, (sec.numel(),))
    check_tensor("w", w, f32, dev, (sec.numel(),))
    n_mu, n_zs, n_a = mus.numel(), snap.numel(), sec.numel()
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
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_tud kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES["tud" if B is None else "tud_b"] += 1
    return tau, lu, ld
