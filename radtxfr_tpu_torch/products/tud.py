"""TUD products: transmittance, upwelling and downwelling radiance
(counterpart of ``radtxfr_tpu/products/tud.py``).

Two compositions, spectral axis first at the public boundary:

* :func:`tud_from_od` — the plain composition (cumulative sums and layer
  loops over (nL, nX) tensors, any dtype), the counterpart of the XLA-scan
  path and the reference the fused kernel is tested against;
* :func:`make_tud_fn` — the fused kernel K2 (:mod:`..kernels.fused_tud`),
  float32, with the output shapes of ``make_tud_pallas_fn``: tau/Lu
  (nX, nZs, nMu) and Ld (nX,).

:func:`make_tud_diff_fn` is the composition the Jacobians differentiate in
forward mode: K2 and its tangent mode for a CUDA float32 OD, else the
plain one.

Downwelling always integrates all layers (the physically intended
behaviour, identical to the reference whenever the last sensor altitude is
the top of the atmosphere).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import arrays_on, as_numpy, resolve_device
from ..core.planck import planckian
from ..kernels.fused_tud import tud_compose, tud_compose_diff
from ..utils.profiling import span

__all__ = ["TUD", "tud_from_od", "make_tud_fn", "make_tud_diff_fn",
           "downwelling_angles", "downwelling_quadrature"]


@dataclasses.dataclass(frozen=True)
class TUD:
    """TUD product bundle (spectral axis first, reference units)."""

    X: torch.Tensor    # (nX,) wavenumber axis [cm^-1]
    tau: torch.Tensor  # (nX, nZs, nMu) transmittance (or path OD)
    Lu: torch.Tensor   # (nX, nZs, nMu) upwelling radiance [µW/(cm^2 sr cm^-1)]
    Ld: torch.Tensor   # (nX,) hemispherically averaged downwelling radiance

    def squeezed(self) -> "TUD":
        """Reference-style squeeze of singleton Zs/mu axes
        (radiative_transfer.py:357-365)."""
        tau, Lu = self.tau, self.Lu
        for ax in (2, 1):
            if tau.shape[ax] == 1:
                tau, Lu = tau.squeeze(ax), Lu.squeeze(ax)
        return dataclasses.replace(self, tau=tau, Lu=Lu)


def downwelling_angles(n_angles: int, dtype=torch.float64, device=None):
    """The reference's zenith quadrature: uniform [0, pi/2), endpoint
    excluded (radiative_transfer.py:368); ``device`` None is the card."""
    th = np.linspace(0.0, np.pi / 2.0, n_angles, endpoint=False)
    return torch.as_tensor(th, dtype=dtype, device=resolve_device(device))


def downwelling_quadrature(n_angles: int, kind: str = "uniform"):
    """Host-static (secants, normalized weights) for the hemispheric
    flux-weighted downwelling average 2 int_0^1 Ld(mu) mu dmu.

    ``'uniform'`` is the reference's rule: uniform theta on [0, pi/2),
    cos*sin weights (``radiative_transfer.py:368,387-388``); ``'gauss'`` is
    Gauss-Legendre in mu with weights 2 mu_i w_i.
    """
    if kind == "uniform":
        th = np.linspace(0.0, np.pi / 2.0, n_angles, endpoint=False)
        w = np.cos(th) * np.sin(th)
        return 1.0 / np.cos(th), w / w.sum()
    if kind == "gauss":
        x, w = np.polynomial.legendre.leggauss(n_angles)
        m = 0.5 * (x + 1.0)
        return 1.0 / m, m * w
    raise ValueError(f"unknown quadrature {kind!r} (use 'uniform' or 'gauss')")


def _layers_below(z0, altitudes) -> np.ndarray:
    """Number of layers whose bottom lies at or below each altitude."""
    z0 = as_numpy(z0, np.float64)
    alts = np.atleast_1d(as_numpy(altitudes, np.float64))
    return (z0[None, :] <= alts[:, None]).sum(axis=1)


def tud_from_od(grid, od, B, z0, altitudes, mu=1.0, n_angles: int = 30,
                return_od: bool = False, quadrature: str = "uniform",
                device=None) -> TUD:
    """Compose TUD products from a layer OD tensor (plain PyTorch).

    ``od``/``B`` (nL, nX) optical depth and Planck radiance per layer
    (ground first); ``z0`` (nL,) layer bottoms [km]; ``altitudes`` (nZs,)
    sensor altitudes [km]; ``mu`` scalar or (nMu,) slant secants. NumPy
    arrays join the tensors' device, or ``device`` (None: the card) when
    there is no tensor; the products are in ``od``'s dtype.

    Span ``tud``, holding ``tud.tau``, ``tud.lu`` and ``tud.ld`` (each
    around its whole block, the layer loops included).
    """
    with span("tud"):
        od, grid, B, z0, altitudes, mu = arrays_on(
            od, grid, B, z0, altitudes, mu, device=device, lead=True)
        dt, dev = od.dtype, od.device
        n_layers = od.shape[0]
        z0 = torch.as_tensor(z0, device=dev)
        alts = torch.atleast_1d(torch.as_tensor(altitudes, device=dev))
        n_below = (z0[None, :] <= alts[:, None]).sum(dim=1)
        gather_idx = torch.clamp(n_below - 1, 0, n_layers - 1)
        valid = n_below > 0
        mu = torch.atleast_1d(torch.as_tensor(mu, dtype=dt, device=dev))

        with span("tud.tau"):
            cum_od = torch.cumsum(od, dim=0)
            path_od = torch.where(valid[:, None], cum_od[gather_idx], 0.0)
            slant = path_od[None, :, :] * mu[:, None, None]  # (nMu, nZs, nX)
            tau = slant if return_od else torch.exp(-slant)

        with span("tud.lu"):
            lu = torch.zeros((mu.shape[0], od.shape[1]), dtype=dt, device=dev)
            lu_states = []
            for k in range(n_layers):
                t = torch.exp(-od[k][None, :] * mu[:, None])
                lu = t * lu + (1.0 - t) * B[k][None, :]
                lu_states.append(lu)
            Lu = torch.stack(lu_states)[gather_idx]          # (nZs, nMu, nX)
            Lu = torch.where(valid[:, None, None], Lu, 0.0).transpose(0, 1)

        with span("tud.ld"):
            sec_np, w_np = downwelling_quadrature(n_angles, quadrature)
            sec = torch.as_tensor(sec_np, dtype=dt, device=dev)
            w = torch.as_tensor(w_np, dtype=dt, device=dev)
            ld = torch.zeros((n_angles, od.shape[1]), dtype=dt, device=dev)
            for k in range(n_layers - 1, -1, -1):
                t = torch.exp(-od[k][None, :] * sec[:, None])
                ld = t * ld + (1.0 - t) * B[k][None, :]
            Ld = torch.sum(ld * w[:, None], dim=0)

        # (nMu, nZs, nX) -> (nX, nZs, nMu)
        return TUD(X=grid, tau=tau.permute(2, 1, 0), Lu=Lu.permute(2, 1, 0),
                   Ld=Ld)


def make_tud_fn(z0, altitudes, mu=1.0, n_angles: int = 30,
                quadrature: str = "uniform", return_od: bool = False,
                planck: bool = True, device=None):
    """Build the fused (K2) TUD composition for a static geometry.

    The altitude snapshot layer counts, slant secants and downwelling
    quadrature are host values, moved once to ``device`` (None: the card)
    as small arrays. Returns ``fn(x, od, T_layers) -> TUD`` when ``planck``
    (the Planck source computed in-kernel), else ``fn(x, od, B) -> TUD``
    with ``B`` (nL, nX) the source per layer, as ``make_tud_pallas_fn``;
    inputs are cast to float32, outputs have its shapes. ``fn`` is the
    span ``tud``.
    """
    f32 = torch.float32
    device = resolve_device(device)
    snap = torch.as_tensor(_layers_below(z0, altitudes), dtype=torch.int32,
                           device=device)
    mus = torch.as_tensor(np.atleast_1d(as_numpy(mu, np.float64)),
                          dtype=f32, device=device)
    sec_np, w_np = downwelling_quadrature(n_angles, quadrature)
    sec = torch.as_tensor(sec_np, dtype=f32, device=device)
    w = torch.as_tensor(w_np, dtype=f32, device=device)

    def fn(x, od, tb) -> TUD:
        with span("tud"):
            x = torch.as_tensor(x, dtype=f32, device=device).reshape(-1)
            od = torch.as_tensor(od, dtype=f32, device=device).contiguous()
            tb = torch.as_tensor(tb, dtype=f32, device=device)
            if planck:
                inv_t = (1.0 / tb.reshape(-1)).contiguous()
                tau, lu, ld = tud_compose(od, x.contiguous(), inv_t, mus,
                                          snap, sec, w, return_od)
            else:
                tau, lu, ld = tud_compose(od, None, None, mus, snap, sec, w,
                                          return_od, B=tb.contiguous())
            return TUD(X=x, tau=tau, Lu=lu, Ld=ld)

    return fn


def _k2_composes(od) -> bool:
    """Whether :func:`make_tud_diff_fn` composes ``od`` with K2: a CUDA
    float32 OD (what K2 takes), as K2's own wrapper decides."""
    return od.device.type == "cuda" and od.dtype == torch.float32


def make_tud_diff_fn(z0, altitudes, mu=1.0, n_angles: int = 30,
                     quadrature: str = "uniform", devices=None):
    """The TUD composition (transmittance) that the Jacobians differentiate
    in forward mode, for a static geometry: ``fn(x, od, T) -> (tau, Lu,
    Ld)`` from the layer ODs (nL, nX) and temperatures ``T`` (nL,), in
    ``od``'s dtype, with the shapes of :func:`tud_from_od`.

    The composition follows the OD it is given: a CUDA float32 OD composes
    with K2 differentiable in forward mode
    (:func:`~..kernels.fused_tud.tud_compose_diff`: K2 for the value, its
    tangent mode for a whole ``vmap`` batch of directions in one launch,
    the Planck source and its temperature derivative computed in the
    kernels), span ``tud``; any other (the CPU, float64) with
    :func:`~..core.planck.planckian` (span ``planck``) and
    :func:`tud_from_od`. The geometry is placed here, outside any
    ``torch.func`` transform, on each of ``devices`` (None: the card), the
    devices the ODs may lie on.
    """
    snap = _layers_below(z0, altitudes)
    mu_np = np.atleast_1d(as_numpy(mu, np.float64))
    sec, w = downwelling_quadrature(n_angles, quadrature)
    # per device (indexed, as a tensor's), the plain composition's (z0,
    # altitudes, secants) and K2's (secants, snapshot layer counts,
    # quadrature) in each float dtype an OD may have
    devices = {torch.empty(0, device=resolve_device(d)).device
               for d in devices or [None]}
    placed = {dev: (
        (torch.as_tensor(z0, device=dev),
         torch.atleast_1d(torch.as_tensor(altitudes, device=dev)),
         torch.as_tensor(mu_np, device=dev)),
        {dt: (torch.as_tensor(mu_np, dtype=dt, device=dev),
              torch.as_tensor(snap, dtype=torch.int32, device=dev),
              torch.as_tensor(sec, dtype=dt, device=dev),
              torch.as_tensor(w, dtype=dt, device=dev))
         for dt in (torch.float32, torch.float64)})
        for dev in devices}

    def fn(x, od, T):
        (z0_d, alts_d, mu_d), k2_geom = placed[od.device]
        if _k2_composes(od):
            with span("tud"):
                return tud_compose_diff(od, x.to(od.dtype).contiguous(),
                                        T.to(od.dtype), *k2_geom[od.dtype])
        with span("planck"):
            B = planckian(x, T).transpose(0, 1).to(od.dtype)
        tud = tud_from_od(x, od, B, z0_d, alts_d, mu=mu_d,
                          n_angles=n_angles, quadrature=quadrature)
        return tud.tau, tud.Lu, tud.Ld

    return fn
