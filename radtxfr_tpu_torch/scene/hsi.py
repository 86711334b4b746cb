"""Hyperspectral-imagery (HSI) scene generator (counterpart of
``radtxfr_tpu/scene/hsi.py``), the reference's ``LWIR_HSI_gen``
(``LWIR_HSI_Generator.py:109-179``): mixed-pixel at-sensor radiances over
randomly chosen atmospheric TUDs, emissivity end-members, per-pixel
material mixtures and Gaussian surface temperatures,

    L = tau * [ eps_eff * B(Ts + dT) + (1 - eps_eff) * Ld ] + Lu,
    eps_eff = sum_k f_k eps_k  (linear mixing, LWIR_HSI_Generator.py:30-42)

The draws come from an explicit ``torch.Generator`` (the JAX package's
``jax.random`` key; the streams differ, so only the deterministic
composition is comparable across packages), all atmospheres at once in
one batched pass (JAX's ``vmap``). The fractional abundances are the
reference's normalized uniforms (``:157-158``), not a symmetric Dirichlet.
"""

from __future__ import annotations

import torch

from .. import as_tensor_on
from ..core.planck import planckian

__all__ = ["hsi_generate"]


def _hsi_compose(X, tau, Lu, Ld, emis, atmos_labels, emis_labels, mix_frac,
                 Ts_pix) -> torch.Tensor:
    """L (n_atm, N, nX) of the scene the labels describe: ``atmos_labels``
    (n_atm,) rows of the (nA, nX) TUD, ``emis_labels`` (n_atm, N, n_mix)
    rows of ``emis`` (nE, nX), ``mix_frac`` (n_atm, N, n_mix) their
    fractions and ``Ts_pix`` (n_atm, N) the pixels' temperatures [K]."""
    em_eff = 0.0
    for m in range(emis_labels.shape[-1]):        # sum over the end-members
        em_eff = em_eff + mix_frac[..., m, None] * emis[emis_labels[..., m]]
    B = planckian(X, Ts_pix).permute(1, 2, 0)     # (n_atm, N, nX)
    sel = lambda a: a[atmos_labels][:, None, :]   # noqa: E731
    Ls = em_eff * B + (1.0 - em_eff) * sel(Ld)
    return sel(tau) * Ls + sel(Lu)


def _hsi_from_draws(X, tau, Lu, Ld, Ts, emis, atmos_labels, members, pick,
                    frac_u, z, dT) -> dict:
    """The scene of the raw draws: ``atmos_labels`` (n_atm,) TUD rows,
    ``members`` (n_atm, n_emis) DB rows, ``pick`` (n_atm, N, n_mix) indices
    into each atmosphere's members, ``frac_u`` (n_atm, N, n_mix) uniforms
    and ``z`` (n_atm, N) standard normals; ``hsi_generate``'s output."""
    emis_labels = torch.gather(
        members[:, None, :].expand(-1, pick.shape[1], -1), 2, pick)
    mix_frac = frac_u / frac_u.sum(dim=2, keepdim=True)
    Ts_pix = Ts[atmos_labels][:, None] + dT * z
    L = _hsi_compose(X, tau, Lu, Ld, emis, atmos_labels, emis_labels,
                     mix_frac, Ts_pix)
    return {"L": L, "atmos_labels": atmos_labels, "Ts_pix": Ts_pix,
            "emis_labels": emis_labels, "mix_frac": mix_frac}


def hsi_generate(generator: torch.Generator, X, tau, Lu, Ld, Ts, emis,
                 n_pixels: int = 100, dT: float = 3.0, n_emis: int = 6,
                 n_mix: int = 2, n_atm: int = 3, device=None,
                 dtype=None) -> dict:
    """Generate mixed-pixel apparent-radiance cubes.

    ``X`` (nX,) axis; ``tau``, ``Lu``, ``Ld`` (nA, nX) TUD ensemble
    (atmosphere-major); ``Ts`` (nA,) surface temperatures; ``emis`` (nE, nX)
    DB on the same axis; ``n_pixels``, ``dT``, ``n_emis``, ``n_mix``,
    ``n_atm`` the reference's N, dT, N_emis, N_mix, N_atm. The inputs are
    used on ``device`` in ``dtype`` (None: the device of the first tensor
    among ``tau``, ``X``, ``Lu``, ``Ld``, ``Ts``, ``emis``, else the card;
    ``tau``'s dtype); the draws come from ``generator`` on its own
    device.

    Returns a dict: L (n_atm, N, nX), atmos_labels (n_atm,), Ts_pix
    (n_atm, N), emis_labels (n_atm, N, n_mix), mix_frac (n_atm, N, n_mix).
    """
    if device is None and not isinstance(tau, torch.Tensor):
        device = next((a.device for a in (X, Lu, Ld, Ts, emis)
                       if isinstance(a, torch.Tensor)), None)
    tau = as_tensor_on(tau, device, dtype)
    dev, dt = tau.device, tau.dtype
    X, Lu, Ld, Ts, emis = (as_tensor_on(a, dev, dt)
                           for a in (X, Lu, Ld, Ts, emis))
    n_db, n_tud = emis.shape[0], tau.shape[0]
    g, gdev = generator, generator.device
    atmos_labels = torch.randint(0, n_tud, (n_atm,), generator=g, device=gdev)
    members = torch.randint(0, n_db, (n_atm, n_emis), generator=g,
                            device=gdev)
    pick = torch.randint(0, n_emis, (n_atm, n_pixels, n_mix), generator=g,
                         device=gdev)
    frac_u = torch.rand((n_atm, n_pixels, n_mix), generator=g, device=gdev,
                        dtype=dt)
    z = torch.randn((n_atm, n_pixels), generator=g, device=gdev, dtype=dt)
    return _hsi_from_draws(X, tau, Lu, Ld, Ts, emis,
                           *(a.to(dev) for a in (atmos_labels, members, pick,
                                                 frac_u, z)), dT)
