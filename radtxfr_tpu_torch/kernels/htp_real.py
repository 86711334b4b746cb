"""pCqSDHC (Hartmann-Tran) profile in real arithmetic (counterpart of
``radtxfr_tpu/kernels/htp_real.py``).

hapi's ``pcqsdhc`` (``misc/hapi.py:9850-10023``) with every complex
quantity a (real, imaginary) pair of tensors: PART1 with its |Z1| > 4e3
asymptotic branch, PART2, PART3 with its small-|sqrt X| branch and PART4
with the CPF3 sub-selection, complex eta included. Every part is evaluated
and the point's part selected with ``torch.where`` (compute and select), so
``torch.func.jvp`` through :func:`pcqsdhc_real` gives the derivative of the
selected branch: the plain version of the HT tangent kernel K6 is exactly
that. The guards of the JAX module are kept as they are: ``_cinv`` floors
|a|^2 at the dtype's smallest normal and ``_csqrt`` its three square-root
arguments likewise (a 0.0 floor would turn zero tangents into NaN where an
argument lands on it), with Im sqrt taking the sign of Im a by ``>= 0``.

The per-(layer, line) complex algebra runs once in
:func:`ht_line_constants`; :func:`pcqsdhc_real` takes its 11 constants.
Dtype-polymorphic: float64 for the comparisons with JAX, float32 on the
kernels' path.
"""

from __future__ import annotations

import math

import torch

from .. import arrays_on
from .fused_xsect import _cpf3_pair, _ieee_rcp, _voigt_w_KL

__all__ = ["ht_line_constants", "pcqsdhc_real", "HT_CONST_KEYS"]

_RPI = math.sqrt(math.pi)
_INV_SQRT_PI = 1.0 / _RPI
_SQRT_LN2 = math.sqrt(math.log(2.0))

#: the order of the per-(layer, line) constants (``pallas_xsect.py:925``)
HT_CONST_KEYS = ("cte", "c0tr", "c0ti", "c2tr", "c2ti", "cyr", "cyi",
                 "d0r", "d0i", "e2r", "e2i")


# ---------------------------------------------------------------------------
# real-pair complex helpers
# ---------------------------------------------------------------------------

def _tiny(t):
    return torch.finfo(t.dtype).tiny


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cinv(ar, ai):
    """1/a, |a|^2 floored at the smallest normal of the dtype."""
    m = ar * ar + ai * ai
    m = torch.clamp(m, min=_tiny(m))
    return ar / m, -ai / m


def _cdiv(ar, ai, br, bi):
    ir, ii = _cinv(br, bi)
    return _cmul(ar, ai, ir, ii)


def _csqrt(ar, ai):
    """Principal square root (Re >= 0); Im carries the sign of ai, with
    ai == 0, ar < 0 giving +i sqrt(|ar|) (``htp_real.py:55-72``)."""
    g = _tiny(ar)
    r = torch.sqrt(torch.clamp(ar * ar + ai * ai, min=g))
    u = torch.sqrt(torch.clamp(0.5 * (r + ar), min=g))
    v_mag = torch.sqrt(torch.clamp(0.5 * (r - ar), min=g))
    return u, torch.where(ai >= 0.0, v_mag, -v_mag)


def _w_of_pair(zr, zi, a, L, rcp):
    """hapi's CPF convention: w at (x, y) = (-Im Z, Re Z); ``rcp``: the
    reciprocal of the w(Z) forms (``fused_xsect.plain_rcp``)."""
    return _voigt_w_KL(-zi, zr, a, L, rcp)


def _cpf_select_pair(zr, zi, use3, a, L, rcp):
    """w(Z) with PART4's CPF3-vs-CPF sub-selection."""
    x, y = -zi, zr
    Kw, Lw = _voigt_w_KL(x, y, a, L, rcp)
    K3, L3 = _cpf3_pair(x, y)
    return torch.where(use3, K3, Kw), torch.where(use3, L3, Lw)


# ---------------------------------------------------------------------------
# per-(layer, line) constants
# ---------------------------------------------------------------------------

def ht_line_constants(gamma_d, gamma0, gamma2, shift0, shift2, anuvc,
                      eta_r, eta_i, device=None) -> dict:
    """The 11 real constants pcqsdhc needs (``htp_real.py:109-142``):
    ``cte`` = sqrt(ln2)/gamma_d, c0t, c2t and csqrtY as pairs, d0 = anuvc -
    eta (c0 - 1.5 c2) and e2 = eta c2; every entry shaped like the inputs.
    NumPy arguments join a tensor argument's device, else ``device``
    (None: the card)."""
    gamma_d, gamma0, gamma2, shift0, shift2, anuvc, eta_r, eta_i = arrays_on(
        gamma_d, gamma0, gamma2, shift0, shift2, anuvc, eta_r, eta_i,
        device=device)
    cte = _SQRT_LN2 / gamma_d
    c0r, c0i = gamma0, shift0
    c2r, c2i = gamma2, shift2
    omr, omi = 1.0 - eta_r, -eta_i
    b0r, b0i = c0r - 1.5 * c2r, c0i - 1.5 * c2i
    c0tr, c0ti = _cmul(omr, omi, b0r, b0i)
    c0tr = c0tr + anuvc
    c2tr, c2ti = _cmul(omr, omi, c2r, c2i)
    g2s2 = c2r * c2r + c2i * c2i
    g2s2_safe = torch.where(g2s2 == 0.0, 1.0, g2s2)
    eta_is_one = (eta_r == 1.0) & (eta_i == 0.0)
    om_r = torch.where(eta_is_one, 1.0, omr)
    om_i = torch.where(eta_is_one, 0.0, omi)
    den_r = 2.0 * cte * g2s2_safe * om_r
    den_i = 2.0 * cte * g2s2_safe * om_i
    cyr, cyi = _cdiv(c2r, -c2i, den_r, den_i)
    e_b0r, e_b0i = _cmul(eta_r, eta_i, b0r, b0i)
    d0r, d0i = anuvc - e_b0r, -e_b0i
    e2r, e2i = _cmul(eta_r, eta_i, c2r, c2i)
    return dict(cte=cte, c0tr=c0tr, c0ti=c0ti, c2tr=c2tr, c2ti=c2ti,
                cyr=cyr, cyi=cyi, d0r=d0r, d0i=d0i, e2r=e2r, e2i=e2i)


# ---------------------------------------------------------------------------
# the profile
# ---------------------------------------------------------------------------

def pcqsdhc_real(dnu, k, wei_a, wei_L, fast: bool = False, device=None):
    """Re LS of pcqsdhc at ``dnu = sg - sg0`` from the constants ``k`` of
    :func:`ht_line_constants` (each broadcastable against ``dnu``);
    ``wei_a``/``wei_L`` are the Weideman coefficients. The operations are
    those of ``htp_real.py::pcqsdhc_real``, in its order. ``fast=True``
    (JAX's approximate reciprocals) raises ``NotImplementedError``, as
    JAX's does outside a kernel (``pl.reciprocal`` has no evaluation rule
    there): the fast reciprocal is K5's (``xsect_ht(..., fast=True)``,
    the builders' ``fast_rcp``), and this function divides in IEEE. NumPy
    ``dnu`` and constants join a tensor's device, else ``device`` (None:
    the card)."""
    if fast:
        raise NotImplementedError(
            "fast=True: the port's pcqsdhc divides by IEEE division only "
            "(pass fast=False)")
    return _pcqsdhc_terms(dnu, k, wei_a, wei_L, _ieee_rcp, device)


def _pcqsdhc_terms(dnu, k, wei_a, wei_L, rcp, device=None):
    """:func:`pcqsdhc_real` with ``rcp`` at the reciprocals of the w(Z)
    forms, the sites of K5's ``wrecip<FAST>`` (K5's plain version passes
    ``fused_xsect.plain_rcp``: on the card, the FAST instantiation's
    reciprocal); every other division is IEEE."""
    names = sorted(k)
    dnu, L, *vals = arrays_on(dnu, wei_L, *(k[n] for n in names),
                              device=device)
    k = dict(zip(names, vals))
    a = wei_a
    cte = k["cte"]
    c0tr, c0ti = k["c0tr"], k["c0ti"]
    c2tr, c2ti = k["c2tr"], k["c2ti"]
    cyr, cyi = k["cyr"], k["cyi"]

    t0r = torch.zeros_like(dnu) + c0tr
    t0i = -dnu + c0ti                           # i(sg0 - sg) + c0t
    part1 = (c2tr * c2tr + c2ti * c2ti) == 0.0

    # PART1
    z1ar, z1ai = t0r * cte, t0i * cte
    w1r, w1i = _w_of_pair(z1ar, z1ai, a, L, rcp)
    A1r, A1i = _RPI * cte * w1r, _RPI * cte * w1i
    z2_r, z2_i = _cmul(z1ar, z1ai, z1ar, z1ai)
    bw_r, bw_i = _cmul(1.0 - z2_r, -z2_i, w1r, w1i)
    B1s_r = _RPI * cte * (bw_r + z1ar * _INV_SQRT_PI)
    B1s_i = _RPI * cte * (bw_i + z1ai * _INV_SQRT_PI)
    i1r, i1i = _cinv(z1ar, z1ai)
    i3r, i3i = _cmul(i1r, i1i, *_cmul(i1r, i1i, i1r, i1i))
    B1b_r = cte * (_RPI * w1r + 0.5 * i1r - 0.75 * i3r)
    B1b_i = cte * (_RPI * w1i + 0.5 * i1i - 0.75 * i3i)
    big1 = torch.sqrt(z1ar * z1ar + z1ai * z1ai) > 4.0e3
    B1r = torch.where(big1, B1b_r, B1s_r)
    B1i = torch.where(big1, B1b_i, B1s_i)

    # PART2/3/4 shared
    c2t_sr = torch.where(part1, 1.0, c2tr)
    c2t_si = torch.where(part1, 0.0, c2ti)
    ic2r, ic2i = _cinv(c2t_sr, c2t_si)
    Xr, Xi = _cmul(t0r, t0i, ic2r, ic2i)
    y0r, y0i = _cinv(2.0 * cte * c2t_sr, 2.0 * cte * c2t_si)
    Yr, Yi = _cmul(y0r, y0i, y0r, y0i)
    absX = torch.sqrt(Xr * Xr + Xi * Xi)
    absY = torch.sqrt(Yr * Yr + Yi * Yi)
    part2 = ~part1 & (absX <= 3.0e-8 * absY)
    part3 = ~part1 & ~part2 & (absY <= 1.0e-15 * absX)
    sxyr, sxyi = _csqrt(Xr + Yr, Xi + Yi)
    cy0 = (cyr * cyr + cyi * cyi) == 0.0
    cy_sr = torch.where(cy0, 1.0, cyr)
    cy_si = torch.where(cy0, 0.0, cyi)
    icy_r, icy_i = _cinv(cy_sr, cy_si)

    # PART4
    Z1r, Z1i = sxyr - cy_sr, sxyi - cy_si
    Z2r, Z2i = Z1r + 2.0 * cy_sr, Z1i + 2.0 * cy_si
    SZ1 = torch.sqrt(Z1r * Z1r + Z1i * Z1i)
    SZ2 = torch.sqrt(Z2r * Z2r + Z2i * Z2i)
    use3 = ((torch.abs(SZ1 - SZ2) <= 1.0) & (torch.maximum(SZ1, SZ2) > 8.0)
            & (torch.minimum(SZ1, SZ2) <= 8.0))
    w14r, w14i = _cpf_select_pair(Z1r, Z1i, use3, a, L, rcp)
    w24r, w24i = _cpf_select_pair(Z2r, Z2i, use3, a, L, rcp)
    A4r = _RPI * cte * (w14r - w24r)
    A4i = _RPI * cte * (w14i - w24i)
    z1sq_r, z1sq_i = _cmul(Z1r, Z1i, Z1r, Z1i)
    z2sq_r, z2sq_i = _cmul(Z2r, Z2i, Z2r, Z2i)
    t1r, t1i = _cmul(1.0 - z1sq_r, -z1sq_i, w14r, w14i)
    t2r, t2i = _cmul(1.0 - z2sq_r, -z2sq_i, w24r, w24i)
    hr, hi = _cmul(0.5 * _RPI * icy_r, 0.5 * _RPI * icy_i,
                   t1r - t2r, t1i - t2i)
    B4r, B4i = _cmul(hr - 1.0, hi, ic2r, ic2i)

    # PART2
    Z2br, Z2bi = sxyr + cy_sr, sxyi + cy_si
    w12r, w12i = _w_of_pair(z1ar, z1ai, a, L, rcp)
    w22r, w22i = _w_of_pair(Z2br, Z2bi, a, L, rcp)
    A2r = _RPI * cte * (w12r - w22r)
    A2i = _RPI * cte * (w12i - w22i)
    z1bsq_r, z1bsq_i = _cmul(z1ar, z1ai, z1ar, z1ai)
    z2bsq_r, z2bsq_i = _cmul(Z2br, Z2bi, Z2br, Z2bi)
    u1r, u1i = _cmul(1.0 - z1bsq_r, -z1bsq_i, w12r, w12i)
    u2r, u2i = _cmul(1.0 - z2bsq_r, -z2bsq_i, w22r, w22i)
    h2r, h2i = _cmul(0.5 * _RPI * icy_r, 0.5 * _RPI * icy_i,
                     u1r - u2r, u1i - u2i)
    B2r, B2i = _cmul(h2r - 1.0, h2i, ic2r, ic2i)

    # PART3
    wxyr, wxyi = _w_of_pair(sxyr, sxyi, a, L, rcp)
    sXr, sXi = _csqrt(Xr, Xi)
    wxr, wxi = _w_of_pair(sXr, sXi, a, L, rcp)
    sxwx_r, sxwx_i = _cmul(sXr, sXi, wxr, wxi)
    g_r, g_i = _INV_SQRT_PI - sxwx_r, -sxwx_i
    A3s_r, A3s_i = _cmul(2.0 * _RPI * g_r, 2.0 * _RPI * g_i, ic2r, ic2i)
    cr, ci = 1.0 - Xr - 2.0 * Yr, -Xi - 2.0 * Yi
    cg_r, cg_i = _cmul(cr, ci, g_r, g_i)
    sw_r, sw_i = _cmul(sxyr, sxyi, wxyr, wxyi)
    B3s_r, B3s_i = _cmul(-1.0 + 2.0 * _RPI * cg_r + 2.0 * _RPI * sw_r,
                         2.0 * _RPI * cg_i + 2.0 * _RPI * sw_i, ic2r, ic2i)
    iXr, iXi = _cinv(Xr, Xi)
    iX2r, iX2i = _cmul(iXr, iXi, iXr, iXi)
    hx_r, hx_i = iXr - 1.5 * iX2r, iXi - 1.5 * iX2i
    A3b_r, A3b_i = _cmul(hx_r, hx_i, ic2r, ic2i)
    chx_r, chx_i = _cmul(cr, ci, hx_r, hx_i)
    B3b_r, B3b_i = _cmul(-1.0 + chx_r + 2.0 * _RPI * sw_r,
                         chx_i + 2.0 * _RPI * sw_i, ic2r, ic2i)
    small3 = torch.sqrt(sXr * sXr + sXi * sXi) <= 4.0e3
    A3r = torch.where(small3, A3s_r, A3b_r)
    A3i = torch.where(small3, A3s_i, A3b_i)
    B3r = torch.where(small3, B3s_r, B3b_r)
    B3i = torch.where(small3, B3s_i, B3b_i)

    def sel(a1, a2, a3, a4):
        return torch.where(part1, a1, torch.where(
            part2, a2, torch.where(part3, a3, a4)))

    Ar, Ai = sel(A1r, A2r, A3r, A4r), sel(A1i, A2i, A3i, A4i)
    Br, Bi = sel(B1r, B2r, B3r, B4r), sel(B1i, B2i, B3i, B4i)

    # LS = (1/pi) A / (1 - d0 A + e2 B)
    dAr, dAi = _cmul(k["d0r"], k["d0i"], Ar, Ai)
    eBr, eBi = _cmul(k["e2r"], k["e2i"], Br, Bi)
    ls_r, _ = _cdiv(Ar, Ai, 1.0 - dAr + eBr, -dAi + eBi)
    # times 1/pi rather than divided by pi: torch on the card divides by a
    # Python scalar that way, so both devices (and K5) round alike
    return ls_r * (1.0 / math.pi)
