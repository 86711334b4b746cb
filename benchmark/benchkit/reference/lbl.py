"""Plain line-by-line reference: line parameters, the Voigt and SD-Voigt
line shapes and their windowed sums, in NumPy (parameters, float64) and
plain PyTorch (the sums, in any float dtype, on any device).

Written from hapi's definitions (``misc/hapi.py``): intensity scaling with
TIPS-2011 partition sums (the 3/4-point Lagrange rule of ``AtoB``), the
Doppler and collisional widths, the pressure shift, the wing rule
``max(wing_abs, wing_hw gamma_0, wing_hw gamma_D)`` with the window
``nu0 - wing < nu <= nu0 + wing`` on the unshifted centre, the complex
probability function ``hum1_wei`` (Humlicek's region-1 form where
|x| + y >= 15, else Weideman's rational series), first-order (Rosenkranz)
line mixing ``Re w + Y Im w``, and the SD-Voigt profile as pcqsdhc with
eta = nuVC = Shift2 = 0. It imports nothing of the program: the only
shared inputs are the packaged raw tables (``tips2011.npz``,
``iso_registry.npz``), which both sides read.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

C2_CM_K = 1.4388028496642257      # hc/k [cm K] (hapi)
K_B_CGS = 1.380648813e-16         # [erg/K]
C_CGS = 2.99792458e10             # [cm/s]
AMU_KG = 1.66053873e-27           # [kg]
T_REF = 296.0
PA_PER_ATM = 101325.0
BARYE_PER_ATM = 1.0 / 9.869233e-7
CM_PER_KM = 1.0e5
SQRT_LN2 = math.sqrt(math.log(2.0))
INV_SQRT_PI = 1.0 / math.sqrt(math.pi)
REGION = 15.0                     # hum1_wei's |x| + y bound

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..", "..", "radtxfr_tpu", "data")


@dataclasses.dataclass(frozen=True)
class IsoData:
    """TIPS-2011 partition-sum rows and the molar mass of each row."""

    q: np.ndarray            # (n_iso, 119)
    molar_mass: np.ndarray   # (n_iso,) [g/mol]
    row_of: dict             # (mol, local iso) -> row

    @staticmethod
    def load() -> "IsoData":
        with np.load(os.path.join(DATA_DIR, "tips2011.npz")) as f:
            mol, iso, q = f["mol"], f["iso"], f["q"].astype(np.float64)
        with np.load(os.path.join(DATA_DIR, "iso_registry.npz")) as f:
            reg = {(int(m), int(i)): float(mm) for m, i, mm in
                   zip(f["mol"], f["iso"], f["molar_mass"])}
        rows = {(int(m), int(i)): r for r, (m, i) in enumerate(zip(mol, iso))}
        mass = np.array([reg.get((int(m), int(i)), np.nan)
                         for m, i in zip(mol, iso)])
        return IsoData(q=q, molar_mass=mass, row_of=rows)

    def rows(self, mol_id, local_iso) -> np.ndarray:
        return np.array([self.row_of[(int(m), int(i))]
                         for m, i in zip(mol_id, local_iso)], dtype=np.int64)


def partition_sum(q_rows: np.ndarray, T: float) -> np.ndarray:
    """Q(T) of the table rows ``q_rows`` (n, 119) by hapi's ``AtoB``: the
    4-point Lagrange polynomial through the nodes 60 + 25 k K bracketing T,
    the 3-point one in the first and the last interval."""
    n_nodes = q_rows.shape[1]
    i = int(min(max(math.ceil((T - 60.0) / 25.0), 1), n_nodes - 1))
    if i < 2:
        base, k = 0, 3
    elif i == n_nodes - 1:
        base, k = n_nodes - 3, 3
    else:
        base, k = i - 2, 4
    a = 60.0 + 25.0 * np.arange(base, base + k)
    out = np.zeros(q_rows.shape[0])
    for j in range(k):
        w = 1.0
        for m in range(k):
            if m != j:
                w *= (T - a[m]) / (a[j] - a[m])
        out += w * q_rows[:, base + j]
    return out


@dataclasses.dataclass
class Lines:
    """A line list as float64 NumPy columns, sorted by centre, with each
    line's TIPS row."""

    nu0: np.ndarray
    sw: np.ndarray
    elower: np.ndarray
    gamma_air: np.ndarray
    gamma_self: np.ndarray
    n_air: np.ndarray
    delta_air: np.ndarray
    sd_air: np.ndarray
    mol_id: np.ndarray
    local_iso: np.ndarray
    row: np.ndarray

    @staticmethod
    def from_columns(cols: dict, iso: IsoData) -> "Lines":
        order = np.argsort(np.asarray(cols["nu0"], np.float64), kind="stable")
        f = lambda k: np.asarray(cols[k], np.float64)[order]  # noqa: E731
        mol = np.asarray(cols["mol_id"], np.int64)[order]
        li = np.asarray(cols["local_iso_id"], np.int64)[order]
        sd = (f("sd_air") if "sd_air" in cols
              else np.zeros(order.size))
        return Lines(nu0=f("nu0"), sw=f("sw"), elower=f("elower"),
                     gamma_air=f("gamma_air"), gamma_self=f("gamma_self"),
                     n_air=f("n_air"), delta_air=f("delta_air"), sd_air=sd,
                     mol_id=mol, local_iso=li, row=iso.rows(mol, li))

    def subset(self, keep) -> "Lines":
        return Lines(**{k: v[keep] for k, v in vars(self).items()})


@dataclasses.dataclass
class Params:
    """(nLay, L) line parameters of one state: strength (with the column
    factor), Doppler and collisional half widths, shift, speed-dependent
    width, window half width, and the mixing coefficient (zero without)."""

    nu0: np.ndarray
    strength: np.ndarray
    gamma_d: np.ndarray
    gamma_0: np.ndarray
    shift: np.ndarray
    gamma_2: np.ndarray
    wing: np.ndarray
    Y: np.ndarray


def line_params(lines: Lines, iso: IsoData, T, p_atm, x_self=0.0,
                column=1.0, wing_abs=0.0, wing_hw=50.0, y_air=None,
                wing_cap=None) -> Params:
    """Line parameters at the layers' (T [K], p [atm]) (nLay,) by hapi's
    Voigt/SD-Voigt driver rules. ``x_self`` (nLay, L) the self-broadening
    fraction of each line's species, ``column`` (nLay, L) the species
    column [molec/cm^2] folded into the strength (1: cross-sections),
    ``y_air`` (L,) first-order mixing coefficients [1/atm], ``wing_cap``
    (nLay, L) a bound clamping each window (the production route's plan
    geometry, :func:`wing_cap_matrix`)."""
    T = np.asarray(T, np.float64).reshape(-1, 1)
    p = np.asarray(p_atm, np.float64).reshape(-1, 1)
    rows = np.unique(lines.row)
    q_ref = partition_sum(iso.q[rows], T_REF)
    q_t = np.stack([partition_sum(iso.q[rows], float(t)) for t in T[:, 0]])
    pos = np.searchsorted(rows, lines.row)
    ratio = q_ref[pos][None, :] / q_t[:, pos]
    nu0, el = lines.nu0[None, :], lines.elower[None, :]
    boltz = (np.exp(-C2_CM_K * el / T) * (1.0 - np.exp(-C2_CM_K * nu0 / T))
             / (np.exp(-C2_CM_K * el / T_REF)
                * (1.0 - np.exp(-C2_CM_K * nu0 / T_REF))))
    strength = lines.sw[None, :] * ratio * boltz * column
    mass_g = iso.molar_mass[lines.row][None, :] * AMU_KG * 1000.0
    gamma_d = np.sqrt(2.0 * K_B_CGS * T * math.log(2.0) / mass_g
                      / C_CGS ** 2) * nu0
    x = np.broadcast_to(np.asarray(x_self, np.float64), strength.shape)
    gamma_0 = p * (T_REF / T) ** lines.n_air[None, :] * (
        (1.0 - x) * lines.gamma_air[None, :] + x * lines.gamma_self[None, :])
    shift = (1.0 - x) * lines.delta_air[None, :] * p
    gamma_2 = (1.0 - x) * lines.sd_air[None, :] * lines.gamma_air[None, :] * p
    wing = np.maximum(np.maximum(wing_hw * gamma_0, wing_hw * gamma_d),
                      wing_abs)
    if wing_cap is not None:
        wing = np.minimum(wing, wing_cap)
    Y = (np.zeros_like(strength) if y_air is None
         else p * np.broadcast_to(y_air[None, :], strength.shape))
    return Params(nu0=np.broadcast_to(nu0, strength.shape), strength=strength,
                  gamma_d=gamma_d, gamma_0=gamma_0, shift=shift,
                  gamma_2=gamma_2, wing=wing, Y=Y)


def wing_bound(lines: Lines, iso: IsoData, T, p_atm, x_self, wing_abs=0.0,
               wing_hw=50.0, vmr_margin=1.5):
    """(nLay, L) upper bound on each line's window at a class state: the
    self fraction inflated by ``vmr_margin`` (capped at 1) and never below
    the air width."""
    T = np.asarray(T, np.float64).reshape(-1, 1)
    p = np.asarray(p_atm, np.float64).reshape(-1, 1)
    x = np.minimum(np.asarray(x_self, np.float64) * vmr_margin, 1.0)
    g_mix = np.maximum(lines.gamma_air * (1.0 - x) + lines.gamma_self * x,
                       lines.gamma_air)
    g0 = p * (T_REF / T) ** lines.n_air[None, :] * g_mix
    mass_g = iso.molar_mass[lines.row] * AMU_KG * 1000.0
    gd_coeff = (np.sqrt(2.0 * K_B_CGS * math.log(2.0) / mass_g) / C_CGS
                * lines.nu0)
    gd = np.sqrt(T) * gd_coeff[None, :]
    return np.maximum(wing_abs, wing_hw * np.maximum(g0, gd))


def group_layers(wings: np.ndarray, max_groups: int, ratio: float):
    """Layer groups by wing: sorted descending, a new group where a layer's
    wing times ``ratio`` falls under the group's largest (at most
    ``max_groups`` groups)."""
    order = np.argsort(wings)[::-1]
    groups, current, w_max = [], [order[0]], wings[order[0]]
    for idx in order[1:]:
        if wings[idx] * ratio < w_max and len(groups) < max_groups - 1:
            groups.append(np.array(current))
            current, w_max = [idx], wings[idx]
        else:
            current.append(idx)
    groups.append(np.array(current))
    return groups


def wing_cap_matrix(W: np.ndarray, subsets, max_groups=8, ratio=4.0):
    """(nLay, L) window caps of the production route's window passes: for
    each line subset (the mixing lines, the others), the layers grouped by
    their largest bound and each line capped at its largest bound over its
    group's layers."""
    cap = np.full_like(W, np.inf)
    for idx in subsets:
        if not len(idx):
            continue
        Ws = W[:, idx]
        for lay in group_layers(Ws.max(axis=1), max_groups, ratio):
            cap[np.ix_(lay, idx)] = Ws[lay].max(axis=0)[None, :]
    return cap


def weideman_coeffs(n: int):
    """(L, a[0..n-1]): Weideman's rational-series constants for n terms,
    sampled from exp(-t^2)(L^2 + t^2) at t = L tan(theta/2) (Weideman 1994,
    as hapi's ``cef``)."""
    m = 2 * n
    k = np.arange(-m + 1, m)
    L = math.sqrt(n / math.sqrt(2.0))
    t = L * np.tan(k * math.pi / m / 2.0)
    f = np.concatenate([[0.0], np.exp(-t * t) * (L * L + t * t)])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2 * m)
    return L, a[1:n + 1][::-1].copy()


def hum1_wei(x: torch.Tensor, y: torch.Tensor, n: int = 16):
    """w(x + iy) for y >= 0 as (Re, Im): Humlicek's region-1 form
    (1/sqrt(pi)) t / (1/2 + t^2), t = y - ix, where |x| + y >= 15, else
    Weideman's n-term series, in the dtype of ``x``."""
    L, a = weideman_coeffs(n)
    # region 1
    dr = 0.5 + y * y - x * x
    di = -2.0 * x * y
    dm = dr * dr + di * di
    ar = INV_SQRT_PI * (y * dr - x * di) / dm
    ai = INV_SQRT_PI * (-x * dr - y * di) / dm
    # Weideman: Z = (L + iz)/(L - iz),
    # w = 2 p(Z)/(L - iz)^2 + 1/(sqrt(pi)(L - iz))
    er, ei = L + y, -x
    em = er * er + ei * ei
    zr = ((L - y) * er + x * ei) / em
    zi = (x * er - (L - y) * ei) / em
    pr = torch.full_like(zr, float(a[0]))
    pi_ = torch.zeros_like(zr)
    for c in a[1:]:
        pr, pi_ = pr * zr - pi_ * zi + float(c), pr * zi + pi_ * zr
    sr = er * er - ei * ei
    si = 2.0 * er * ei
    sm = sr * sr + si * si
    wr = 2.0 * (pr * sr + pi_ * si) / sm + INV_SQRT_PI * er / em
    wi = 2.0 * (pi_ * sr - pr * si) / sm - INV_SQRT_PI * ei / em
    inner = (torch.abs(x) + y) < REGION
    return torch.where(inner, wr, ar), torch.where(inner, wi, ai)


_TT = tuple(0.5 + k for k in range(15))


def cpf3(x: torch.Tensor, y: torch.Tensor):
    """hapi's 15-term asymptotic CPF at z = x + iy as (Re, Im)."""
    zm = x * x + y * y
    m1r, m1i = x / zm, -y / zm
    m2r, m2i = m1r * m1r - m1i * m1i, 2.0 * m1r * m1i
    sr, si = torch.ones_like(x), torch.zeros_like(x)
    tr, ti = torch.ones_like(x), torch.zeros_like(x)
    for t in _TT:
        tr, ti = (tr * m2r - ti * m2i) * t, (tr * m2i + ti * m2r) * t
        sr, si = sr + tr, si + ti
    fr, fi = -m1i * INV_SQRT_PI, m1r * INV_SQRT_PI
    return sr * fr - si * fi, sr * fi + si * fr


def _voigt(dnu, gd, g0, Y, n_wei):
    cte = SQRT_LN2 / gd
    wr, wi = hum1_wei(dnu * cte, g0 * cte, n_wei)
    return INV_SQRT_PI * cte * (wr + Y * wi)


def _sdvoigt(dnu, gd, g0, g2, shift):
    """Re of pcqsdhc with eta = nuVC = Shift2 = 0 and Gamma2 > 0 (its PART4;
    PART2/3 need |X| and |Y| eight orders apart, which these widths never
    give): (cte/sqrt(pi)) Re[w(iZ1) - w(iZ2)], Z1,2 = sqrt(X + Y) -+ sqrt(Y),
    X = (i(nu0 - nu + shift) + Gamma0 - 3/2 Gamma2)/Gamma2,
    sqrt(Y) = 1/(2 cte Gamma2); CPF3 where hapi takes it."""
    cte = SQRT_LN2 / gd
    P = (g0 - 1.5 * g2) / g2 + 1.0 / (2.0 * cte * g2) ** 2
    Q = (shift - dnu) / g2
    c = 1.0 / (2.0 * cte * g2)
    mod = torch.sqrt(P * P + Q * Q)
    us = torch.sqrt(torch.clamp(0.5 * (mod + P), min=0.0))
    vs = torch.sign(Q) * torch.sqrt(torch.clamp(0.5 * (mod - P), min=0.0))
    out = []
    s1 = torch.sqrt((us - c) ** 2 + vs * vs)
    s2 = torch.sqrt((us + c) ** 2 + vs * vs)
    use3 = ((torch.abs(s1 - s2) <= 1.0) & (torch.maximum(s1, s2) > 8.0)
            & (torch.minimum(s1, s2) <= 8.0))
    for sign in (-1.0, 1.0):
        # hapi's CPF at (x, y) = (-Im Z, Re Z)
        x, y = -vs, us + sign * c
        wr, _ = hum1_wei(x, y)
        w3, _ = cpf3(x, torch.where(use3, y, torch.ones_like(y)))
        out.append(torch.where(use3, w3, wr))
    return INV_SQRT_PI * cte * (out[0] - out[1])


def line_sum(grid: np.ndarray, prm: Params, layers=None, profile="voigt",
             dtype=torch.float64, device="cpu", n_wei=16,
             chunk_elems=1 << 24) -> torch.Tensor:
    """(nLay, P) sum over lines of strength x profile at the points
    ``grid`` (float64, ascending), each line masked to its window
    nu0 - wing < nu <= nu0 + wing; ``profile`` 'voigt' (with the mixing
    term where Y != 0) or 'sdvoigt'. Offsets are formed in float64 and the
    profile evaluated in ``dtype``."""
    lay = np.arange(prm.strength.shape[0]) if layers is None else layers
    g_lo, g_hi = float(grid[0]), float(grid[-1])
    wmax = prm.wing[lay].max(axis=0)
    live = np.nonzero((prm.nu0[0] + wmax >= g_lo)
                      & (prm.nu0[0] - wmax < g_hi))[0]
    out = torch.zeros((len(lay), grid.size), dtype=dtype, device=device)
    if not live.size:
        return out
    g = torch.as_tensor(grid, dtype=torch.float64, device=device)
    step = max(1, chunk_elems // (len(lay) * grid.size))
    t = lambda a, ix: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a[np.ix_(lay, ix)]), device=device)[:, :, None]
    for lo in range(0, live.size, step):
        ix = live[lo:lo + step]
        nu0 = t(prm.nu0, ix)
        wing = t(prm.wing, ix)
        mask = (g > nu0 - wing) & (g <= nu0 + wing)
        if profile == "sdvoigt":
            dnu = (g - nu0).to(dtype)
            val = _sdvoigt(dnu, *(t(a, ix).to(dtype) for a in
                                  (prm.gamma_d, prm.gamma_0, prm.gamma_2,
                                   prm.shift)))
        else:
            dnu = (g - nu0 - t(prm.shift, ix)).to(dtype)
            val = _voigt(dnu, t(prm.gamma_d, ix).to(dtype),
                         t(prm.gamma_0, ix).to(dtype), t(prm.Y, ix).to(dtype),
                         n_wei)
        val = torch.where(mask, t(prm.strength, ix).to(dtype) * val,
                          torch.zeros((), dtype=dtype, device=device))
        out += val.sum(dim=1)
    return out
