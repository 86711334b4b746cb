"""The yardstick's work counts: the least time the card could take for what a
cell's inputs need, at the card's published peaks.

Frozen from the bring-up script's bound arithmetic (``chip_smoke.py``: the
data-sheet peaks, :478-486; the hand-counted lane-operations of an
evaluation, ``K1_OPS`` :496-498 and ``SD_OPS`` with its building blocks
:527-546; ``bound`` :887-894; the K2 special-function, operation and byte
counts, :1649-1659; the OD tangent's hand count ``K3_OPS`` :630 and its
rule, ``k3_bound_work`` :1080-1105; the serving product's FLOP and bytes, :5025-5026). What
is new here is the count of evaluations: it is reckoned from the inputs
(the lines, the grid, the states) through the reference's own line
parameters and the route's pass geometry written as constants (the window
caps of the production plans, :func:`~.reference.lbl.wing_cap_matrix`; the
coarse-far route's R = 64 and near zone), never from the program's plans,
launch counters or ``work_report``. The count is what the data needs: no
padding, no culled slot, each evaluation at the cheaper of the hand counts
that can compute it, so a share of it cannot exceed 100% unless a time
leaves work out.
"""

from __future__ import annotations

import math

import numpy as np

# NVIDIA H100 SXM data sheet: HBM bandwidth, FP32 outside the tensor cores,
# and the special-function units' exp2 (16 a clock an SM on compute
# capability 9.0, x 132 SMs x 1.98 GHz boost)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9

N_WEI = 16
SQRT_LN2 = math.sqrt(math.log(2.0))
#: lane-ops of a Voigt evaluation (a*b+c = 2) inside and outside
#: |x| + y < 15 by mode, hand-counted in the CUDA sources
K1_OPS = {"asym": (28, 28), "core": (175, 14), "mix": (173, 36),
          "full": (157, 31)}
#: the cheapest hand count of an evaluation without mixing, in and out of
#: the Weideman region: one pass of the full form inside, the asymptotic
#: form outside
VOIGT_IN, VOIGT_OUT = K1_OPS["full"][0], K1_OPS["asym"][1]
MIX_IN, MIX_OUT = K1_OPS["mix"]
# SD-Voigt building blocks (csrc/fused_xsect.cu, "Bound.")
SD_BASE = 11 + 24 + 2        # PRE, the SD prelude, the tail
SD_SEL = 22                  # |Z1|, |Z2|, the CPF3 test and its selects
SD_ASYM = 3 + 18             # region test + the unguarded asymptotic form
SD_GUARDED = 19              # the guarded asymptotic form
SD_FAR = SD_BASE + 2 * SD_GUARDED            # sdvoigt_asym
SD_CORE = SD_BASE + SD_SEL + 2 * (SD_GUARDED + 1)
INTERP_OPS = 9               # a point's 4-node interpolation and add
#: lane-ops of a K3 evaluation of (K, Kx, Ky) inside and outside the
#: Weideman region, and of each live direction's term of it
K3_IN, K3_OUT, K3_DIR = 48 + 16 * N_WEI, 54, 8
#: the coarse-far route's geometry (make_xsect_fn's defaults)
COARSE_R = 64
NEAR_WIDTH = 4.0


def bound(ops: float, nbytes: float, sfu: float = 0.0):
    """(least seconds, 'operations' or 'bytes'): the larger of the
    operations over their peaks and the bytes over the memory rate."""
    t_ops = max(ops / FP32_OPS_PER_S, sfu / SFU_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _points(lo, hi, x0, dx, n, closed_hi=True):
    """Grid points x0 + k dx (0 <= k < n) in (lo, hi] (``closed_hi``) or
    (lo, hi) per element."""
    k_lo = np.floor((lo - x0) / dx) + 1
    k_hi = (np.floor((hi - x0) / dx) if closed_hi
            else np.ceil((hi - x0) / dx) - 1)
    k_lo = np.maximum(k_lo, 0)
    k_hi = np.minimum(k_hi, n - 1)
    return np.maximum(k_hi - k_lo + 1, 0)


def window_counts(prm, x0: float, dx: float, n: int):
    """(in-window points, of which inside |x| + y < 15), each (nL, L), of
    every (layer, line) pair's Voigt window on the grid x0 + k dx."""
    nu0, w = prm.nu0, prm.wing
    n_win = _points(nu0 - w, nu0 + w, x0, dx, n)
    c = nu0 + prm.shift
    r = np.maximum(15.0 * prm.gamma_d / SQRT_LN2 - prm.gamma_0, 0.0)
    lo = np.maximum(c - r, nu0 - w)
    hi = np.minimum(c + r, nu0 + w)
    n_in = np.where(hi > lo, _points(lo, hi, x0, dx, n, closed_hi=False), 0)
    return n_win, np.minimum(n_in, n_win)


def voigt_od_work(prm, x0: float, dx: float, n: int, mix_mask):
    """(lane-ops, bytes) of one state's Voigt OD on the grid x0 + k dx:
    every in-window (layer, line, point) once, inside |x| + y < 15 at the
    full form's count and outside at the asymptotic form's (the mixing
    lines at the mixing form's); each line parameter of a live (layer,
    line) pair read once and the (nL, n) OD written once."""
    nu0 = prm.nu0
    n_win, n_in = window_counts(prm, x0, dx, n)
    mix = np.broadcast_to(mix_mask[None, :], n_win.shape)
    ops = np.where(mix, n_in * MIX_IN + (n_win - n_in) * MIX_OUT,
                   n_in * VOIGT_IN + (n_win - n_in) * VOIGT_OUT).sum()
    live = n_win > 0
    nbytes = 4 * ((5 * live + mix * live).sum() + nu0.shape[0] * n)
    return float(ops), float(nbytes)


def voigt_tangent_work(prm, x0: float, dx: float, n: int, live):
    """(lane-ops, bytes) of the Voigt OD's tangents along the directions
    ``live`` (nd, nL, L) bool, where each direction moves a (layer, line)
    pair's parameters: each in-window evaluation of a pair that any
    direction moves once at K3's count, and each moving direction's term
    of it; the pairs' parameters and each direction's parameter tangents
    read once, and each direction's OD tangent written where it is not
    nought (the rows of the layers it moves)."""
    n_win, n_in = window_counts(prm, x0, dx, n)
    pair = live.any(axis=0)
    ops = (np.where(pair, n_in * K3_IN + (n_win - n_in) * K3_OUT, 0).sum()
           + K3_DIR * (live.sum(axis=0) * n_win).sum())
    nbytes = 4 * (5 * pair.sum() + 4 * live.sum()
                  + live.any(axis=2).sum() * n)
    return float(ops), float(nbytes)


def sd_lattice_work(prm, x0: float, dx: float, n: int):
    """(lane-ops, bytes) of one SD-Voigt lattice (states as layers) on the
    coarse-far route: the far field of every in-window (state, line) pair
    on the R-times coarser grid (the guarded asymptotic form), the near
    zone of each line corrected point by point (the asymptotic form and
    the interpolation), and the core where a CPF point can enter the
    Weideman region, each CPF there at the asymptotic price (an
    undercount); line parameters read once, the lattice written once."""
    R = COARSE_R
    nu0, w = prm.nu0, prm.wing
    n_c = (n - 1) // R + 4
    n_far = _points(nu0 - w, nu0 + w, x0 - R * dx, R * dx, n_c)
    h = max(NEAR_WIDTH, 41.0 * R * dx)
    n_near = _points(nu0 - h, nu0 + h, x0, dx, n)
    g2 = np.maximum(prm.gamma_2, 1e-4 * prm.gamma_0 + 1e-12)
    cc = prm.gamma_d / (2.0 * SQRT_LN2 * g2)
    rad = g2 * (2.0 * cc * cc + 30.0 * cc + 225.0) + np.abs(prm.shift)
    n_core = _points(nu0 - rad, nu0 + rad, x0, dx, n, closed_hi=False)
    ops = (n_far * SD_FAR + n_near * (SD_FAR + INTERP_OPS)
           + n_core * (SD_CORE + 2 * SD_ASYM)).sum()
    live = n_far > 0
    nbytes = 4 * (6 * live.sum() + nu0.shape[0] * n)
    return float(ops), float(nbytes)


def k2_work(n_x: int, n_l: int, n_zs: int, n_mu: int = 1, n_a: int = 30):
    """(lane-ops, bytes, special-function ops) of one K2 composition with
    the Planck source in-kernel: per column and layer one exp2 per secant
    and per downwelling angle and the source's expm1 and reciprocal, the
    exp of each snapshot; the OD, the wavenumbers and temperatures read
    once, tau, Lu and Ld written once."""
    sfu = n_x * (n_l * (n_mu + n_a + 2) + n_zs * n_mu)
    ops = n_x * n_l * (28 + (n_mu + n_a) * 3)
    nbytes = (4 * n_l * n_x + 4 * (n_x + n_l)
              + 4 * n_x * (2 * n_zs * n_mu + 1))
    return float(ops), float(nbytes), float(sfu)


def table_od_work(n_l: int, n_k: int, n_x: int):
    """(FLOP, bytes) of one table lookup as a product: (nL, K) weights by
    the (K, nX) table, K = molecules x T x p; the table, the weights and
    the OD each counted once."""
    return float(2 * n_l * n_k * n_x), float(4 * (n_k * n_x + n_l * n_k
                                                  + n_l * n_x))
