"""What the LWIR TUD cells share: the configuration's inputs (the derived
line list, the fine axis, the mixing coefficients) and the reference's
line parameters and window caps of a state of the layered atmosphere."""

from __future__ import annotations

import numpy as np

from .inputs.atmosphere import Atmosphere
from .inputs.derived_lines import derived_lwir_columns
from .inputs.grid import axis
from .inputs.line_mixing import y_air_for_centres
from .reference import lbl

#: the layer grouping's wing ratio of the production builder
#: (``make_od_fn``) and of the differentiable one (``make_od_local_fn``)
PRODUCTION_RATIO = 4.0
DIFFERENTIABLE_RATIO = 1.6


def inputs(cfg: dict, line_mixing: bool = True):
    """(line columns sorted by centre, the fine axis, y_air or None)."""
    band = cfg["band"]
    m = band["line_margin"]
    cols = derived_lwir_columns(band["numin"] - m, band["numax"] + m,
                                cfg["lines"]["min_sw"])
    order = np.argsort(cols["nu0"], kind="stable")
    cols = {k: np.asarray(v)[order] for k, v in cols.items()}
    X = axis(band["numin"], band["numax"], band["dv"])
    y = (y_air_for_centres(cols["nu0"])
         if line_mixing and cfg["lines"].get("line_mixing") else None)
    return cols, X, y


def params(cfg: dict, lines, iso, a: Atmosphere, y, cap) -> lbl.Params:
    """The reference's (nL, L) line parameters of state ``a``, the species
    columns folded in, each window clamped by ``cap``."""
    col = {m: i for i, m in enumerate(a.mol_ids)}
    c = np.array([col[int(m)] for m in lines.mol_id])
    p_atm = a.p / lbl.PA_PER_ATM
    n_tot = p_atm * lbl.BARYE_PER_ATM / (lbl.K_B_CGS * a.T)
    column = a.vmr[:, c] * (n_tot * a.pl * lbl.CM_PER_KM)[:, None]
    return lbl.line_params(lines, iso, a.T, p_atm, x_self=a.vmr[:, c],
                           column=column, wing_abs=cfg["wing_abs"],
                           wing_hw=cfg["wing_hw"], y_air=y, wing_cap=cap)


def reference_geometry(cfg: dict, cols: dict, y,
                       ratio: float = PRODUCTION_RATIO):
    """The reference's lines and the window caps of the program's plans,
    worked out from the class state (the standard atmosphere): the mixing
    lines and the others each in layer groups of wing ``ratio``."""
    iso = lbl.IsoData.load()
    lines = lbl.Lines.from_columns(cols, iso)
    a = Atmosphere.standard()
    col = {m: i for i, m in enumerate(a.mol_ids)}
    c = np.array([col[int(m)] for m in lines.mol_id])
    W = lbl.wing_bound(lines, iso, a.T, a.p / lbl.PA_PER_ATM, a.vmr[:, c],
                       wing_abs=cfg["wing_abs"], wing_hw=cfg["wing_hw"])
    mix = (np.nonzero(y != 0.0)[0] if y is not None
           else np.zeros(0, np.int64))
    rest = np.setdiff1d(np.arange(lines.nu0.size), mix)
    return iso, lines, a, lbl.wing_cap_matrix(W, [mix, rest], ratio=ratio)
