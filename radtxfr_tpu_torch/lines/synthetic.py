"""Deterministic synthetic HITRAN-like line lists (counterpart of
``radtxfr_tpu/lines/synthetic.py``: ``synthetic_lines``).

The same seed gives the JAX package's list draw for draw: every column is
drawn by one NumPy generator in the same order. ``to_hapi_cache`` mirrors a
store into hapi's table cache, so that hapi computes on the same lines.
"""

from __future__ import annotations

import numpy as np
import torch

from .store import LineStore, from_arrays
from .tips import load_tips_tables

__all__ = ["synthetic_lines", "to_hapi_cache"]

# (mol_id, local_iso_id) choices: H2O, CO2, O3 principal isotopologues
_DEFAULT_SPECIES = ((1, 1), (2, 1), (3, 1))


def synthetic_lines(n_lines: int, nu_min: float = 500.0,
                    nu_max: float = 1500.0, species=_DEFAULT_SPECIES,
                    seed: int = 0, dtype=torch.float32,
                    sd_zero_frac: float = 0.0, device=None) -> LineStore:
    """``n_lines`` synthetic lines with HITRAN-plausible parameters
    (``device`` None is the card).

    ``sd_zero_frac`` sets the fraction of lines with ``sd_air == 0`` (real
    HITRAN tables carry SD parameters only for a subset of lines; the
    SD-Voigt path routes such lines through the Voigt passes).
    """
    rng = np.random.default_rng(seed)
    nu0 = rng.uniform(nu_min, nu_max, n_lines)
    # intensities log-uniform over ~6 decades
    sw = 10.0 ** rng.uniform(-26.0, -20.0, n_lines)
    elower = rng.uniform(0.0, 3000.0, n_lines)
    gamma_air = rng.uniform(0.02, 0.12, n_lines)
    gamma_self = gamma_air * rng.uniform(1.0, 5.0, n_lines)
    n_air = rng.uniform(0.4, 0.8, n_lines)
    delta_air = rng.normal(0.0, 0.005, n_lines)
    sd_air = rng.uniform(0.05, 0.15, n_lines)  # typical Gamma2/Gamma0 ratios
    if sd_zero_frac > 0.0:
        sd_air[rng.random(n_lines) < sd_zero_frac] = 0.0
    k = rng.integers(0, len(species), n_lines)
    mol_id = np.array([species[i][0] for i in k], dtype=np.int32)
    iso_id = np.array([species[i][1] for i in k], dtype=np.int32)
    return from_arrays(nu0, sw, elower, gamma_air, gamma_self, n_air,
                       delta_air, mol_id, iso_id, sd_air=sd_air,
                       device=device, dtype=dtype)


def to_hapi_cache(store: LineStore, table_name: str, hapi_module) -> None:
    """Mirror a :class:`LineStore` into hapi's ``LOCAL_TABLE_CACHE`` from
    its float64 host columns (hapi table format:
    ``misc/hapi.py:1615-1672``), so that the reference's
    ``absorptionCoefficient_*`` run on exactly the same line list."""
    h = store.host
    data = {
        "nu": np.asarray(h["nu0"], dtype=np.float64),
        "sw": np.asarray(h["sw"], dtype=np.float64),
        "elower": np.asarray(h["elower"], dtype=np.float64),
        "gamma_air": np.asarray(h["gamma_air"], dtype=np.float64),
        "gamma_self": np.asarray(h["gamma_self"], dtype=np.float64),
        "n_air": np.asarray(h["n_air"], dtype=np.float64),
        "delta_air": np.asarray(h["delta_air"], dtype=np.float64),
        "molec_id": np.asarray(h["mol_id"], dtype=np.int64),
        "local_iso_id": np.asarray(_iso_local_ids(store), dtype=np.int64),
        "SD_air": np.asarray(h["sd_air"], dtype=np.float64),
    }
    hapi_module.LOCAL_TABLE_CACHE[table_name] = {
        "header": {
            "number_of_rows": store.n_lines,
            "order": list(data.keys()),
            "format": {},
            "default": {},
        },
        "data": data,
    }


def _iso_local_ids(store: LineStore):
    """The HITRAN local isotopologue numbers of the store's compact
    ``iso_row`` indices."""
    _mol, iso, _, _ = load_tips_tables()
    return iso[store.host["iso_row"]]
