"""The synthetic line-list rule, frozen: the input maker of the
``absxs_h2o_co2`` configuration, standing in for HITRAN2016.

A copy of ``radtxfr_tpu_torch/lines/synthetic.py:23-51``
(``synthetic_lines``: every column drawn by one NumPy generator in the same
order), returning NumPy columns. The ``xsect`` CLI of the reference
generator draws 30,000 lines over the band widened by the 350 cm^-1 wing;
each of its three species gets about a third, so a molecule's table draws
its own 10,000 lines here with ``species`` that one molecule.
"""

from __future__ import annotations

import numpy as np

_DEFAULT_SPECIES = ((1, 1), (2, 1), (3, 1))


def synthetic_columns(n_lines: int, nu_min: float = 500.0,
                      nu_max: float = 1500.0, species=_DEFAULT_SPECIES,
                      seed: int = 0, sd_zero_frac: float = 0.0) -> dict:
    """``n_lines`` HITRAN-plausible lines as NumPy columns."""
    rng = np.random.default_rng(seed)
    nu0 = rng.uniform(nu_min, nu_max, n_lines)
    sw = 10.0 ** rng.uniform(-26.0, -20.0, n_lines)
    elower = rng.uniform(0.0, 3000.0, n_lines)
    gamma_air = rng.uniform(0.02, 0.12, n_lines)
    gamma_self = gamma_air * rng.uniform(1.0, 5.0, n_lines)
    n_air = rng.uniform(0.4, 0.8, n_lines)
    delta_air = rng.normal(0.0, 0.005, n_lines)
    sd_air = rng.uniform(0.05, 0.15, n_lines)
    if sd_zero_frac > 0.0:
        sd_air[rng.random(n_lines) < sd_zero_frac] = 0.0
    k = rng.integers(0, len(species), n_lines)
    mol_id = np.array([species[i][0] for i in k], dtype=np.int32)
    iso_id = np.array([species[i][1] for i in k], dtype=np.int32)
    return dict(nu0=nu0, sw=sw, elower=elower, gamma_air=gamma_air,
                gamma_self=gamma_self, n_air=n_air, delta_air=delta_air,
                sd_air=sd_air, mol_id=mol_id, local_iso_id=iso_id)
