"""Layered-atmosphere state container (counterpart of
``radtxfr_tpu/atmos/profile.py``).

Layer convention: index 0 is the ground layer; ``z0 < z1`` are the layer
bottom/top altitudes [km]; ``pl`` is the path length through the layer [km];
``vmr`` columns follow ``mol_ids`` (HITRAN molecule numbers) as volume
mixing fractions.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from .. import DATA_DIR, as_numpy, resolve_device

#: HITRAN molecule numbers of the StdAtmos VMR columns (H2O CO2 O3 N2O CO
#: CH4 O2 N2); reference ``MFs_ID`` (radiative_transfer.py:177).
STD_ATMOS_MOL_IDS = (1, 2, 3, 4, 5, 6, 7, 22)


@dataclasses.dataclass(frozen=True)
class AtmosphericState:
    """One layered atmospheric state (or a batch, with leading axes)."""

    z0: torch.Tensor   # (nL,) layer bottom altitude [km]
    z1: torch.Tensor   # (nL,) layer top altitude [km]
    pl: torch.Tensor   # (nL,) path length [km]
    p: torch.Tensor    # (nL,) pressure [Pa]
    T: torch.Tensor    # (nL,) temperature [K]
    vmr: torch.Tensor  # (nL, nM) volume mixing fractions
    mol_ids: tuple = STD_ATMOS_MOL_IDS

    @property
    def n_layers(self) -> int:
        return int(self.T.shape[-1])

    def replace(self, **kw) -> "AtmosphericState":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_numpy(z0, z1, pl, p, T, vmr, mol_ids=STD_ATMOS_MOL_IDS,
                   device=None, dtype=torch.float32) -> "AtmosphericState":
        """Build from NumPy fields (e.g. those of the JAX state); ``device``
        None is the card."""
        device = resolve_device(device)
        f = lambda a: torch.tensor(as_numpy(a, np.float64), dtype=dtype,
                                   device=device)
        return AtmosphericState(z0=f(z0), z1=f(z1), pl=f(pl), p=f(p), T=f(T),
                                vmr=f(vmr), mol_ids=tuple(mol_ids))


@functools.lru_cache(maxsize=1)
def _std_atmos_table() -> np.ndarray:
    with np.load(os.path.join(DATA_DIR, "std_atmosphere_1976.npz")) as f:
        return f["table"].copy()


def std_atmosphere(dtype=torch.float32, device=None) -> AtmosphericState:
    """The 66-layer 1976 US Standard Atmosphere of the reference
    (``device`` None is the card)."""
    t = _std_atmos_table()
    return AtmosphericState.from_numpy(
        z0=t[:, 1], z1=t[:, 2], pl=t[:, 3], p=t[:, 4], T=t[:, 5],
        vmr=t[:, 6:14], device=device, dtype=dtype)


def std_atmosphere_raw() -> np.ndarray:
    """The raw (66, 15) StdAtmos table (for regridding code)."""
    return _std_atmos_table().copy()
