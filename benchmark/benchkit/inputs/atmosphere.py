"""The atmospheric inputs, frozen: the 1976 US Standard Atmosphere of the
reference (the packaged raw table, read by path), the ensemble's draw rule
and the Jacobian's direction rule.

* :func:`ensemble_draws` is ``radtxfr_tpu_torch/cli/main.py:231-238``
  (the reference's ``Generate_LWIR_TUD.py`` perturbations: T + N(0, 5 K),
  H2O x U(0.5, 1.5)), and :func:`member` and :func:`member_tensors` apply
  a draw as ``ensemble_member`` (:241-248) does;
* :func:`jacobian_directions` is ``radtxfr_tpu_torch/dist/
  fused_ensemble.py:209-233`` (one-hot (variable, layer) directions of T,
  H2O and O3).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..reference.lbl import DATA_DIR

#: HITRAN molecule numbers of the table's vmr columns (H2O CO2 O3 N2O CO
#: CH4 O2 N2)
MOL_IDS = (1, 2, 3, 4, 5, 6, 7, 22)
#: members drawn up front from a seed; member k of a run is draw k mod this
N_DRAWS = 1 << 16


@dataclasses.dataclass(frozen=True)
class Atmosphere:
    """A layered state, ground first, float64: bottoms and tops [km], path
    [km], pressure [Pa], temperature [K], vmr (nL, 8)."""

    z0: np.ndarray
    z1: np.ndarray
    pl: np.ndarray
    p: np.ndarray
    T: np.ndarray
    vmr: np.ndarray
    mol_ids: tuple = MOL_IDS

    @staticmethod
    def standard() -> "Atmosphere":
        with np.load(os.path.join(DATA_DIR, "std_atmosphere_1976.npz")) as f:
            t = np.asarray(f["table"], np.float64)
        return Atmosphere(z0=t[:, 1], z1=t[:, 2], pl=t[:, 3], p=t[:, 4],
                          T=t[:, 5], vmr=t[:, 6:14])


def ensemble_draws(n_atmos: int, seed: int):
    """T offsets from N(0, 5 K), (n_atmos, 1), and H2O column scales from
    U(0.5, 1.5), (n_atmos,), float32, member for member as the CLI."""
    rng = np.random.default_rng(seed)
    dT = rng.normal(0.0, 5.0, (n_atmos, 1)).astype(np.float32)
    scale_h2o = rng.uniform(0.5, 1.5, n_atmos).astype(np.float32)
    return dT, scale_h2o


def member(base: Atmosphere, draws, i: int) -> Atmosphere:
    """Member ``i``: T offset by its draw, H2O column scaled; in float32,
    as the program holds the state (the reference reads these values)."""
    dT, scale = draws
    T = (base.T.astype(np.float32) + dT[i]).astype(np.float64)
    vmr = base.vmr.astype(np.float32)
    vmr[:, 0] = vmr[:, 0] * np.float32(scale[i])
    return dataclasses.replace(base, T=T, vmr=vmr.astype(np.float64))


def member_tensors(T, vmr, draws, i: int):
    """Member ``i`` of a float32 state on the card, ``T`` (nL,) and ``vmr``
    (nL, 8) tensors, as the CLI's ``ensemble_member`` forms it: the T
    offset added, the H2O column scaled (a new vmr tensor)."""
    import torch

    dT, scale = draws
    vmr = vmr.clone()
    vmr[:, 0] *= float(scale[i])
    return T + torch.as_tensor(dT[i], device=T.device), vmr


def jacobian_directions(base: Atmosphere, wrt=("T", 1, 3)):
    """(V_T (n_dirs, nL), V_vmr (n_dirs, nL, nM), labels) float32 one-hot
    directions, (variable, layer) in order."""
    n_lay, n_sp = base.T.size, base.vmr.shape[1]
    col = {m: i for i, m in enumerate(base.mol_ids)}
    V_T, V_vmr, labels = [], [], []
    eye = np.eye(n_lay, dtype=np.float32)
    zT = np.zeros((n_lay,), dtype=np.float32)
    zV = np.zeros((n_lay, n_sp), dtype=np.float32)
    for key in wrt:
        for layer in range(n_lay):
            if key == "T":
                V_T.append(eye[layer])
                V_vmr.append(zV)
            else:
                v = zV.copy()
                v[layer, col[int(key)]] = 1.0
                V_T.append(zT)
                V_vmr.append(v)
            labels.append((str(key), layer))
    return np.stack(V_T), np.stack(V_vmr), labels
