#!/usr/bin/env python
"""Quickstart on the port: line store -> layered OD -> TUD -> brightness
temperature (``examples/01_od_tud_quickstart.py`` on ``radtxfr_tpu_torch``).

Replaces the reference's ``compute_TUD`` pipeline
(``radiative_transfer.py:303-399``: 66 serial LBLRTM subprocess calls per
spectrum) with one call per stage. The layered OD runs the CUDA line
kernels (``engine="pallas"``; on ``--device cpu`` their plain PyTorch
versions). The physics checks at the end mirror the reference's
commented-out ``__main__`` verification block
(``radiative_transfer.py:1353-1441``).

    python examples/torch/01_od_tud_quickstart.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from radtxfr_tpu_torch.atmos.profile import std_atmosphere  # noqa: E402
from radtxfr_tpu_torch.core.grid import arange_drift_free  # noqa: E402
from radtxfr_tpu_torch.core.planck import (  # noqa: E402
    brightness_temperature, planckian)
from radtxfr_tpu_torch.lines.store import IsoTables  # noqa: E402
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines  # noqa: E402
from radtxfr_tpu_torch.products import (  # noqa: E402
    compute_od_layers, tud_from_od)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (default: the card) or cpu")
dev = ap.parse_args().device

# Real runs: lines = parse_par("HITRAN.par", device=dev) (the native C++
# parser), or lines.derived.derived_lwir_linelist.
lines = synthetic_lines(2_000, nu_min=780.0, nu_max=1270.0, seed=0,
                        device=dev)
iso = IsoTables.load(device=dev)
atm = std_atmosphere(device=dev)                 # 1976 US Standard, 66 layers
X = arange_drift_free(800.0, 1250.0, 0.01)       # LWIR window
grid = torch.as_tensor(X, dtype=torch.float32, device=dev)

# continuum="mt_ckd" is the reference's ICNTNM=6 production physics
od = compute_od_layers(lines, iso, grid, atm, engine="pallas",
                       continuum="mt_ckd")
print(f"OD tensor {tuple(od.shape)} on {od.device}: "
      f"max {od.max().item():.2f}")

B = planckian(grid, atm.T).transpose(0, 1).to(od.dtype)
tud = tud_from_od(grid, od, B, atm.z0, [2.0, 500.0], n_angles=12)
tau = tud.tau.cpu().numpy()      # (nX, nAlt, nMu)
Lu = tud.Lu.cpu().numpy()
Ld = tud.Ld.cpu().numpy()

Tb = brightness_temperature(grid.double(),
                            tud.Lu[:, -1, 0].double() + 1e-12).cpu().numpy()

# the reference's sanity checks, as assertions instead of plots
assert np.all((tau >= 0.0) & (tau <= 1.0 + 1e-6)), "transmittance range"
assert np.all(tau[:, 1, 0] <= tau[:, 0, 0] + 1e-6), \
    "tau must not increase with sensor altitude"
assert np.all(Lu >= 0.0) and np.all(Ld >= 0.0), "radiances nonnegative"
print(f"tau(2 km) mean {tau[:, 0, 0].mean():.3f}; "
      f"tau(space) mean {tau[:, 1, 0].mean():.3f}")
print(f"upwelling BT at space: {Tb[Tb > 0].min():.1f}-{Tb.max():.1f} K")
print("OK")
