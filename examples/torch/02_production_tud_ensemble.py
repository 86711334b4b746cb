#!/usr/bin/env python
"""Production ensemble TUD on the port: generative atmospheres -> sharded
TUD through the kernels -> resumable checkpoints -> HDF5
(``examples/02_production_tud_ensemble.py`` on ``radtxfr_tpu_torch``).

Replaces ``Generate_LWIR_TUD.py``: where the reference fans 1000
atmospheres over a process pool with shared-memory arrays and a lock
(``Generate_LWIR_TUD.py:98-149``), here ``make_tud_ensemble_fn`` runs
batches over an (ensemble x spectrum) mesh of devices (here a mesh of the
one device: its plans, partition and gather run as on several cards); the
resumable checkpoint directory replaces the reference's write-only ``.npz``
dumps (``:150``), and the HDF5 output carries its units-metadata
convention (``:157-221``; an ``.npz`` of the same arrays where h5py is not
installed).

A small demo configuration: scale ``N_ATMOS`` and the grid for
production (``python -m radtxfr_tpu_torch.cli.main tud --checkpoint ...``).

    python examples/torch/02_production_tud_ensemble.py [--device cpu]

It writes ``_demo_tud_ck/`` and ``_demo_tud.h5`` in the working directory.
"""

import argparse
import dataclasses
import importlib.util
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from radtxfr_tpu_torch.atmos.profile import std_atmosphere  # noqa: E402
from radtxfr_tpu_torch.core.grid import arange_drift_free  # noqa: E402
from radtxfr_tpu_torch.dist.checkpoint import (  # noqa: E402
    EnsembleCheckpoint, run_batched)
from radtxfr_tpu_torch.dist.ensemble import stack_states  # noqa: E402
from radtxfr_tpu_torch.dist.fused_ensemble import (  # noqa: E402
    make_tud_ensemble_fn)
from radtxfr_tpu_torch.dist.mesh import make_mesh  # noqa: E402
from radtxfr_tpu_torch.io.h5 import Var, write_h5  # noqa: E402
from radtxfr_tpu_torch.lines.store import IsoTables  # noqa: E402
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines  # noqa: E402
from radtxfr_tpu_torch.scene.generative import atmos_generator  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (default: the card) or cpu")
dev = ap.parse_args().device

N_ATMOS = 8
BATCH = 4
ALTITUDES = [2.0, 500.0]

atm = std_atmosphere(device=dev)
X = arange_drift_free(980.0, 1080.0, 0.01)

# --- generative atmosphere model (reference GenerativeModel_AtmosInputs) ---
# Train on an ensemble of perturbed standard atmospheres; production runs
# train on TIGR soundings (atmos.regrid.load_tigr_mat).
rng = np.random.default_rng(0)
n_train = 64
host = {k: getattr(atm, k).cpu().numpy().astype(np.float64)
        for k in ("T", "z0", "p", "vmr")}
T_tr = host["T"][None] + rng.normal(0, 5, (n_train, 1)) \
    * np.exp(-host["z0"] / 8.0)[None]
H_tr = host["vmr"][:, 0][None] * rng.lognormal(0, 0.25, (n_train, 1))
O_tr = host["vmr"][:, 2][None] * rng.lognormal(0, 0.1, (n_train, 1))
f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
sample_fn, _diag = atmos_generator(
    torch.Generator(device=dev).manual_seed(0), f64(host["p"]), f64(T_tr),
    f64(H_tr), f64(O_tr), n_pca=8, n_gmm=4)
T_g, H_g, O_g, _ll = sample_fn(torch.Generator(device=dev).manual_seed(1),
                               N_ATMOS)
n = T_g.shape[0]
print(f"generative model accepted {n}/{N_ATMOS} candidate atmospheres")


def member(i):
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    vmr = atm.vmr.clone()
    vmr[:, 0], vmr[:, 2] = f32(H_g[i]), f32(O_g[i])
    return dataclasses.replace(atm, T=f32(T_g[i]), vmr=vmr)


# --- the sharded TUD over a mesh of the one device --------------------------
lines = synthetic_lines(1_500, nu_min=960.0, nu_max=1100.0, seed=3,
                        device=dev)
iso = IsoTables.load(device=dev)
mesh = make_mesh(1, 1, devices=None if dev == "cuda" else [dev])
vmr2 = atm.vmr.clone()
vmr2[:, 0] *= 2.0
env = [atm.replace(T=atm.T - 25.0), atm.replace(T=atm.T + 25.0, vmr=vmr2)]
probe = stack_states([member(i % n) for i in range(BATCH)])
# partition='weighted' deals spectral tiles by op-weighted plan work; on a
# multi-card machine make_mesh(E, S) spans the cards
gpad, run = make_tud_ensemble_fn(lines, iso, X, probe, ALTITUDES, mesh,
                                 atmos_class=env, n_angles=12,
                                 continuum="mt_ckd", partition="weighted")
nX = X.size


def compute_batch(indices):
    b = stack_states([member(int(i) % n) for i in indices])
    tau, Lu, Ld = run(b)
    return {"tau": tau[:, :nX, :, 0].cpu().numpy(),
            "Lu": Lu[:, :nX, :, 0].cpu().numpy(),
            "Ld": Ld[:, :nX].cpu().numpy()}


ck = EnsembleCheckpoint("./_demo_tud_ck", n_items=N_ATMOS, batch_size=BATCH)
out = run_batched(ck, compute_batch)   # restarts skip completed batches
for k, v in out.items():
    assert np.isfinite(v).all(), k
assert out["tau"].min() >= 0.0 and out["tau"].max() <= 1.0 + 1e-6

# --- HDF5 with the reference's units-metadata convention -------------------
if importlib.util.find_spec("h5py") is not None:
    write_h5("./_demo_tud.h5", {
        "X": Var(np.asarray(X), units="cm^{-1}", name="wavenumbers"),
        "tau": Var(out["tau"], units="unitless", name="transmittance",
                   info="(atmos, X, altitude)"),
        "Lu": Var(out["Lu"], units="microflick", name="upwelling radiance"),
        "Ld": Var(out["Ld"], units="microflick",
                  name="hemispherically-averaged downwelling radiance"),
        "T": Var(T_g, units="K", name="temperature profiles"),
    }, attrs={"altitudes_km": ALTITUDES})
    name = "_demo_tud.h5"
else:
    np.savez("./_demo_tud.npz", X=X, T=T_g, **out)
    name = "_demo_tud.npz (no h5py here)"
print(f"wrote {name}: tau {out['tau'].shape}, Lu {out['Lu'].shape}, "
      f"Ld {out['Ld'].shape}")
print("OK")
