#!/usr/bin/env python
"""The hapi-named drop-in API against a local table, on the port
(``examples/03_hapi_dropin.py`` on ``radtxfr_tpu_torch``).

Everything below is spelled like the reference's hapi tutorial
(``misc/hapi.py``) — ``db_begin``/``select``/``absorptionCoefficient_*``/
slit functions — computed by the port's reference engine in float64 on the
device the database was opened on (hapi's numerical type; the float32 CUDA
kernels live on the native API, see example 04). Results come back as
NumPy arrays, as hapi's do.

    python examples/torch/03_hapi_dropin.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import radtxfr_tpu_torch.hapi_compat as hapi  # noqa: E402
from radtxfr_tpu_torch.lines.hapi_db import save_table  # noqa: E402
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (default: the card) or cpu")
dev = ap.parse_args().device

workdir = tempfile.mkdtemp(prefix="hapi_demo_")
save_table(synthetic_lines(300, 1000.0, 1100.0, seed=11, device=dev,
                           dtype=torch.float64), workdir, "demo")

hapi.db_begin(workdir, device=dev)   # directory-as-database, like hapi
print("tables:", hapi.tableList())
hapi.describeTable("demo")

# condition DSL (reference misc/hapi.py select/filter machinery)
hapi.select("demo", DestinationTableName="strong",
            Conditions=("AND", (">=", "sw", 1e-22),
                        ("between", "nu", 1020.0, 1080.0)))
print("strong lines:", len(hapi.getColumn("strong", "nu")))

# all five absorption drivers, hapi defaults (HITRAN units, 50-HW wings)
env = {"T": 296.0, "p": 0.95}
kw = dict(SourceTables="demo", Environment=env,
          WavenumberRange=(1010.0, 1090.0), WavenumberStep=0.01)
nu, k_v = hapi.absorptionCoefficient_Voigt(**kw)
_, k_sd = hapi.absorptionCoefficient_SDVoigt(**kw)
_, k_l = hapi.absorptionCoefficient_Lorentz(**kw)
_, k_d = hapi.absorptionCoefficient_Doppler(**kw)
_, k_ht = hapi.absorptionCoefficient_HT(**kw)
print(f"Voigt max {k_v.max():.3e} cm^2/molec; "
      f"SDVoigt/HT deltas {abs(k_sd - k_v).max():.2e} / "
      f"{abs(k_ht - k_v).max():.2e}")

# radiance + slit convolution (reference absorptionSpectrum /
# radianceSpectrum / convolveSpectrum) — these take the coefficient in
# cm^-1, i.e. HITRAN_units=False, exactly as in the hapi tutorial
nu, k_cm = hapi.absorptionCoefficient_Voigt(HITRAN_units=False, **kw)
nu_r, rad = hapi.radianceSpectrum(nu, k_cm,
                                  Environment={"T": 296.0, "l": 100.0})
nu_c, rad_c, _, _, _ = hapi.convolveSpectrum(nu_r, rad, Resolution=0.5,
                                             SlitFunction=hapi.SLIT_TRIANGULAR)
print(f"radiance {rad.max():.4g} -> convolved {rad_c.max():.4g} "
      f"on {nu_c.size} points")

for k in (k_v, k_sd, k_l, k_d, k_ht, rad_c):
    assert isinstance(k, np.ndarray) and np.isfinite(k).all() and k.max() > 0
# hapi's .data format carries no SD_air column: the SD-Voigt and HT drivers
# fall back to the Voigt shape on this table
assert abs(k_sd - k_v).max() < 1e-6 * k_v.max()
assert rad_c.max() <= rad.max()                   # a slit only smooths
print("OK")
