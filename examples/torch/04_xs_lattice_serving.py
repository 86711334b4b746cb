#!/usr/bin/env python
"""SD-Voigt cross-section tables and the lattice serving path on the port
(``examples/04_xs_lattice_serving.py`` on ``radtxfr_tpu_torch``).

Replaces ``misc/RT_gen_AbsXS_files.py`` (2.68M-point SD-Voigt tables over
a (T, p) lattice with 350 cm^-1 wings, one state at a time in hapi) with
the CUDA line kernels evaluating the whole lattice in one set of launches
(``make_xsect_fn``: the states are the kernels' layers), written to the
same AFIT_XS binary format; then the serving side: ``od_from_xs`` turns
layered OD synthesis into one matrix product against the lattice read back
from the files.

A small demo grid; ``chip_smoke.py`` phase 13 runs the reference's
400-7100 cm^-1 at 0.0025 lattice through the same calls.

    python examples/torch/04_xs_lattice_serving.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from radtxfr_tpu_torch.atmos.profile import std_atmosphere  # noqa: E402
from radtxfr_tpu_torch.core.grid import arange_drift_free  # noqa: E402
from radtxfr_tpu_torch.io.afit_xs import xs_read, xs_write  # noqa: E402
from radtxfr_tpu_torch.lines.store import IsoTables  # noqa: E402
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines  # noqa: E402
from radtxfr_tpu_torch.products.od import make_xsect_fn  # noqa: E402
from radtxfr_tpu_torch.products.od_from_xs import (  # noqa: E402
    od_from_xs, xs_table_from_files)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (default: the card) or cpu")
dev = ap.parse_args().device

lines = synthetic_lines(800, nu_min=2000.0, nu_max=2200.0, seed=5,
                        device=dev, sd_zero_frac=0.25)
iso = IsoTables.load(device=dev)
X = arange_drift_free(2040.0, 2160.0, 0.0025)

# (T, p) lattice, reference RT_gen_AbsXS_files.py:25-30 style. Pure
# cross-sections (no column factor), so layer amounts enter at serving time.
T_pts = np.arange(250.0, 331.0, 20.0)
p_pts = np.asarray([0.7, 1.0])
TT, PP = [a.ravel() for a in np.meshgrid(T_pts, p_pts, indexing="ij")]

fn = make_xsect_fn(lines, iso, X, TT, PP, profile="sdvoigt", wing_abs=25.0)
f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
K = fn(f32(TT), f32(PP)).cpu().numpy()
print(f"lattice: {TT.size} (T,p) states x {X.size} points, "
      f"max {K.max():.3e}")

# AFIT_XS round trip (io/afit_xs.py matches the reference binary layout),
# then serving: the files assembled into a packed XsTable on the device
with tempfile.TemporaryDirectory(prefix="xs_demo_") as workdir:
    paths = []
    for i, (T, p) in enumerate(zip(TT, PP)):
        f = os.path.join(workdir, f"xs_T{T:g}_p{p:g}.bin")
        xs_write(X, K[i], float(T), float(p) * 101325.0, 1, "demo lattice",
                 fname=f)
        paths.append(f)
    Xr, Kr, meta = xs_read(paths[0])
    assert np.allclose(Kr, K[0], rtol=1e-6)
    print(f"AFIT_XS round-trip ok ({len(paths)} files)")
    table = xs_table_from_files({1: paths}, device=dev)   # molecule 1 (H2O)

# a layered OD is one product M @ sigma against the lattice (bilinear
# corner weights x column densities fold into the small matrix M)
atm = std_atmosphere(device=dev)
od = od_from_xs(table, atm)
assert od.shape == (66, X.size) and bool(torch.isfinite(od).all())
assert od.min().item() >= 0.0
print(f"served OD {tuple(od.shape)} for the 66-layer StdAtmos: "
      f"max {od.max().item():.3e}")
print("OK")
