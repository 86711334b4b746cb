"""``tools/e2e_drive.py``'s steps through the port's public exports
(``radtxfr_tpu_torch/tools/e2e_drive.py``), on the CPU, against the same
steps through radtxfr_tpu's.

The drive hands its products on as host NumPy arrays, as the JAX drive
does (``np.asarray(tud.tau)`` into ``apparent_radiance``,
``reduce_resolution``, ``hsi_generate``, the compat axis into
``xsect_from_params``); only the sizes are cut: 200 synthetic lines,
800-820 cm^-1 at 0.05 over the 66-layer standard atmosphere. Both
packages run the reference engine in float64 on the same seeded lines;
tau, Lu, Ld, the apparent radiance, the brightness temperature and the
reduced tau agree within 1e-12 of each one's peak. The two error probes
(NaN for a negative radiance, ValueError for a molecule missing from the
atmosphere) run in the drive.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu import (brightness_temperature as j_bt,
                         make_spectral_axis as j_axis,
                         planckian as j_planckian)
from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
from radtxfr_tpu.lines import IsoTables as JIso
from radtxfr_tpu.lines import synthetic_lines as j_synthetic
from radtxfr_tpu.products import (apparent_radiance as j_radiance,
                                  compute_od_layers as j_od_layers,
                                  tud_from_od as j_tud_from_od)
from radtxfr_tpu.sensor.resolution import reduce_resolution as j_reduce

from radtxfr_tpu_torch.tools.e2e_drive import ALTITUDES, SMALL, drive
from port_fixtures import one_torch_thread  # noqa: F401

REL = 1e-12


def _jax_drive(n_lines, line_band, band):
    """The JAX drive's steps in float64 on the CPU, its hand-offs kept."""
    dt = jnp.float64
    atm = j_std_atmosphere(dtype=dt)
    iso = JIso.load(dtype=dt)
    lines = j_synthetic(n_lines, nu_min=line_band[0], nu_max=line_band[1],
                        seed=0, dtype=dt)
    grid = jnp.asarray(j_axis(*band), dtype=dt)
    od = jnp.asarray(j_od_layers(lines, iso, grid, atm, engine="jnp",
                                 pallas_opts=dict(max_groups=2)))
    B = jnp.swapaxes(j_planckian(grid, atm.T), 0, 1).astype(dt)
    alts = jnp.asarray(ALTITUDES, dtype=dt)
    tud = j_tud_from_od(grid, od, B, atm.z0, alts, mu=1.0, n_angles=30)
    tau, Lu, Ld = np.asarray(tud.tau), np.asarray(tud.Lu), np.asarray(tud.Ld)
    emis = jnp.ones((grid.shape[0], 2), dtype=dt) * jnp.asarray([0.95, 0.7],
                                                                dtype=dt)
    L = j_radiance(grid, emis, jnp.asarray([296.0], dtype=dt),
                   tau[:, 3:4, 0], Lu[:, 3:4, 0], Ld[:, None])
    Tb = np.asarray(j_bt(grid, L[:, 0, 0]))
    x_lo, tau_lo = j_reduce(np.asarray(grid, dtype=np.float64), tau[:, 3, 0],
                            0.25)
    return dict(grid=np.asarray(grid), tau=tau, Lu=Lu, Ld=Ld,
                L=np.asarray(L), Tb=Tb, x_lo=np.asarray(x_lo),
                tau_lo=np.asarray(tau_lo))


@pytest.fixture(scope="module")
def drives():
    port = drive("cpu", dtype=torch.float64, engine="jnp", **SMALL)
    return port, _jax_drive(**SMALL)


@pytest.mark.parametrize("name", ["grid", "tau", "Lu", "Ld", "L", "Tb",
                                  "x_lo", "tau_lo"])
def test_drive_matches_jax(drives, name):
    port, want = drives
    got, want = np.asarray(port[name]), want[name]
    assert got.shape == want.shape and got.dtype == want.dtype == np.float64
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= REL, err


def test_drive_steps_and_probes(drives):
    """Every step ran (the HDF5 one too: h5py is installed here), the
    products are finite and in range, and both probes gave what the JAX
    drive expects."""
    port, _ = drives
    assert port["skipped"] == []
    assert port["grid"].size == 400 and port["tau"].shape == (400, 4, 1)
    assert np.isnan(port["bt_bad"]).all()
    assert "no vmr column" in port["probe_error"]
    assert (port["od_c"] >= 0).all() and np.isfinite(port["k_sd"]).all()
    assert port["hsi_L"].shape == (2, 8, 400) and (port["hsi_L"] > 0).all()
    assert port["x_lo"].size < port["grid"].size
