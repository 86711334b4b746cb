"""The port's cross-section serving path (``radtxfr_tpu_torch/products/
od_from_xs.py``) against ``radtxfr_tpu.products.od_from_xs`` on the CPU.

* A float64 table carried across with ``XsTable.from_numpy``:
  ``interp_sigma`` and ``od_from_xs`` within 1e-12 of JAX's, at lattice
  nodes, between them and clamped beyond the edges (the standard
  atmosphere's T and p leave the lattice on both sides).
* ``build_xs_table`` (the reference engine) against JAX's on a small
  synthetic band with 2 molecules and a 3 x 2 lattice, both tables
  float32: within 1e-6 of each molecule's peak.
* ``xs_table_from_files`` on AFIT_XS files JAX wrote: the arrays JAX reads,
  and JAX's two errors (a file on another nu axis, a missing entry).
* Node exactness against the port's own line-by-line engine at the JAX
  test's ``rtol=2e-5``; a table molecule with no vmr column raises;
  ``precision="default"`` equals ``"highest"`` on the CPU (no TF32 there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radtxfr_tpu.atmos import std_atmosphere as jax_std_atmosphere
from radtxfr_tpu.core.constants import PA_PER_ATM
from radtxfr_tpu.io.afit_xs import xs_write as jax_xs_write
from radtxfr_tpu.lines.store import IsoTables as JaxIsoTables
from radtxfr_tpu.lines.synthetic import synthetic_lines as jax_synthetic
from radtxfr_tpu.products import od_from_xs as jax_od_from_xs
from radtxfr_tpu.products.od_from_xs import (XsTable as JaxXsTable,
                                             build_xs_table as jax_build,
                                             interp_sigma as jax_interp,
                                             xs_table_from_files as jax_files)

from radtxfr_tpu_torch.atmos.profile import std_atmosphere
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.lines.store import IsoTables
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
from radtxfr_tpu_torch.products import (XsTable, build_xs_table,
                                        compute_od_layers, od_from_xs,
                                        xs_table_from_files)
from radtxfr_tpu_torch.products.od_from_xs import interp_sigma
from port_fixtures import one_torch_thread  # noqa: F401

F64 = dict(device="cpu", dtype=torch.float64)
BAND = (800.0, 810.0, 0.01)
SPECIES = ((1, 1), (2, 1))
LINES = dict(n_lines=60, nu_min=795.0, nu_max=815.0, species=SPECIES,
             seed=7)
T_GRID = np.array([220.0, 260.0, 300.0])
P_GRID = np.array([0.2, 1.0])


@pytest.fixture(scope="module")
def tables():
    """The same random float64 lattice in both packages: 2 molecules,
    T 230-280 K, p 0.1-0.8 atm (the standard atmosphere lies on both sides
    of both axes), 40 points."""
    rng = np.random.default_rng(3)
    sigma = rng.uniform(0.0, 1e-21, (2, 3, 4, 40))
    T = np.array([230.0, 255.0, 280.0])
    logp = np.log(np.array([0.1, 0.3, 0.5, 0.8]))
    x = np.linspace(800.0, 810.0, 40)
    jt = JaxXsTable(sigma=jnp.asarray(sigma), T_grid=jnp.asarray(T),
                    logp_grid=jnp.asarray(logp), x=x, mol_ids=(1, 3))
    tt = XsTable.from_numpy(sigma, T, logp, x, (1, 3), **F64)
    return jt, tt


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("T,p", [(255.0, 0.3), (262.5, 0.41), (200.0, 0.05),
                                 (310.0, 1.2), (240.0, 2.0)])
def test_interp_sigma_matches_jax(tables, T, p):
    jt, tt = tables
    assert _rel(interp_sigma(tt, T, p).numpy(), jax_interp(jt, T, p)) <= 1e-12


def test_od_from_xs_matches_jax(tables):
    jt, tt = tables
    want = np.asarray(jax_od_from_xs(jt, jax_std_atmosphere()))
    got = od_from_xs(tt, std_atmosphere(**F64))
    assert got.shape == (66, 40) and got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-12
    # explicit vmr columns: H2O and O3 of the standard atmosphere
    want = np.asarray(jax_od_from_xs(jt, jax_std_atmosphere(),
                                     vmr_cols=(0, 2)))
    got = od_from_xs(tt, std_atmosphere(**F64), vmr_cols=(0, 2))
    assert _rel(got.numpy(), want) <= 1e-12


def test_precision_default_equals_highest_on_the_cpu(tables):
    _, tt = tables
    atm = std_atmosphere(**F64)
    assert torch.equal(od_from_xs(tt, atm, precision="default"),
                       od_from_xs(tt, atm))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    with pytest.raises(ValueError, match="precision"):
        od_from_xs(tt, atm, precision="bf16")


def test_missing_molecule_raises(tables):
    jt, tt = tables
    atm = std_atmosphere(**F64)
    bad = atm.replace(mol_ids=(99,) * len(atm.mol_ids))
    with pytest.raises(ValueError, match="no vmr column"):
        od_from_xs(tt, bad)
    with pytest.raises(ValueError, match="no vmr column"):
        jax_od_from_xs(jt, jax_std_atmosphere().replace(
            mol_ids=(99,) * len(atm.mol_ids)))


def test_build_xs_table_matches_jax():
    """Both from float64 lines (JAX's builder cannot take float32 lines
    with x64 on: its scan's carry turns float64), both tables float32."""
    grid = arange_drift_free(*BAND)
    want = jax_build(jax_synthetic(**LINES), JaxIsoTables.load(), grid,
                     T_GRID, P_GRID)
    got = build_xs_table(synthetic_lines(**LINES, **F64),
                         IsoTables.load(**F64), grid, T_GRID, P_GRID)
    assert got.mol_ids == want.mol_ids == (1, 2)
    assert got.sigma.dtype == torch.float32
    assert got.sigma.shape == (2, 3, 2, grid.size)
    np.testing.assert_array_equal(got.T_grid.numpy(), np.asarray(want.T_grid))
    np.testing.assert_array_equal(got.logp_grid.numpy(),
                                  np.asarray(want.logp_grid))
    for m in range(2):       # each molecule against its own peak
        assert _rel(got.sigma[m].numpy(), np.asarray(want.sigma)[m]) <= 1e-6


def test_xs_table_from_files_reads_jax_files(tmp_path):
    grid = arange_drift_free(*BAND)
    rng = np.random.default_rng(5)
    sigma = rng.uniform(0.0, 1e-20, (2, 3, 2, grid.size))
    paths = {}
    for im, m in enumerate((2, 1)):
        paths[m] = []
        for it, T in enumerate(T_GRID):
            for ip, p in enumerate(P_GRID):
                fn = str(tmp_path / f"xs_{m}_{it}_{ip}.bin")
                jax_xs_write(grid, sigma[im, it, ip], float(T),
                             float(p * PA_PER_ATM), m, "test", fname=fn)
                paths[m].append(fn)
    want = jax_files(paths)
    got = xs_table_from_files(paths, device="cpu")
    assert got.mol_ids == want.mol_ids == (1, 2)
    np.testing.assert_array_equal(got.sigma.numpy(), np.asarray(want.sigma))
    np.testing.assert_array_equal(got.T_grid.numpy(), np.asarray(want.T_grid))
    np.testing.assert_array_equal(got.logp_grid.numpy(),
                                  np.asarray(want.logp_grid))
    np.testing.assert_array_equal(got.x, want.x)

    # a file on another nu axis: the same error in both packages
    other = str(tmp_path / "other.bin")
    jax_xs_write(grid + 0.5, sigma[0, 0, 0], 220.0, 0.2 * PA_PER_ATM, 1,
                 "test", fname=other)
    shifted = {1: paths[1][:-1] + [other], 2: paths[2]}
    for fn in (jax_files, lambda p: xs_table_from_files(p, device="cpu")):
        with pytest.raises(ValueError, match="nu axis differs"):
            fn(shifted)
    # a missing lattice entry
    short = {1: paths[1][:-1], 2: paths[2]}
    for fn in (jax_files, lambda p: xs_table_from_files(p, device="cpu")):
        with pytest.raises(ValueError, match="missing lattice entry"):
            fn(short)


def test_node_exact_against_the_port_engine():
    """At a lattice node the served OD is the line-by-line engine's (the
    JAX test's bound): one homogeneous layer at (260 K, 1 atm) with
    negligible mixing fractions, where self-broadening vanishes too."""
    grid = arange_drift_free(*BAND)
    lines = synthetic_lines(**LINES, **F64)
    iso = IsoTables.load(**F64)
    table = build_xs_table(lines, iso, grid, T_GRID, P_GRID)
    atm = std_atmosphere(**F64)
    one = lambda v: torch.full((1,), v, dtype=torch.float64)
    layer = atm.replace(T=one(260.0), p=one(PA_PER_ATM), pl=one(1.0),
                        z0=atm.z0[:1], z1=atm.z1[:1], vmr=atm.vmr[:1] * 1e-6)
    want = compute_od_layers(lines, iso, torch.as_tensor(grid), layer)
    got = od_from_xs(table, layer)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=1e-8 * want.abs().max().item())
