"""The port's production OD builder (make_od_fn: line mixing + mt_ckd on the
derived list) against radtxfr_tpu's line-by-line jnp engine.

The band, 716-726 cm^-1, includes the 720.8 cm^-1 CO2 Q branch; every
fourth StdAtmos layer keeps the jnp engine (all lines at all points) under
a few seconds. The JAX line list, partition tables and atmosphere reach the
port through its from_numpy converters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
from radtxfr_tpu.kernels.linemixing_data import y_air_for_store as j_y_air
from radtxfr_tpu.lines.derived import derived_lwir_linelist as j_derived
from radtxfr_tpu.products import compute_od_layers
from radtxfr_tpu_torch.atmos.profile import AtmosphericState
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.lines.store import IsoTables, LineStore
from radtxfr_tpu_torch.products.od import make_od_fn
from port_fixtures import one_torch_thread  # noqa: F401

FIELDS = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
          "delta_air", "sd_air", "iso_row", "mol_id")

AXIS = arange_drift_free(716.0, 726.0, 0.005)


@pytest.fixture(scope="module")
def reference(iso_tables):
    lay = np.arange(0, 66, 4)
    atm = j_std_atmosphere()
    atm = atm.replace(**{f: getattr(atm, f)[lay]
                         for f in ("z0", "z1", "pl", "p", "T", "vmr")})
    store = j_derived(706.0, 736.0)
    lm = {"y_air": j_y_air(store)}
    want = np.asarray(compute_od_layers(store, iso_tables, jnp.asarray(AXIS),
                                        atm, engine="jnp",
                                        continuum="mt_ckd", line_mixing=lm))
    return store, atm, lm, want


def _port_inputs(store, iso_tables, atm, dtype):
    hv = store.host_view()
    iso = jax.device_get(iso_tables)
    return (LineStore.from_numpy(**{f: getattr(hv, f) for f in FIELDS},
                                 device="cpu", dtype=dtype),
            IsoTables.from_numpy(**{f: getattr(iso, f) for f in
                                    ("q", "abundance", "molar_mass", "mol",
                                     "iso")}, device="cpu", dtype=dtype),
            AtmosphericState.from_numpy(
                **{f: np.asarray(getattr(atm, f))
                   for f in ("z0", "z1", "pl", "p", "T", "vmr")},
                mol_ids=atm.mol_ids, device="cpu", dtype=dtype))


@pytest.mark.parametrize("dtype,n_weideman,bound", [
    # float64 with the jnp engine's 24 Weideman terms: measured 3.4e-12
    (torch.float64, 24, 1e-9),
    # the production float32 builder (16 terms): test_linemixing.py:137
    (torch.float32, 16, 5e-6),
])
def test_make_od_fn_matches_jnp_engine(reference, iso_tables, dtype,
                                       n_weideman, bound):
    store, atm, lm, want = reference
    lines, iso, state = _port_inputs(store, iso_tables, atm, dtype)
    od_fn = make_od_fn(lines, iso, AXIS, state, continuum="mt_ckd",
                       line_mixing=lm, n_weideman=n_weideman)
    assert {c[2] for c in od_fn.calls} == {"asym", "core", "mix"}
    got = od_fn(state.T, state.p, state.pl, state.vmr).numpy()
    assert got.shape == want.shape == (np.asarray(atm.T).size, AXIS.size)
    assert np.abs(got - want).max() <= bound * np.abs(want).max()


def test_unported_branches_raise(reference, iso_tables):
    store, atm, lm, _ = reference
    lines, iso, state = _port_inputs(store, iso_tables, atm, torch.float32)
    # the pointwise continua are ported: test_torch_od_layers.py holds them
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_od_fn(lines, iso, AXIS, state, differentiable=True,
                   line_mixing=lm)
    # Hartmann-Tran is the layered builder make_od_ht_fn's
    with pytest.raises(NotImplementedError, match="make_od_ht_fn"):
        make_od_fn(lines, iso, AXIS, state, profile="ht")
