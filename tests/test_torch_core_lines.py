"""The port's core, line-list and line-parameter modules against radtxfr_tpu.

Inputs come from the packaged tables (and a numpy seed) and go through
both packages; float64 throughout unless stated.
"""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.core.grid import arange_drift_free as j_arange
from radtxfr_tpu.core.planck import planckian as j_planckian
from radtxfr_tpu.kernels.lineparams import compute_line_params as j_params
from radtxfr_tpu.kernels.linemixing_data import y_air_for_store as j_y_air
from radtxfr_tpu.lines.derived import derived_lwir_linelist as j_derived
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.core.planck import planckian
from radtxfr_tpu_torch.kernels.lineparams import compute_line_params
from radtxfr_tpu_torch.kernels.linemixing_data import y_air_for_store
from radtxfr_tpu_torch.lines.derived import derived_lwir_linelist
from radtxfr_tpu_torch.lines.store import IsoTables, LineStore
from port_fixtures import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
          "delta_air", "sd_air", "iso_row", "mol_id")


def test_grid_matches():
    for lo, hi, dv in [(690.0, 1410.0, 0.0005), (800.0, 850.0, 0.01),
                       (550.0, 600.0, 0.0025)]:
        # bitwise: the same NumPy construction
        np.testing.assert_array_equal(arange_drift_free(lo, hi, dv),
                                      j_arange(lo, hi, dv))


def test_planckian_matches():
    rng = np.random.default_rng(0)
    X = np.linspace(500.0, 1500.0, 257)
    T = 180.0 + 150.0 * rng.random((3, 4))
    got = planckian(torch.as_tensor(X), torch.as_tensor(T)).numpy()
    want = np.asarray(j_planckian(jnp.asarray(X), jnp.asarray(T)))
    assert got.shape == want.shape == (257, 3, 4)
    # float64: identical formula, ~1e-12 relative
    assert np.abs(got / want - 1.0).max() <= 1e-12


@pytest.mark.parametrize("band", [(691.0, 751.0), (665.0, 1435.0)])
def test_derived_linelist_and_y_air_exactly_equal(band):
    j_store = j_derived(*band)
    store = derived_lwir_linelist(*band, device="cpu", dtype=torch.float64)
    jh, th = j_store.host_view(), store.host_view()
    for f in FIELDS:
        a, b = np.asarray(getattr(jh, f)), np.asarray(getattr(th, f))
        np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=f)
        if f not in ("iso_row", "mol_id"):
            assert np.array_equal(getattr(store, f).numpy(), a), f
    # the mixing coefficients: same NumPy derivation, exactly equal
    np.testing.assert_array_equal(y_air_for_store(th), j_y_air(j_store))


def test_compute_line_params_matches(iso_tables):
    j_store = j_derived(700.0, 760.0)
    hv = j_store.host_view()
    store = LineStore.from_numpy(**{f: getattr(hv, f) for f in FIELDS},
                                 device="cpu", dtype=torch.float64)
    iso = IsoTables.from_numpy(
        **{f: np.asarray(getattr(iso_tables, f))
           for f in ("q", "abundance", "molar_mass", "mol", "iso")},
        device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(3)
    n_lay, L = 5, len(store)
    T = np.array([296.0, 250.0, 220.0, 195.0, 240.0])
    p = np.array([1.0, 0.5, 0.1, 0.01, 0.003])
    x_self = rng.uniform(0.0, 0.03, (n_lay, L))
    scale = rng.uniform(1e19, 1e22, (n_lay, L))
    got = compute_line_params(
        store, iso, torch.as_tensor(T)[:, None], torch.as_tensor(p)[:, None],
        vmr_self=torch.as_tensor(x_self), wing_abs=0.5, wing_hw=50.0,
        strength_scale=torch.as_tensor(scale))
    for i in range(n_lay):
        want = j_params(j_store, iso_tables, T[i], p[i],
                        vmr_self=jnp.asarray(x_self[i]), wing_abs=0.5,
                        wing_hw=50.0, strength_scale=jnp.asarray(scale[i]))
        for f in ("nu0_shifted", "strength", "gamma_d", "gamma_0", "wing",
                  "shift0"):
            a = getattr(got, f)[i].numpy()
            b = np.asarray(getattr(want, f))
            # float64, same operations: <= 1e-12 relative (shift0 can be 0)
            assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), f


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    """No module of the port imports jax or radtxfr_tpu, and importing all
    of them leaves both out of sys.modules (a fresh interpreter: this test
    process has jax loaded by conftest)."""
    pkg = os.path.join(REPO, "radtxfr_tpu_torch")
    mods = []
    for root, _, files in os.walk(pkg):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            for name in _imports(path):
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "radtxfr_tpu"), (path, name)
            rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
            mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                        else rel)
    code = ("import importlib, sys\n"
            f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'radtxfr_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def _default_calls():
    """Each public constructor and builder of the port, called with its
    device left at the default (the card)."""
    from radtxfr_tpu_torch.atmos.continuum import make_layered_mt_ckd
    from radtxfr_tpu_torch.atmos.profile import (AtmosphericState,
                                                 std_atmosphere)
    from radtxfr_tpu_torch.kernels.fused_xsect import (UniformGrid,
                                                       device_plan,
                                                       plan_buckets_packed)
    from radtxfr_tpu_torch.products.tud import make_tud_fn
    from radtxfr_tpu_torch.sensor.resolution import reduce_operator

    X = arange_drift_free(700.0, 710.0, 0.01)
    g = UniformGrid.from_axis(X)
    plan = plan_buckets_packed(np.array([705.0]), g, 1.0, tile=256)
    cols = {f: np.ones(3) for f in FIELDS[:8]}
    cols["nu0"] = np.array([700.0, 701.0, 702.0])
    return {
        "std_atmosphere": lambda: std_atmosphere(),
        "AtmosphericState.from_numpy": lambda: AtmosphericState.from_numpy(
            *(np.ones(2) for _ in range(5)), np.ones((2, 8))),
        "IsoTables.load": lambda: IsoTables.load(),
        "IsoTables.from_numpy": lambda: IsoTables.from_numpy(
            np.ones((2, 119)), np.ones(2), np.ones(2), [1, 2], [1, 1]),
        "LineStore.from_numpy": lambda: LineStore.from_numpy(
            **cols, iso_row=[0, 0, 0], mol_id=[1, 1, 1]),
        "derived_lwir_linelist": lambda: derived_lwir_linelist(700.0, 710.0),
        "device_plan": lambda: device_plan(plan, [0], [705.0]),
        "make_tud_fn": lambda: make_tud_fn(np.arange(3.0), [1.0]),
        "reduce_operator": lambda: reduce_operator(X, 0.25),
        "make_layered_mt_ckd": lambda: make_layered_mt_ckd(X, (1, 2)),
    }


@pytest.mark.parametrize("name", sorted(_default_calls()))
def test_defaults_need_a_card(monkeypatch, name):
    """Left at its default device, every constructor asks for the card and
    raises where there is none: nothing falls back to the CPU (the
    ``cuda`` test in test_torch_cuda.py runs the same defaults on a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _default_calls()[name]()
