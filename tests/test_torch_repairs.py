"""The port's public surface against radtxfr_tpu's, and K1's window culling
rule against the plain version's window mask.

* Every name a JAX subpackage ``__init__`` (and the top-level one) exports
  and the port's module at the same path defines is exported by the port's
  subpackage, and importing them loads neither JAX nor ``radtxfr_tpu``
  (checked in a fresh interpreter: this process has JAX loaded).
* ``tud`` takes the JAX CLI's ``--engine`` and ``--partition``; ``--engine
  jnp`` raises, naming the ROADMAP item.
* K1 (``csrc/fused_xsect.cu::window_range``) keeps a staged (slot, layer)
  pair only where the integer range [k_line + floor(frac0 - wingu) - 2,
  k_line + ceil(frac0 + wingu) + 2] meets the CTA's points: that range must
  hold every grid index at which the plain version's float32 window test
  passes; in the core pass (``core_range``) every index where that test and
  hum1_wei's |x| + y < 15 both pass, the only points core adds to.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from radtxfr_tpu_torch.cli.main import build_parser, run_tud
from port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("core", "lines", "kernels", "atmos", "products", "sensor",
               "io")


def _jax_exports(rel):
    """[(module, name)] of ``radtxfr_tpu/<rel>/__init__.py``, read as
    source (importing it loads JAX); ``*`` from a module expands to its
    upper-case assignments."""
    pkg = os.path.join(ROOT, "radtxfr_tpu", *rel.split("/"))
    tree = ast.parse(open(os.path.join(pkg, "__init__.py")).read())
    out = []
    for node in tree.body:
        if not isinstance(node, ast.ImportFrom) or node.level != 1:
            continue
        for alias in node.names:
            if alias.name != "*":
                out.append((node.module, alias.name))
                continue
            src = ast.parse(open(os.path.join(
                pkg, *node.module.split(".")) + ".py").read())
            out += [(node.module, t.id) for n in src.body
                    if isinstance(n, ast.Assign) for t in n.targets
                    if isinstance(t, ast.Name) and t.id.isupper()]
    return out


_CHECK = """
import importlib, json, sys
wanted = json.loads(sys.argv[1])
res = {}
for rel, pairs in wanted.items():
    pkg = "radtxfr_tpu_torch" + ("." + rel.replace("/", ".") if rel else "")
    sub = importlib.import_module(pkg)
    ported, missing = [], []
    for mod, name in pairs:
        try:
            m = importlib.import_module(pkg + "." + mod)
        except ImportError:
            continue
        if hasattr(m, name):
            ported.append(name)
            if getattr(sub, name, None) is not getattr(m, name):
                missing.append(name)
    res[rel] = {"ported": ported, "missing": missing}
res["loaded"] = sorted(k for k in sys.modules
                       if k.split(".")[0] in ("jax", "radtxfr_tpu"))
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def exports():
    wanted = {rel: _jax_exports(rel) for rel in SUBPACKAGES}
    wanted[""] = _jax_exports("")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    run = subprocess.run([sys.executable, "-c", _CHECK, json.dumps(wanted)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         check=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("rel", ("",) + SUBPACKAGES)
def test_subpackage_exports_the_ported_names(exports, rel):
    got = exports[rel]
    assert got["ported"], f"no ported name of radtxfr_tpu/{rel}"
    assert not got["missing"], got["missing"]
    # and nothing of JAX or of the JAX package came with them
    assert exports["loaded"] == []


@pytest.mark.parametrize("engine,partition", [("auto", None),
                                              ("pallas", "equal"),
                                              ("pallas", "weighted")])
def test_tud_takes_engine_and_partition(engine, partition):
    argv = ["tud", "--derived", "--engine", engine]
    if partition:
        argv += ["--partition", partition]
    args = build_parser().parse_args(argv)
    assert args.engine == engine
    assert args.partition == (partition or "weighted")


def test_tud_engine_jnp_raises():
    args = build_parser().parse_args(["tud", "--derived", "--engine", "jnp",
                                      "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        run_tud(args, "cpu")


def _window_range(f0, wingu):
    """K1's window_range (csrc/fused_xsect.cu), in float32."""
    f0 = np.asarray(f0, dtype=np.float32)
    wingu = np.asarray(wingu, dtype=np.float32)
    with np.errstate(invalid="ignore"):
        wide = ~(wingu <= np.float32(4194304.0))
        lo = np.floor(f0 - wingu).astype(np.int64) - 2
        hi = np.ceil(f0 + wingu).astype(np.int64) + 2
    return (np.where(wide, -(1 << 30), lo), np.where(wide, 1 << 30, hi))


def _core_range(f0, ds, xs, y, lo, hi):
    """K1's core_range, in float32: the window range cut to the indices
    that can lie in |x| + y < 15."""
    f32 = np.float32
    r = (f32(15.0) - y) / xs
    clo, chi = _window_range(f0 + ds, r * f32(1.0001) + f32(1.0))
    empty = ~(r > 0)
    return (np.where(empty, 1, np.maximum(lo, clo)),
            np.where(empty, 0, np.minimum(hi, chi)))


@pytest.fixture(scope="module")
def production_passes():
    from radtxfr_tpu_torch.atmos.profile import std_atmosphere
    from radtxfr_tpu_torch.core.grid import arange_drift_free
    from radtxfr_tpu_torch.kernels.linemixing_data import y_air_for_store
    from radtxfr_tpu_torch.lines.derived import derived_lwir_linelist
    from radtxfr_tpu_torch.lines.store import IsoTables
    from radtxfr_tpu_torch.products.od import make_od_fn

    f32 = torch.float32
    store = derived_lwir_linelist(693.0, 748.0, device="cpu", dtype=f32)
    base = std_atmosphere(device="cpu", dtype=f32)
    fn = make_od_fn(store, IsoTables.load(device="cpu", dtype=f32),
                    arange_drift_free(718.0, 723.0, 0.0005), base,
                    line_mixing={"y_air": y_air_for_store(
                        store.host_view())})
    prm, _ = fn.line_params(base.T, base.p, base.pl, base.vmr)
    return fn, prm


@pytest.mark.parametrize("mode", ("asym", "core", "mix"))
def test_window_range_holds_the_plain_window(production_passes, mode):
    fn, prm = production_passes
    calls = [c for c in fn.calls if c[2] == mode]
    assert calls
    n_in = n_kept = n_pairs = 0
    for lay, dp, _ in calls:
        line = dp.line.numpy()
        k_line = dp.k_line.numpy().astype(np.int64)
        frac0 = dp.frac0.numpy()
        tile_of = np.repeat(np.arange(dp.n_tiles),
                            dp.counts.numpy().astype(np.int64) * dp.block)
        s = np.nonzero(line[:tile_of.size] >= 0)[0]
        g, t = line[s], tile_of[s]
        k = (t[:, None] * dp.tile + np.arange(dp.tile)[None, :])
        # the plain version's u and mask, float32 (fused_xsect._plain_steps)
        u = ((k - k_line[s][:, None]).astype(np.float32)
             - frac0[s][:, None])
        for li in lay.numpy():
            w = np.minimum(prm.wing.numpy()[li, g], dp.wcap.numpy()[s])
            wingu = (torch.as_tensor(w) / dp.dx).numpy()[:, None]
            mask = (u > -wingu) & (u <= wingu) & (k < dp.n_out)
            lo, hi = _window_range(frac0[s], wingu[:, 0])
            if mode == "core":
                # line_const's Voigt constants, float32 as in the kernel
                cte = (torch.tensor(0.8325546111576977, dtype=torch.float32)
                       / prm.gamma_d[li, g]).numpy()
                ds = (prm.shift0[li, g] / dp.dx).numpy()
                xs = (dp.dx * torch.as_tensor(cte)).numpy()
                y = (prm.gamma_0[li, g] * torch.as_tensor(cte)).numpy()
                x = (u - ds[:, None]) * xs[:, None]
                mask &= (np.abs(x) + y[:, None]) < np.float32(15.0)
                lo, hi = _core_range(frac0[s], ds, xs, y, lo, hi)
            d = k - k_line[s][:, None]
            inside = (d >= lo[:, None]) & (d <= hi[:, None]) & (k < dp.n_out)
            assert not (mask & ~inside).any(), (mode, li)
            n_in += int(mask.sum())
            n_kept += int(inside.sum())
            n_pairs += mask.shape[0]
    # the range is tight: at most 6 indices more than the window a pair
    # (core: than the window's part in |x| + y < 15, with its 1e-4 margin)
    assert n_in > 0 and n_kept - n_in <= 6 * n_pairs
