"""The port's program spans (``radtxfr_tpu_torch.utils.span``) on the CPU:
no ``record_function`` entered while no profiler records; under
``torch.profiler`` each layer's ``radtxfr.<name>`` range, nested as the
layers call each other (the OD builder's line parameters, K1 passes,
merges and continuum; the table lookup; the TUD composition's blocks; the
reduction; the lattice; the ``tud`` phases; the Jacobians' tangents under
``vmap(jvp)``); and every product bit-identical with the profiler on and
off."""

import dataclasses
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from radtxfr_tpu_torch import utils
from radtxfr_tpu_torch.atmos.profile import std_atmosphere
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.dist import make_mesh
from radtxfr_tpu_torch.dist.fused_ensemble import (jacobian_directions,
                                                   make_tud_jacobian_fn)
from radtxfr_tpu_torch.lines.store import IsoTables
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
from radtxfr_tpu_torch.products.jacobian import tud_with_jacobian
from radtxfr_tpu_torch.products.od import (OpticalDepthFn, make_od_fn,
                                           make_od_local_fn, make_xsect_fn,
                                           shard_slice)
from radtxfr_tpu_torch.products.od_from_xs import XsTable, od_from_xs
from radtxfr_tpu_torch.products.tud import tud_from_od
from radtxfr_tpu_torch.sensor.resolution import reduce_operator
from port_fixtures import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
N_LAY = 4
AXIS = arange_drift_free(800.0, 806.0, 0.01)             # 601 points
ALTS = [2.0, 500.0]


@pytest.fixture(scope="module")
def inputs():
    full = std_atmosphere(device=CPU)
    st = dataclasses.replace(full, **{f: getattr(full, f)[:N_LAY] for f in
                                      ("z0", "z1", "pl", "p", "T", "vmr")})
    lines = synthetic_lines(60, nu_min=795.0, nu_max=811.0, seed=3,
                            device=CPU)
    y_air = np.where(np.arange(60) % 3 == 0, 0.02, 0.0)
    return lines, IsoTables.load(device=CPU), st, y_air


def recorded(fn):
    """``fn()`` under ``torch.profiler`` (CPU), and the program spans it
    recorded as (name without ``radtxfr.``, start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name[len("radtxfr."):], e.time_range.start,
              e.time_range.end) for e in prof.events()
             if e.name.startswith("radtxfr.")]
    return out, spans


def names(spans):
    return {n for n, _, _ in spans}


def holds(spans, outer, inner):
    """Some ``outer`` span holds some ``inner`` span."""
    return any(o0 <= i0 and i1 <= o1
               for o, o0, o1 in spans if o == outer
               for i, i0, i1 in spans if i == inner)


def leaves(out):
    """Every tensor of a product (a tensor, TUD, tuple or dict)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if dataclasses.is_dataclass(out):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    return [t for v in out for t in leaves(v)]


def same_bits(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _od_fn(inputs):
    lines, iso, st, y_air = inputs
    return make_od_fn(lines, iso, AXIS, st, continuum="mt_ckd",
                      line_mixing={"y_air": y_air})


def _table(st):
    rng = np.random.default_rng(5)
    T_grid = np.array([200.0, 250.0, 300.0])
    logp = np.log(np.array([0.1, 0.5, 1.0, 1.2]))
    sigma = rng.lognormal(-50.0, 1.0, (2, 3, 4, AXIS.size))
    return XsTable.from_numpy(sigma, T_grid, logp, AXIS, (1, 2), device=CPU)


def _products(inputs):
    """Each layer's call with its inputs, by the spans it should record."""
    lines, iso, st, _ = inputs
    od_fn = _od_fn(inputs)
    od = od_fn(st.T, st.p, st.pl, st.vmr)
    B = torch.rand(od.shape, dtype=od.dtype, generator=torch.Generator()
                   .manual_seed(1))
    op = reduce_operator(AXIS, 0.25, device=CPU)
    xs_fn = make_xsect_fn(lines, iso, AXIS, [260.0, 290.0], [0.5, 1.0])
    T_lat = torch.tensor([260.0, 290.0])
    p_lat = torch.tensor([0.5, 1.0])
    table = _table(st)
    x = torch.as_tensor(AXIS, dtype=od.dtype)
    return {
        "od": lambda: od_fn(st.T, st.p, st.pl, st.vmr),
        "od_from_xs": lambda: od_from_xs(table, st),
        "tud_from_od": lambda: tud_from_od(x, od, B, st.z0, ALTS,
                                           n_angles=4),
        "reduce": lambda: op(od.T),
        "xsect": lambda: xs_fn(T_lat, p_lat),
    }


def test_span_is_a_shared_no_op_without_a_profiler(inputs, monkeypatch):
    """No ``record_function`` (nor the function-scope record the spans
    open) is entered while no profiler records, in any layer, the phases
    and the Jacobian included."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    calls = _products(inputs)
    lines, iso, st, _ = inputs
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert utils.span("od") is utils.span("tud")
    for fn in calls.values():
        fn()
    timer = utils.PhaseTimer()
    with timer.phase("build"):
        pass
    assert set(timer.phases) == {"build"}
    tud_with_jacobian(lines, iso, AXIS, st, ALTS, wrt=("T",), n_angles=4,
                      tangent_batch=2, engine="pallas")


def test_od_records_its_layers_nested(inputs):
    """``make_od_fn`` with the continuum and line mixing: ``od`` holds the
    line parameters, each K1 pass, each merge and the continuum."""
    lines, iso, st, _ = inputs
    od_fn = _od_fn(inputs)
    modes = {mode for _, _, mode in od_fn.all_calls()}
    assert "mix" in modes and len(modes) >= 2
    _, spans = recorded(lambda: od_fn(st.T, st.p, st.pl, st.vmr))
    for inner in ("od.line_params", "k1.merge", "od.continuum",
                  *(f"k1.{m}" for m in modes)):
        assert holds(spans, "od", inner), inner
    assert [n for n, _, _ in spans].count("k1.merge") == len(od_fn.calls)


@pytest.mark.parametrize("layer,outer,inner", [
    ("od_from_xs", "od", ("od.xs_weights", "od.xs_matmul")),
    ("tud_from_od", "tud", ("tud.tau", "tud.lu", "tud.ld")),
    ("reduce", "reduce", ()),
    ("xsect", "xsect", ("xsect.line_params", "k1.merge")),
])
def test_layer_records_its_spans(inputs, layer, outer, inner):
    _, spans = recorded(_products(inputs)[layer])
    assert outer in names(spans)
    for name in inner:
        assert holds(spans, outer, name), name


def test_phase_timer_phase_is_a_span():
    timer = utils.PhaseTimer()

    def run():
        with timer.phase("od+tud+reduce", work_items=4.0):
            torch.ones(3).sum()

    _, spans = recorded(run)
    assert names(spans) == {"phase.od+tud+reduce"}
    assert timer.work == {"od+tud+reduce": 4.0}


def test_jacobian_tangents_record_od_and_tud(inputs):
    """``tud_with_jacobian`` and ``make_tud_jacobian_fn`` (a 1 x 1 CPU
    mesh): spans opened under ``vmap(jvp)`` are recorded, ``od`` and
    ``tud`` inside ``jacobian.tangent``."""
    lines, iso, st, _ = inputs
    _, spans = recorded(lambda: tud_with_jacobian(
        lines, iso, AXIS, st, ALTS, wrt=("T",), n_angles=4, tangent_batch=2,
        engine="pallas", continuum="mt_ckd"))
    for inner in ("od", "tud", "planck", "od.continuum", "k1.full"):
        assert holds(spans, "jacobian.tangent", inner), inner
        assert holds(spans, "jacobian.primal", inner), inner
    mesh = make_mesh(1, 1, devices=[CPU])
    _, run = make_tud_jacobian_fn(lines, iso, AXIS, st, ALTS, mesh,
                                  n_angles=4)
    V_T, V_vmr, _ = jacobian_directions(st)
    _, spans = recorded(lambda: run(st.T, st.vmr, V_T[:2], V_vmr[:2]))
    for inner in ("od", "tud", "tud.lu", "planck", "k1.full"):
        assert holds(spans, "jacobian.tangent", inner), inner
    assert "jacobian.gather" in names(spans)


@pytest.mark.parametrize("layer", ["od", "od_from_xs", "tud_from_od",
                                   "reduce", "xsect"])
def test_products_bit_identical_with_the_profiler(inputs, layer):
    fn = _products(inputs)[layer]
    off = fn()
    on, spans = recorded(fn)
    assert spans and same_bits(off, on)


def test_jacobian_bit_identical_with_the_profiler(inputs):
    lines, iso, st, _ = inputs
    mesh = make_mesh(1, 1, devices=[CPU])
    _, run = make_tud_jacobian_fn(lines, iso, AXIS, st, ALTS, mesh,
                                  n_angles=4, continuum="mt_ckd")
    V_T, V_vmr, _ = jacobian_directions(st)
    pick = [0, N_LAY + 1]

    def call():
        return run(st.T, st.vmr, V_T[pick], V_vmr[pick])

    off = call()
    on, spans = recorded(call)
    assert "jacobian.tangent" in names(spans) and same_bits(off, on)
    kw = dict(wrt=("T", 1), n_angles=4, tangent_batch=3, engine="pallas")
    off = tud_with_jacobian(lines, iso, AXIS, st, ALTS, **kw)
    on, _ = recorded(lambda: tud_with_jacobian(lines, iso, AXIS, st, ALTS,
                                               **kw))
    assert same_bits(off, on)


@pytest.mark.parametrize("route", ["od", "shard"])
def test_each_pass_is_freed_once_merged(inputs, monkeypatch, route):
    """A pass's output is dropped as soon as it is added into the sum (as
    before the spans): the card never holds the previous pass beside the
    next one, which the Jacobian's tangents would pay for in memory."""
    lines, iso, st, y_air = inputs
    if route == "od":
        fn = _od_fn(inputs)
    else:
        local, spec, _ = make_od_local_fn(lines, iso, AXIS, st, 1,
                                          continuum="mt_ckd",
                                          line_mixing={"y_air": y_air})
        fn = local.bind(shard_slice(spec, 0))
    live, run_call = [], OpticalDepthFn.run_call

    def watched(self, *args, **kw):
        assert all(ref() is None for ref in live)
        out = run_call(self, *args, **kw)
        live.append(weakref.ref(out))
        return out

    monkeypatch.setattr(OpticalDepthFn, "run_call", watched)
    fn(st.T, st.p, st.pl, st.vmr)
    assert len(live) >= 2 and all(ref() is None for ref in live)

