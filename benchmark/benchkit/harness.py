"""One run of one cell: set-up, the measured window, the check, the
result line.

A driver (``benchmark/drivers/<name>.py``) serves one kind of request and
exposes ``setup(cell, seed, device) -> state`` (inputs made from the seed,
the program's builders, every shape of the cell warmed up; ``state``
carries ``plan_build_s``), ``request(state, i) -> Record`` (request ``i``
from dispatch to its products on the host, spans around each call into
the program), ``work(state, indices) -> dict`` (the benchmark's own work
counts of those requests, for the rooflines), ``release(state, samples)
-> ref`` (what the check needs, taken before the program's state is
freed) and
``check(ref, samples, dtype) -> [(name, value, limit)]`` (the plain
reference against the stored samples of the requests chosen from the
seed). A metric's file (``benchmark/metrics/<name>.py``) may define
``work(cell, state, indices) -> dict`` too: a traced run adds what it
returns to the driver's work counts, so a new roofline needs no edit of
the driver.

The window is a closed loop of one client: request after request until
``--seconds`` have passed, every request timed from its dispatch to its
products on the host. A rate is all the work of the window over all its
time; a tail is over every request.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback

import numpy as np
import torch

from . import tracing

#: top-level module names that a run may not hold once its window closed
#: (the JAX stack and the JAX package; the port's own name only begins with
#: the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "radtxfr_tpu")


@dataclasses.dataclass
class Record:
    """What a request leaves for the metrics and the check."""

    units: int               # spectra, states or directions completed
    sample: object = None    # the products the check compares
    group: object = None     # the check draws its requests from each group


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    plan_build_s: float
    window_s: float
    latencies_s: list
    units: int
    attempted: int
    failed: int
    members: int = 0
    trace: tracing.Trace | None = None
    work: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    cell: object = None      # the registry's Cell: config and traffic


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def rng_for(seed: int, *purpose: int) -> np.random.Generator:
    """A NumPy generator of ``seed`` for one purpose (a seed above 32 bits
    included)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed),
                                                         *purpose]))


def window(driver, state, seconds: float, start: int = 0):
    """Requests back to back until ``seconds`` have passed: (window
    seconds, latencies, records by index, attempted, failed)."""
    lat, recs, failed = [], {}, 0
    i = start
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            recs[i] = driver.request(state, i)
        except Exception:               # noqa: BLE001 — a failed request
            failed += 1
            traceback.print_exc(file=sys.stderr)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        i += 1
        if t1 - t_start >= seconds:
            break
    return t1 - t_start, lat, recs, i - start, failed


def choose(recs: dict, seed: int, k: int) -> list:
    """``k`` of the completed requests of each group (a record's
    ``group``: the lattice's molecule), drawn from the seed."""
    groups = {}
    for i in sorted(recs):
        groups.setdefault(repr(recs[i].group), []).append(i)
    rng = rng_for(seed, 7)
    out = []
    for g in sorted(groups):
        done = groups[g]
        pick = rng.choice(len(done), size=min(k, len(done)), replace=False)
        out += [done[int(j)] for j in pick]
    return sorted(out)


def work_counts(cell, driver, state, indices) -> dict:
    """The driver's work counts of the traced requests, and those of every
    per-layer metric whose file defines ``work``."""
    work = dict(driver.work(state, indices))
    for m in cell.per_layer:
        fn = getattr(cell.metric_module(m["name"]), "work", None)
        if fn is not None:
            work.update(fn(cell, state, indices))
    return work


def run_cell(cell, seed: int, seconds: float, trace: bool, t_origin: float,
             device="cuda", control=None, fault=None) -> dict:
    """One run of ``cell``: the result line's object, with the compared
    numbers under ``checks``. ``control`` (a dtype, or the driver's own
    lower-precision path with ``"program"``) puts the control in the
    program's place for the check; ``fault`` (a name the driver knows)
    breaks the timed path underneath. Neither is used by the benchmark's
    own runs."""
    driver = cell.driver()
    dev = torch.device(device)
    state = driver.setup(cell, seed, dev, control=control, fault=fault)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_origin
    print(f"setup: {setup_s:.3f} s; " + ", ".join(
        f"{k} {v:.3f} s" for k, v in getattr(state, "phases", {}).items()),
        file=sys.stderr)
    n_trace = int(cell.traffic.get("trace_requests", 8))
    tr = None
    if trace:
        (win_s, lat, recs, attempted, failed), tr = tracing.profile_window(
            lambda: _count_window(driver, state, n_trace))
    else:
        win_s, lat, recs, attempted, failed = window(driver, state, seconds)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    work = work_counts(cell, driver, state, sorted(recs)) if trace else {}
    run = Run(setup_s=setup_s, plan_build_s=state.plan_build_s,
              window_s=win_s, latencies_s=lat,
              units=sum(r.units for r in recs.values()),
              attempted=attempted, failed=failed,
              members=getattr(state, "members_per_request", 1) * len(recs),
              trace=tr, work=work, memory_peak_bytes=int(peak), cell=cell)
    chosen = choose(recs, seed, int(cell.traffic.get("check_requests", 2)))
    samples = {i: recs[i].sample for i in chosen}
    del recs
    ref = driver.release(state, samples)
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = driver.check(ref, samples,
                          control if isinstance(control, torch.dtype)
                          else None)
    print(f"window: {attempted} requests in {win_s:.3f} s, the first "
          f"{lat[0]:.4f} s, the median {float(np.median(lat)):.4f} s; "
          f"check: {len(samples)} requests in "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = (failed == 0 and bool(checks)
               and all(v <= lim for _, v, lim in checks))
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": device_info(dev, peak, tr)}
    if tr is not None:
        out["breakdown"] = tracing.breakdown(tr)
        out["bound_by"] = {k[:-3]: v for k, v in work.items()
                           if k.endswith("_by")}
        print(f"trace: {tr.n_device} device activities, "
              f"{tr.n_attributed} attributed to spans; "
              f"bounds {out['bound_by']}", file=sys.stderr)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def _count_window(driver, state, n: int):
    """``n`` requests in a row (a traced run's window)."""
    lat, recs, failed = [], {}, 0
    t_start = time.perf_counter()
    for i in range(n):
        t0 = time.perf_counter()
        try:
            recs[i] = driver.request(state, i)
        except Exception:               # noqa: BLE001 — a failed request
            failed += 1
            traceback.print_exc(file=sys.stderr)
        lat.append(time.perf_counter() - t0)
    return time.perf_counter() - t_start, lat, recs, n, failed


def device_info(dev, peak: int, tr) -> dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if tr is not None:
        info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    return info
