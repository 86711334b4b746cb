"""Where a cell's parts live, found by name from ``BENCHMARK.json``.

* a workload names a configuration (``configs`` entry: its ``file`` under
  the benchmark's paths, a JSON deployment) and a traffic mix (the data
  file ``benchmark/traffic/<traffic>.json``);
* the traffic mix names its driver (``benchmark/drivers/<driver>.py``),
  the general code that serves requests of that kind;
* each metric, end to end or per layer, is read by
  ``benchmark/metrics/<metric name>.py`` (its ``read(run)``, and
  optionally ``work(cell, state, indices)``: work counts of its own).

A later cell, configuration, mix or metric is new files and new entries,
with no edit to any file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str):
    """The module at ``path`` (a file name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    driver and metrics resolved to files."""

    def __init__(self, spec: dict, name: str, root: str = ROOT):
        work = {w["name"]: w for w in spec["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = work[name]
        self.name = name
        self.root = root
        bench = os.path.join(root, "benchmark")
        cfg = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        self.config_entry = cfg
        self.config_path = os.path.join(root, cfg["file"])
        self.traffic_path = os.path.join(bench, "traffic",
                                         f"{self.workload['traffic']}.json")
        self.config = load_json(self.config_path)
        self.traffic = load_json(self.traffic_path)
        self.driver_path = os.path.join(bench, "drivers",
                                        f"{self.traffic['driver']}.py")

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]
        self.metrics_dir = os.path.join(bench, "metrics")

    def files(self) -> list:
        """Every file the cell needs."""
        return ([self.config_path, self.traffic_path, self.driver_path]
                + [self.metric_path(m["name"])
                   for m in self.end_to_end + self.per_layer])

    def metric_path(self, name: str) -> str:
        return os.path.join(self.metrics_dir, f"{name}.py")

    def driver(self):
        return load_module(self.driver_path,
                           f"bench_driver_{self.traffic['driver']}")

    def metric_module(self, name: str):
        """The module of metric ``name``: its ``read(run)``, and in a
        per-layer metric optionally its own ``work(cell, state,
        indices)``."""
        return load_module(self.metric_path(name),
                           "bench_metric_" + name.replace(".", "_"))

    def reader(self, name: str):
        return self.metric_module(name).read
