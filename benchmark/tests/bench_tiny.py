"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for
the benchmark's own tests: the same drivers, references and checks on the
port's plain versions (CPU tensors)."""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchkit import registry  # noqa: E402

#: the tiny cut of each configuration: narrow bands, few lines and states
TINY = {
    "lwir_tud_prod": {"band": dict(numin=900.0, numax=900.6, dv=0.0005,
                                   line_margin=25.0)},
    "absxs_h2o_co2": {"band": dict(numin=1000.0, numax=1004.0, dv=0.0025,
                                   line_margin=350.0),
                      "T_max": 285.0, "p_min_atm": 0.95},
}
TINY_TRAFFIC = {"members_per_request": 2, "check_outputs": 3,
                "check_points": 256, "check_states": 2, "warmup_requests": 1,
                "trace_requests": 2}


def tiny_cell(name: str, root: str = ROOT) -> registry.Cell:
    """Cell ``name`` of the benchmark under ``root``, cut to :data:`TINY`."""
    cell = registry.Cell(registry.benchmark_spec(root), name, root)
    cell.config.update(TINY.get(cell.workload["config"], {}))
    if "n_lines_per_molecule" in cell.config.get("lines", {}):
        cell.config["lines"]["n_lines_per_molecule"] = 300
    for k, v in TINY_TRAFFIC.items():
        if k in cell.traffic:
            cell.traffic[k] = v
    return cell
