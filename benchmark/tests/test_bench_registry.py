"""BENCHMARK.json against the contract's form, every cell resolved to its
files by name, and a cell added from new files alone."""

from __future__ import annotations

import json
import os
import re
import shutil
import time

import pytest
import torch

from bench_tiny import BENCH, ROOT, tiny_cell
from benchkit import registry
from benchkit.harness import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = registry.benchmark_spec(ROOT)


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    cells = len(SPEC["workloads"])
    # a full check: 2 + 14 runs a cell at run_seconds + 60 s, 180 s of
    # compile a cell, 1200 s spare, within 43200 s at 24 cells
    full = (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200
    assert full <= 43200
    assert 1 <= cells <= 24


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_keys(section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[section]
    names = [e["name"] for e in SPEC[section]]
    assert len(set(names)) == len(names)
    for e in SPEC[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_metrics_and_cells_agree():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells
            assert w in moved.get("workloads", cells), (m["name"], w)
    for w in cells.values():
        assert w["chips"] == 1
        mine = [m for m in SPEC["end_to_end"]
                if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", cells)
                   for m in SPEC["per_layer"])
    used = {w["config"] for w in cells.values()}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_to_its_files(name):
    cell = registry.Cell(SPEC, name, ROOT)
    for path in cell.files():
        assert os.path.isfile(path), path
        assert os.path.abspath(path).startswith(BENCH + os.sep)
    assert callable(cell.driver().request)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
    cfg = cell.config
    entry = cell.config_entry
    assert set(entry["reduced"]) == set(cfg["reduced"])
    for k in entry["reduced"]:
        assert k in cfg


def test_a_cell_added_from_new_files_runs(tmp_path):
    """Copy BENCHMARK.json and benchmark/ aside, add a configuration, a
    traffic mix and a per-layer metric as new files and new entries (no
    existing file edited), and run the new cell on the CPU."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    os.symlink(os.path.join(ROOT, "radtxfr_tpu_torch"),
               root / "radtxfr_tpu_torch")
    os.symlink(os.path.join(ROOT, "radtxfr_tpu"), root / "radtxfr_tpu")
    before = {p: open(p, "rb").read() for p in
              (str(q) for q in (root / "benchmark").rglob("*.*"))
              if os.path.isfile(p)}
    cfg = json.load(open(os.path.join(BENCH, "configs",
                                      "lwir_tud_prod.json")))
    cfg.update(name="lwir_tud_narrow", band=dict(
        numin=1100.0, numax=1100.6, dv=0.0005, line_margin=25.0))
    (root / "benchmark/configs/lwir_tud_narrow.json").write_text(
        json.dumps(cfg))
    (root / "benchmark/traffic/ens_b1.json").write_text(json.dumps({
        "driver": "tud_members", "members_per_request": 1,
        "warmup_requests": 1, "check_requests": 1, "check_outputs": 2,
        "limits": {"tau_abs": 1e-4, "lu_of_peak": 1e-4,
                   "ld_of_peak": 1e-4}}))
    (root / "benchmark/metrics/member_count.py").write_text(
        "def read(run):\n    return run.members\n")
    # a metric with work counts of its own, read from the driver's state
    (root / "benchmark/metrics/traced_lines.py").write_text(
        "def work(cell, state, indices):\n"
        "    return {'lines_x_requests': len(state.cols['nu0'])"
        " * len(indices)}\n\n"
        "def read(run):\n"
        "    assert run.cell.traffic['driver'] == 'tud_members'\n"
        "    assert isinstance(run.memory_peak_bytes, int)\n"
        "    return run.work.get('lines_x_requests')\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "lwir_tud_narrow", "source": "test",
                            "file": "benchmark/configs/lwir_tud_narrow.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "narrow.b1", "config": "lwir_tud_narrow",
                              "traffic": "ens_b1", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("spectra_per_s",):
            m["workloads"].append("narrow.b1")
    spec["per_layer"].append({"name": "member_count", "unit": "members",
                              "better": "higher", "source": "host_clock",
                              "layer": "driver", "moves": "spectra_per_s",
                              "workloads": ["narrow.b1"]})
    spec["per_layer"].append({"name": "traced_lines", "unit": "lines",
                              "better": "higher", "source": "program_counter",
                              "layer": "driver", "moves": "spectra_per_s",
                              "workloads": ["narrow.b1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = registry.Cell(registry.benchmark_spec(str(root)), "narrow.b1",
                         str(root))
    assert cell.config_path.startswith(str(root))
    torch.set_num_threads(2)
    out = run_cell(cell, 2**31 + 11, 0.2, True, time.perf_counter(),
                   device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["member_count"]["value"] >= 1
    assert out["metrics"]["traced_lines"]["value"] >= 1
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def test_tiny_cells_share_the_registry():
    for w in SPEC["workloads"]:
        cell = tiny_cell(w["name"])
        assert cell.name == w["name"]
