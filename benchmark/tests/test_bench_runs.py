"""Whole runs of each cell on the CPU at a tiny size: the result line's
keys, a sound run correct, and each fault a cell can have (an answer
altered where it is produced; half of the batch left out, the mean taken
over the rest) and the lower-precision control caught; the command's
refusals."""

from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest
import torch

from bench_tiny import BENCH, ROOT, tiny_cell
from benchkit.harness import Record, choose, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(name, trace=False, **kw):
    torch.set_num_threads(2)
    return run_cell(tiny_cell(name), 2**31 + 5, 0.1, trace,
                    time.perf_counter(), device="cpu", **kw)


@pytest.mark.parametrize("name", ["absxs.lattice", "absxs.serve",
                                  "tud_prod.ens_b4", "tud_prod.jac_b8"])
def test_sound_run_is_correct_with_the_contract_keys(name):
    out = _run(name)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name_, c in out["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert {"setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("name", ["absxs.lattice", "absxs.serve",
                                  "tud_prod.jac_b8"])
def test_traced_run_has_breakdown_and_window(name):
    out = _run(name, trace=True)
    assert out["correct"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "plan_build_s" in out["metrics"]


@pytest.mark.parametrize("name,fault", [
    ("absxs.lattice", "answer"), ("absxs.lattice", "half_batch"),
    ("absxs.serve", "answer"), ("tud_prod.ens_b4", "answer"),
    ("tud_prod.ens_b4", "half_batch"), ("tud_prod.jac_b8", "answer"),
    ("tud_prod.jac_b8", "half_batch")])
def test_fault_is_caught(name, fault):
    assert not _run(name, fault=fault)["correct"]


@pytest.mark.parametrize("name", ["absxs.lattice", "absxs.serve",
                                  "tud_prod.ens_b4", "tud_prod.jac_b8"])
def test_bfloat16_control_is_caught(name):
    assert not _run(name, control=torch.bfloat16)["correct"]


def test_check_draws_from_each_group():
    """The lattice's requests alternate molecules: every run checks each."""
    recs = {i: Record(units=1, group=("H2O", "CO2")[i % 2])
            for i in range(10)}
    for seed in range(20):
        picked = choose(recs, 2**31 + seed, 1)
        assert sorted(recs[i].group for i in picked) == ["CO2", "H2O"]
    assert len(choose({i: Record(units=1) for i in range(10)}, 3, 4)) == 4


def _cmd(args, cwd=ROOT):
    return subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                           *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_command_refuses_without_a_card():
    out = _cmd(["--workload", "absxs.serve", "--seed", "1", "--seconds",
                "1", "--trace", "0"])
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_refuses_an_unknown_cell():
    out = _cmd(["--workload", "no.such", "--seed", "1", "--seconds", "1",
                "--trace", "0"])
    assert out.returncode != 0 and out.stdout.strip() == ""
