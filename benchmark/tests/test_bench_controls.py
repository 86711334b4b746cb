"""The controls of ``correct``, at each cell's own size on the card: the
plain reference in the nearest precision below the configuration's
(bfloat16 for float32) put in the program's place, or, where the program
has such a path of its own, the program with it on (the table lookup's
product in TF32). Each has to come out not correct. The benchmark's own
runs never run these.

    python -m pytest benchmark/tests/test_bench_controls.py -m cuda -s
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from bench_tiny import ROOT
from benchkit import registry
from benchkit.harness import run_cell

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
CONTROLS = [("tud_prod.ens_b4", torch.bfloat16),
            ("absxs.lattice", torch.bfloat16),
            ("absxs.serve", "program"),
            ("tud_prod.jac_b8", torch.bfloat16)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the controls run at the cells' "
                    "own sizes")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,control", CONTROLS)
def test_control_is_not_correct(card, name, control, seed):
    cell = registry.Cell(registry.benchmark_spec(ROOT), name, ROOT)
    out = run_cell(cell, seed, 3.0, False, time.perf_counter(),
                   device=card, control=control)
    print("control", json.dumps({"cell": name, "seed": seed,
                                 "control": str(control),
                                 "checks": out["checks"]}))
    assert not out["correct"]
