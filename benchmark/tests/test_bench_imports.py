"""What a run and the reference import: no JAX, no JAX package (whole
top-level names: the port's name only begins with the package's), and a
reference that imports nothing of the program."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import pytest

from bench_tiny import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "radtxfr_tpu"}
#: the yardstick's modules: the reference, the input makers, the work
#: counts and the comparisons
YARDSTICK = (glob.glob(os.path.join(BENCH, "benchkit", "reference", "*.py"))
             + glob.glob(os.path.join(BENCH, "benchkit", "inputs", "*.py"))
             + [os.path.join(BENCH, "benchkit", n)
                for n in ("work.py", "checks.py", "lwir.py")])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(BENCH, "**", "*.py"), recursive=True)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path) if m}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("path", sorted(YARDSTICK))
def test_yardstick_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path) if m}
    assert "radtxfr_tpu_torch" not in tops, path


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        f"import sys; sys.path.insert(0, {BENCH!r})\n"
        "import benchkit.reference.lbl, benchkit.reference.continuum\n"
        "import benchkit.reference.radiative, benchkit.work, benchkit.checks\n"
        "import benchkit.inputs.derived_lines, benchkit.inputs.synthetic\n"
        "import benchkit.inputs.atmosphere, benchkit.inputs.line_mixing\n"
        "benchkit.reference.continuum.co2_table()")
    assert "radtxfr_tpu_torch" not in mods
    assert not mods & FORBIDDEN


def test_a_run_loads_no_jax_module():
    """A whole tiny run of each driver on the CPU, then sys.modules."""
    mods = _modules_after(
        f"import sys, time\n"
        f"sys.path.insert(0, {os.path.join(BENCH, 'tests')!r})\n"
        "import torch; torch.set_num_threads(2)\n"
        "from bench_tiny import tiny_cell\n"
        "from benchkit.harness import run_cell\n"
        "for w in ('absxs.lattice', 'absxs.serve'):\n"
        "    out = run_cell(tiny_cell(w), 3, 0.1, False, time.perf_counter(),"
        " device='cpu')\n"
        "    assert out['correct'], out\n")
    assert "radtxfr_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN
