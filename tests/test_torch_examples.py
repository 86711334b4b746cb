"""The port's examples (``examples/torch/``).

A fast check that no example imports JAX or ``radtxfr_tpu``; then each
example run as a child process with ``--device cpu`` (marked ``slow``, as
``tests/test_examples.py`` marks the JAX ones): it must exit 0 and print
``OK``.
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

from port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "torch", "*.py")))
NAMES = ["01_od_tud_quickstart.py", "02_production_tud_ensemble.py",
         "04_xs_lattice_serving.py", "05_derived_physics.py"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_examples_import_neither_jax_nor_the_jax_package():
    assert [os.path.basename(p) for p in EXAMPLES] == NAMES
    for path in EXAMPLES:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "radtxfr_tpu"), \
                f"{os.path.basename(path)} imports {mod}"


@pytest.mark.slow
@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(name, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                     "torch", name),
                        "--device", "cpu"], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"{name} failed:\n{r.stdout}\n{r.stderr}"
    assert r.stdout.rstrip().splitlines()[-1] == "OK"
    if name.startswith("02"):
        assert (tmp_path / "_demo_tud_ck").is_dir()
