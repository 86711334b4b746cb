"""The port covers ``radtxfr_tpu``'s whole public surface.

Every public name of JAX's ``utils.help.api_index()`` (the names each
subpackage exports) must be in the port's ``api_index()`` under the same
subpackage, its name mapped through the port's renames (the Pallas entry
points are the fused CUDA ones), and every module file of ``radtxfr_tpu``
must have a counterpart at the same relative path (renamed likewise).
``MISSING`` and ``MISSING_MODULES`` list what the port still lacks: both
are empty since the hapi surface (ROADMAP M14) was ported, and a name or
module that goes missing fails here.
"""

import glob
import os

from radtxfr_tpu.utils.help import api_index as jax_api_index

from radtxfr_tpu_torch.utils.help import api_index
from port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: JAX name -> the port's (``make_*_pallas_fn`` -> ``make_*_fn``,
#: ``pallas_ensemble`` -> ``fused_ensemble``)
RENAMES = {"make_tud_pallas_fn": "make_tud_fn",
           "tud_ensemble_pallas": "tud_ensemble_fused"}
MODULE_RENAMES = {"kernels/pallas_xsect.py": "kernels/fused_xsect.py",
                  "kernels/pallas_tud.py": "kernels/fused_tud.py",
                  "dist/pallas_ensemble.py": "dist/fused_ensemble.py"}

#: nothing of the JAX package's surface is missing from the port
MISSING = {}
MISSING_MODULES = []


def test_public_names_missing_from_the_port_are_the_hapi_surface():
    want, got = jax_api_index(), api_index()
    assert set(got) == set(want)
    missing = {sub: sorted(n for n in names
                           if RENAMES.get(n, n) not in got[sub])
               for sub, names in want.items()}
    assert {k: v for k, v in missing.items() if v} == \
        {k: sorted(v) for k, v in MISSING.items()}


def test_modules_missing_from_the_port_are_the_hapi_surface():
    jax_pkg = os.path.join(ROOT, "radtxfr_tpu")
    rels = sorted(os.path.relpath(p, jax_pkg) for p in
                  glob.glob(os.path.join(jax_pkg, "**", "*.py"),
                            recursive=True))
    absent = [r for r in rels if not os.path.exists(os.path.join(
        ROOT, "radtxfr_tpu_torch", MODULE_RENAMES.get(r, r)))]
    assert absent == sorted(MISSING_MODULES)
