"""What of ``radtxfr_tpu``'s public surface the port still lacks.

Every public name of JAX's ``utils.help.api_index()`` (the names each
subpackage exports) must be in the port's ``api_index()`` under the same
subpackage, its name mapped through the port's renames (the Pallas entry
points are the fused CUDA ones), except exactly the names listed in
``MISSING``; and every module file of ``radtxfr_tpu`` must have a
counterpart at the same relative path (renamed likewise), except exactly
``MISSING_MODULES``. Both lists are the hapi surface (ROADMAP M14): a
slice that ports part of it shrinks them, and a name that goes missing
elsewhere fails here.
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

#: the hapi surface, not ported yet (ROADMAP M14)
MISSING = {
    # lines/synthetic.py
    "lines": ["to_hapi_cache",
              # lines/query.py
              "select", "sort", "evaluate", "filter_mask", "group",
              "extract_columns", "stick_xy",
              # lines/hapi_db.py
              "HapiDatabase", "load_table", "save_table", "write_par"],
    # kernels/spectra.py
    "kernels": ["absorption_spectrum", "transmittance_spectrum",
                "radiance_spectrum", "convolve_spectrum"],
}
MISSING_MODULES = ["compat.py", "hapi_compat.py", "kernels/spectra.py",
                   "lines/fetch.py", "lines/hapi_db.py", "lines/query.py"]


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
