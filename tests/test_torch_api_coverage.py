"""The port covers ``radtxfr_tpu``'s whole public surface.

Every public name of JAX's ``utils.help.api_index()`` (the names each
subpackage exports) must be in the port's ``api_index()`` under the same
subpackage, its name mapped through the port's renames (the Pallas entry
points are the fused CUDA ones), and every module file of ``radtxfr_tpu``
must have a counterpart at the same relative path (renamed likewise).
``MISSING`` and ``MISSING_MODULES`` list what the port still lacks: both
are empty since the hapi surface (ROADMAP M14) was ported, and a name or
module that goes missing fails here.

The signatures match too: for every public function and class of each
module pair (and each public method of the classes), the parameter names,
their order, which have defaults and the default values, but for the
documented conventions (``SIGNATURE_CONVENTIONS``), the port's trailing
extras (``PORT_EXTRAS``) and the Pallas-only names
(``NO_SIGNATURE_COUNTERPART``), each with its reason.
"""

import glob
import importlib
import inspect
import os

import numpy as np
import pytest
import torch

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


# ---------------------------------------------------------------------------
# signatures: parameter names, their order, which have defaults and the
# default values, for every public function and class (and the public
# methods of each class) of each module pair
# ---------------------------------------------------------------------------

#: JAX name -> the port's for signatures: ``RENAMES`` and the builders
#: (``make_*_pallas_fn`` -> ``make_*_fn``)
SIG_RENAMES = {**RENAMES, "make_od_pallas_fn": "make_od_fn",
               "make_xsect_pallas_fn": "make_xsect_fn",
               "make_ht_pallas_fn": "make_ht_fn",
               "make_od_ht_pallas_fn": "make_od_ht_fn",
               "make_od_pallas_local_fn": "make_od_local_fn"}

#: the port's documented departures from JAX's signatures, each a rule the
#: comparison applies, with its reason
SIGNATURE_CONVENTIONS = {
    "device": "the port's entry points take device= last (None: the card; "
              "nothing falls back to the CPU), where JAX places arrays on "
              "its default device",
    "dtype": "torch dtypes: a default of torch.float32 or float64 where "
             "JAX's is a jnp dtype or follows jax_enable_x64, and dtype= "
             "added at the end where JAX's output dtype follows that "
             "setting",
    "key": "random draws come from a torch.Generator (generator=) where "
           "JAX takes a PRNG key (key=)",
    "t_lanes/interpret": "Pallas's lane width and interpret mode: the CUDA "
                         "kernels have neither, and CPU tensors run each "
                         "kernel's plain version",
    "renames": "the builders and the fused entry points keep their roles "
               "under the port's names (SIG_RENAMES)",
}

#: the port's trailing extra parameters: (module, qualified name) ->
#: (parameter, reason)
PORT_EXTRAS = {
    ("atmos/continuum.py", "make_layered_mt_ckd"): (
        "tables", "the H2O tables to read, None: the installed ones (JAX "
                  "reads the installed ones only)"),
    ("atmos/continuum.py", "check_h2o_table_coverage"): (
        "tables", "the H2O tables to check, None: the installed ones"),
    ("kernels/ht_driver.py", "ht_params"): (
        "strength_scale", "the layered HT OD's column factor, applied "
                          "before the CUDA kernel reads the strengths"),
    ("kernels/profiles.py", "voigt"): (
        "n_weideman", "the Weideman series length, fixed at 24 in JAX's"),
    ("products/jacobian.py", "tud_with_jacobian"): (
        "reduce", "the banded resolution reduction applied per tangent "
                  "batch on the card, so only reduced products leave it"),
    ("lines/store.py", "LineStore"): (
        "host", "the float64 host columns static planning reads, kept "
                "beside the device tensors"),
    ("lines/store.py", "LineStore.subset"): (
        "require_sorted", "whether a subset must keep the centres sorted"),
}

#: JAX public names whose counterpart is not one callable of the same
#: role, with the reason
NO_SIGNATURE_COUNTERPART = {
    ("dist/mesh.py", "P"): "jax.sharding.PartitionSpec, re-exported; the "
                           "port's meshes take no partition specs",
    ("kernels/pallas_tud.py", "TudCfg"): "the Pallas K2 call's static "
                                         "configuration; the CUDA K2 takes "
                                         "its sizes as launch arguments",
    ("kernels/pallas_xsect.py", "xsect_pallas"): (
        "the Pallas call on a host plan and LineParams; its counterparts "
        "are the CUDA entry points xsect_fused and xsect_unfused on a "
        "DevicePlan's arrays"),
    ("kernels/pallas_xsect.py", "xsect_ht_pallas"): (
        "the Pallas HT call; its counterpart is fused_ht.xsect_ht on a "
        "DevicePlan's arrays"),
}

_EMPTY = inspect.Parameter.empty


def _module_name(pkg, rel):
    mod = rel[:-3].replace(os.sep, ".")
    mod = mod[:-len(".__init__")] if mod.endswith(".__init__") else (
        "" if mod == "__init__" else mod)
    return pkg + ("." + mod if mod else "")


def _public(mod):
    """The module's ``__all__`` and the public functions and classes it
    defines."""
    names = list(getattr(mod, "__all__", []))
    names += [n for n, v in vars(mod).items() if not n.startswith("_")
              and (inspect.isfunction(v) or inspect.isclass(v))
              and v.__module__ == mod.__name__ and n not in names]
    return [n for n in names if inspect.isfunction(getattr(mod, n, None))
            or inspect.isclass(getattr(mod, n, None))]


def _callables(name, obj):
    """(qualified name, callable) of ``obj`` and, for a class, of each
    public method it defines."""
    out = [(name, obj)]
    if inspect.isclass(obj):
        out += [(f"{name}.{m}", getattr(obj, m)) for m, v in vars(obj).items()
                if not m.startswith("_") and (callable(v) or isinstance(
                    v, (staticmethod, classmethod)))]
    return out


def _default_key(name, default, port):
    """What a default compares by: for the conventions, whether the port's
    ``dtype`` default is a dtype (or None); a function's name; NaN as one
    value."""
    if default is _EMPTY:
        return _EMPTY
    if name == "dtype":
        return "convention" if not port or default is None or isinstance(
            default, torch.dtype) or (isinstance(default, type) and issubclass(
                default, np.generic)) else ("not a dtype", default)
    if callable(default):
        return ("callable", default.__name__)
    if isinstance(default, float) and default != default:
        return "nan"
    return default


def _normalised(rel, qual, obj, port):
    """JAX's and the port's parameter lists, (name, default key), after the
    conventions. The port's ``device``, a ``dtype`` JAX lacks and its
    ``PORT_EXTRAS`` entry are dropped only from the end of its list (before
    a ``**kwargs``), so one placed before JAX's parameters, which would
    bind a positional argument wrongly, is a difference."""
    j = [(p.name, p.default) for p in inspect.signature(obj).parameters
         .values() if p.name not in ("t_lanes", "interpret")]
    j = [("generator" if n == "key" else n, d) for n, d in j]
    params = list(inspect.signature(port).parameters.values())
    tail = [q for q in params if q.kind is q.VAR_KEYWORD]
    p = [(q.name, q.default) for q in params if q not in tail]
    trailing = {"device"}
    if "dtype" not in {n for n, _ in j}:
        trailing.add("dtype")
    extra = PORT_EXTRAS.get((rel, qual))
    if extra is not None:
        trailing.add(extra[0])
    while p and p[-1][0] in trailing:
        trailing.discard(p.pop()[0])
    if extra is not None:
        assert extra[0] not in {n for n, _ in p}, (
            qual, "the extra is not at the end")
    p += [(q.name, q.default) for q in tail]
    return ([(n, _default_key(n, d, False)) for n, d in j],
            [(n, _default_key(n, d, True)) for n, d in p])


def _signature_pairs(rel):
    jax_mod = importlib.import_module(_module_name("radtxfr_tpu", rel))
    port_mod = importlib.import_module(_module_name(
        "radtxfr_tpu_torch", MODULE_RENAMES.get(rel, rel)))
    for name in _public(jax_mod):
        if (rel, name) in NO_SIGNATURE_COUNTERPART:
            continue
        port = getattr(port_mod, SIG_RENAMES.get(name, name), None)
        assert port is not None, f"{rel}: no counterpart of {name}"
        port_parts = dict(_callables(name, port))
        for qual, obj in _callables(name, getattr(jax_mod, name)):
            assert qual in port_parts, f"{rel}: no counterpart of {qual}"
            yield qual, obj, port_parts[qual]


JAX_MODULES = sorted(
    os.path.relpath(p, os.path.join(ROOT, "radtxfr_tpu"))
    for p in glob.glob(os.path.join(ROOT, "radtxfr_tpu", "**", "*.py"),
                       recursive=True))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_public_signatures_match_jax(rel):
    """Every public function and class of the JAX module (and each public
    method of its classes) and its counterpart take the same parameters in
    the same order with the same defaults, but for ``SIGNATURE_CONVENTIONS``
    and ``PORT_EXTRAS``."""
    diffs = {}
    for qual, obj, port in _signature_pairs(rel):
        j, p = _normalised(rel, qual, obj, port)
        if j != p:
            diffs[qual] = (j, p)
    assert not diffs, diffs


def test_signature_allow_lists_name_what_exists():
    """Each allow-list entry names a real module, name and parameter, and
    gives its reason."""
    for table in (PORT_EXTRAS, NO_SIGNATURE_COUNTERPART):
        for (rel, qual), why in table.items():
            assert rel in JAX_MODULES, rel
            mod = importlib.import_module(_module_name("radtxfr_tpu", rel))
            assert hasattr(mod, qual.split(".")[0]), (rel, qual)
            assert (why[1] if isinstance(why, tuple) else why).strip()
    for rel, qual in PORT_EXTRAS:
        port = importlib.import_module(_module_name(
            "radtxfr_tpu_torch", MODULE_RENAMES.get(rel, rel)))
        obj = port
        for part in qual.split("."):
            obj = getattr(obj, part)
        assert PORT_EXTRAS[(rel, qual)][0] in inspect.signature(
            obj).parameters
    assert all(v.strip() for v in SIGNATURE_CONVENTIONS.values())
