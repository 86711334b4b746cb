"""Interactive help, the hapi ``getHelp`` equivalent (counterpart of
``radtxfr_tpu/utils/help.py``).

``get_help()`` prints an index of the port's public API grouped by
subpackage; ``get_help(obj_or_name)`` prints the target's docstring (which
carries the physics, units and reference ``file:line`` citations that the
hapi tutorial, ``misc/hapi.py:4006-4986``, conveyed in prose).
"""

from __future__ import annotations

import importlib
import inspect
import pydoc

__all__ = ["get_help", "api_index"]

_SUBPACKAGES = (
    "core", "lines", "kernels", "atmos", "products",
    "sensor", "scene", "dist", "io", "utils",
)


def api_index() -> dict[str, list[str]]:
    """Public names re-exported by each ``radtxfr_tpu_torch``
    subpackage."""
    out = {}
    for sub in _SUBPACKAGES:
        mod = importlib.import_module(f"radtxfr_tpu_torch.{sub}")
        names = getattr(mod, "__all__", None)
        if names is None:
            names = [n for n in vars(mod) if not n.startswith("_")
                     and not inspect.ismodule(vars(mod)[n])]
        out[sub] = sorted(names)
    return out


def get_help(target=None, *, _print=print) -> None:
    """Print help for ``target`` (an object or a dotted/bare name).

    With no argument, prints the package API index. Bare names are resolved
    against every subpackage (first match wins), mirroring hapi's
    ``getHelp(profiles)`` call style; an unknown name raises
    ``ValueError``.
    """
    if target is None:
        _print("radtxfr_tpu_torch - the PyTorch/CUDA port of radtxfr_tpu, "
               "LWIR line-by-line radiative transfer.\nPublic API by "
               "subpackage (get_help(name) for any entry):\n")
        for sub, names in api_index().items():
            _print(f"  radtxfr_tpu_torch.{sub}:")
            for n in names:
                _print(f"    {n}")
        _print("\nGuides: README.md (the port's section), "
               "examples/torch/README.md.")
        return
    if isinstance(target, str):
        obj = (pydoc.locate(f"radtxfr_tpu_torch.{target}")
               or pydoc.locate(target))
        if obj is None:
            for sub in _SUBPACKAGES:
                obj = pydoc.locate(f"radtxfr_tpu_torch.{sub}.{target}")
                if obj is not None:
                    break
        if obj is None:
            raise ValueError(f"no such name in radtxfr_tpu_torch: {target!r}")
        target = obj
    doc = inspect.getdoc(target) or "(no docstring)"
    name = getattr(target, "__qualname__", getattr(target, "__name__", ""))
    mod = getattr(target, "__module__", "")
    try:
        sig = str(inspect.signature(target))
    except (TypeError, ValueError):
        sig = ""
    _print(f"{mod}.{name}{sig}\n\n{doc}")
