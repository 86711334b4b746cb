"""HDF5 export with the reference's units-metadata convention (counterpart
of ``radtxfr_tpu/io/h5.py``).

Every dataset carries ``units`` / ``name`` / ``info`` / ``label`` string
attributes as the reference's drivers write them
(``Generate_LWIR_TUD.py:152-223``). ``h5py`` is imported only when a file
is read or written. :func:`gen_indices` is the reference's
train/test/validation split (``Compute_LWIR_Apparent_Radiance.py:99-109``),
NumPy's ``default_rng``, so its indices equal the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import as_numpy

__all__ = ["Var", "write_h5", "read_h5", "gen_indices"]


@dataclasses.dataclass(frozen=True)
class Var:
    """One dataset plus its metadata attributes."""

    data: np.ndarray
    units: str = ""
    name: str = ""
    info: str = ""
    label: str = ""  # LaTeX-formatted plot label


def write_h5(fname: str, variables: dict, attrs: dict | None = None) -> None:
    """Write ``{dataset_name: Var | array}`` with metadata attributes."""
    import h5py

    with h5py.File(fname, "w") as f:
        for k, v in variables.items():
            if not isinstance(v, Var):
                v = Var(as_numpy(v))
            d = f.create_dataset(k, data=as_numpy(v.data))
            for a in ("units", "name", "info", "label"):
                val = getattr(v, a)
                if val:
                    d.attrs[a] = val
        for k, v in (attrs or {}).items():
            f.attrs[k] = v


def read_h5(fname: str) -> dict:
    """Read back into ``{name: Var}`` (attributes preserved)."""
    import h5py

    out = {}
    with h5py.File(fname, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = Var(
                    data=obj[...],
                    units=str(obj.attrs.get("units", "")),
                    name=str(obj.attrs.get("name", "")),
                    info=str(obj.attrs.get("info", "")),
                    label=str(obj.attrs.get("label", "")),
                )
        f.visititems(visit)
    return out


def gen_indices(n_samples: int, seed: int = 42,
                f_train: float = 0.75, f_test: float = 0.125):
    """Random 75 / 12.5 / 12.5 train/test/validation split of
    ``range(n_samples)`` (``Compute_LWIR_Apparent_Radiance.py:99-109``)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_samples)
    n_train = int(np.round(f_train * n_samples))
    n_test = int(np.round(f_test * n_samples))
    return (perm[:n_train],
            perm[n_train:n_train + n_test],
            perm[n_train + n_test:])
