"""HDF5 export with the reference's units-metadata convention (counterpart
of ``radtxfr_tpu/io/h5.py``: ``Var``, ``write_h5``).

Every dataset carries ``units`` / ``name`` / ``info`` / ``label`` string
attributes as the reference's drivers write them
(``Generate_LWIR_TUD.py:152-223``). ``h5py`` is imported only when a file
is written.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Var", "write_h5"]


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
                v = Var(np.asarray(v))
            d = f.create_dataset(k, data=np.asarray(v.data))
            for a in ("units", "name", "info", "label"):
                val = getattr(v, a)
                if val:
                    d.attrs[a] = val
        for k, v in (attrs or {}).items():
            f.attrs[k] = v
