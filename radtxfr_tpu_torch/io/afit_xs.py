"""AFIT_XS absorption cross-section binary format, writer and reader
(counterpart of ``radtxfr_tpu/io/afit_xs.py``; NumPy only).

Layout (reference ``misc/RT_gen_AbsXS_files.py:45-83``):

* version tag: 2-byte string ('v1') padded by numpy '<S2'
* params: 6 x float64 — (X.min, X.max, X.size, molecule id, T [K], P [Pa])
* database name: 128-byte string ('<S128')
* payload: float64 cross-section values on the implied linspace axis.
"""

from __future__ import annotations

import numpy as np

from .. import as_numpy

__all__ = ["xs_write", "xs_read", "xs_default_filename"]


def xs_default_filename(mol_id: int, T: float, P_pa: float) -> str:
    """Reference naming: XS-ID-TTTTK-ppppppPa.bin (``:75``)."""
    return "XS-{0:02d}-{1:04d}K-{2:06d}Pa.bin".format(int(mol_id), int(T),
                                                     int(P_pa))


def xs_write(X, Y, T, P_pa, mol_id, db_name: str,
             fname: str | None = None) -> str:
    X = as_numpy(X, np.float64)
    Y = as_numpy(Y, np.float64)
    T, P_pa, mol_id = float(T), float(P_pa), float(mol_id)
    if fname is None:
        fname = xs_default_filename(mol_id, T, P_pa)
    with open(fname, "wb") as f:
        np.array("v1", "<S2").tofile(f)
        np.array([X.min(), X.max(), X.size, mol_id, T, P_pa], "<f8").tofile(f)
        np.array(db_name, "<S128").tofile(f)
        Y.astype("<f8").tofile(f)
    return fname


def xs_read(fname: str):
    """-> (X, Y, meta dict with T/P_pa/mol_id/db_name/version)."""
    with open(fname, "rb") as f:
        version = np.fromfile(f, "<S2", 1)[0].decode()
        params = np.fromfile(f, "<f8", 6)
        db_name = np.fromfile(f, "<S128", 1)[0].decode().rstrip("\x00")
        Y = np.fromfile(f, "<f8")
    x_min, x_max, n, mol_id, T, P_pa = params
    X = np.linspace(x_min, x_max, int(n))
    if Y.size != int(n):
        raise ValueError(f"payload size {Y.size} != header size {int(n)}")
    return X, Y, dict(version=version, T=float(T), P_pa=float(P_pa),
                      mol_id=int(mol_id), db_name=db_name)
