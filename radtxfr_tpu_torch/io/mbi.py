"""AFIT MBI multiband binary format (BIP/BSQ), writer and reader
(counterpart of ``radtxfr_tpu/io/mbi.py``; host NumPy, the same bytes).

Binary layout (reference ``AFIT_MBI.py:45-157``):

* dims: 3 x uint32 (rows, cols, bands — storage order, bands last)
* dtype string: 6 bytes ('double'/'single'/...)
* interleave: 3 bytes ('bip'/'bsq')
* offsetBytes: uint32 — total header size (descriptor + rcb + metadata)
* Rows/Columns/Bands axis values: float64
* metadata: a MATLAB v5 ``savemat`` blob holding a ``Header`` struct
* data: band-sequential or band-interleaved-by-pixel float payload,
  little-endian enforced.

The reference ships only the writer; the reader here is new (round-trip
tested), so the format is usable without MATLAB.
"""

from __future__ import annotations

import io as _io
import os
import sys

import numpy as np

from .. import as_numpy as _host

__all__ = ["mbi_export", "mbi_read"]

_DTYPE_TO_STR = {"float64": "double", "float32": "single"}
_STR_TO_DTYPE = {"double": np.float64, "single": np.float32,
                 "int16": np.int16, "int32": np.int32, "uint8": np.uint8}
_DESCRIPTOR_BYTES = 12 + 6 + 3 + 4


def _dtype_str(data: np.ndarray) -> str:
    s = _DTYPE_TO_STR.get(str(data.dtype), str(data.dtype))
    if len(s) > 6:
        # the descriptor field is a FIXED 6 bytes; a longer name would
        # shift every subsequent offset and corrupt the file silently
        raise ValueError(
            f"dtype {data.dtype} is not MBI-exportable (supported: "
            f"{sorted(_DTYPE_TO_STR)}); cast the array first")
    return "{0:<6}".format(s)


def _matlab_blob(header: dict) -> bytes:
    import scipy.io as sio

    buf = _io.BytesIO()
    sio.savemat(buf, {"Header": header if header else {"MetaData": "None"}})
    return buf.getvalue()


def _yaml_safe(v):
    """Recursively coerce header values to YAML-representable builtins."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {str(k): _yaml_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_yaml_safe(x) for x in v]
    return v


def mbi_export(fname: str, data, rows=None, cols=None, bands=None,
               bands_first_dim: bool = True, sidecar: bool = False,
               **header) -> None:
    """Write a (nB, nR, nC) array (or (nR, nC, nB) with
    ``bands_first_dim=False``) as '.bip' or '.bsq' by file extension.

    ``sidecar=True`` also writes the header metadata (plus the dims/dtype/
    interleave descriptor) as a YAML file with the same basename and a
    ``.yaml`` extension — the format contract documented by the reference
    (``AFIT_MBI.py:45,74-76``, parameter ``Sidecar``). Note the reference
    *documents* the sidecar but never writes it (no yaml import or write
    exists in ``AFIT_MBI.py``); here it is implemented, default off to
    match the reference's effective behavior. Tensors are copied to the
    host.
    """
    data = _host(data)
    if bands_first_dim:
        data = data.transpose(1, 2, 0).copy(order="C")
    n_r, n_c, n_b = data.shape
    rows = np.arange(n_r) if rows is None else _host(rows)
    cols = np.arange(n_c) if cols is None else _host(cols)
    bands = np.arange(n_b) if bands is None else _host(bands)
    interleave = os.path.splitext(fname)[1][1:].lower()
    if interleave not in ("bip", "bsq"):
        raise ValueError("fname extension must be .bip or .bsq")

    rcb = np.concatenate([rows, cols, bands]).astype("<f8")
    blob = _matlab_blob(header)
    offset = _DESCRIPTOR_BYTES + len(blob) + rcb.nbytes

    if data.dtype.byteorder == ">" or (data.dtype.byteorder == "=" and
                                       sys.byteorder == "big"):
        data = data.byteswap()

    with open(fname, "wb") as f:
        np.array(data.shape, dtype="<u4").tofile(f)
        f.write(_dtype_str(data).encode())
        f.write(interleave.encode())
        np.array(offset, dtype="<u4").tofile(f)
        rcb.tofile(f)
        f.write(blob)
        if interleave == "bsq":
            for b in range(n_b):
                data[:, :, b].copy(order="C").tofile(f)
        else:  # bip: all bands per pixel, pixel-major
            data.transpose(2, 0, 1).reshape(n_b, -1).T.copy(order="C").tofile(f)

    if sidecar:
        import yaml

        doc = {
            "file": os.path.basename(fname),
            "shape": {"rows": int(n_r), "cols": int(n_c), "bands": int(n_b)},
            "dtype": _dtype_str(data).strip(),
            "interleave": interleave,
            "offset_bytes": int(offset),
            "Header": _yaml_safe(header) if header else None,
        }
        with open(os.path.splitext(fname)[0] + ".yaml", "w") as f:
            yaml.safe_dump(doc, f, sort_keys=False)


def mbi_read(fname: str):
    """Read an AFIT MBI file -> (data (nB, nR, nC), rows, cols, bands, header)."""
    import scipy.io as sio

    with open(fname, "rb") as f:
        dims = np.fromfile(f, "<u4", 3)
        n_r, n_c, n_b = (int(x) for x in dims)
        dtype = _STR_TO_DTYPE[f.read(6).decode().strip()]
        interleave = f.read(3).decode()
        offset = int(np.fromfile(f, "<u4", 1)[0])
        rcb = np.fromfile(f, "<f8", n_r + n_c + n_b)
        rows, cols, bands = (rcb[:n_r], rcb[n_r:n_r + n_c], rcb[n_r + n_c:])
        blob_len = offset - _DESCRIPTOR_BYTES - rcb.nbytes
        blob = f.read(blob_len)
        payload = np.fromfile(f, np.dtype(dtype).newbyteorder("<"))

    header = sio.loadmat(_io.BytesIO(blob))["Header"]
    if interleave == "bsq":
        data = payload.reshape(n_b, n_r, n_c)
    else:
        data = payload.reshape(n_r * n_c, n_b).T.reshape(n_b, n_r, n_c)
    return data, rows, cols, bands, header
