"""Minimal ENVI image I/O, header and raw binary cube (counterpart of
``radtxfr_tpu/io/envi.py``; host NumPy, the same bytes).

The reference reads HSI cubes through the ``spectral`` package
(``misc/working_with_HSI.py:1-10``), which is not available here; this is a
dependency-free reader/writer for the ENVI format subset those workflows
use: BSQ/BIL/BIP interleaves, basic dtypes, band names/wavelengths in the
``.hdr``.
"""

from __future__ import annotations

import os

import numpy as np

from .. import as_numpy as _host

__all__ = ["read_envi", "write_envi"]

_DTYPES = {
    1: np.uint8, 2: np.int16, 3: np.int32, 4: np.float32, 5: np.float64,
    12: np.uint16, 13: np.uint32, 14: np.int64, 15: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _parse_header(text: str) -> dict:
    if not text.lstrip().lower().startswith("envi"):
        raise ValueError("not an ENVI header")
    fields: dict = {}
    key, buf, in_brace = None, "", False
    for line in text.splitlines()[1:]:
        if in_brace:
            buf += " " + line.strip()
            if "}" in line:
                fields[key] = buf.rstrip("}").strip()
                in_brace = False
            continue
        if "=" not in line:
            continue
        key, val = (s.strip() for s in line.split("=", 1))
        key = key.lower()
        if val.startswith("{"):
            if "}" in val:
                fields[key] = val.strip("{}").strip()
            else:
                buf, in_brace = val.lstrip("{").strip(), True
        else:
            fields[key] = val
    return fields


def read_envi(hdr_path: str):
    """Read an ENVI cube -> (data (bands, rows, cols), header dict)."""
    with open(hdr_path) as f:
        h = _parse_header(f.read())
    rows = int(h["lines"])
    cols = int(h["samples"])
    bands = int(h["bands"])
    dtype = np.dtype(_DTYPES[int(h["data type"])])
    order = "<" if int(h.get("byte order", 0)) == 0 else ">"
    interleave = h.get("interleave", "bsq").lower()
    offset = int(h.get("header offset", 0))

    data_path = os.path.splitext(hdr_path)[0]
    for ext in ("", ".img", ".dat", ".bsq", ".bil", ".bip", ".raw"):
        if os.path.exists(data_path + ext) and not (data_path + ext).endswith(".hdr"):
            data_path = data_path + ext
            break
    raw = np.fromfile(data_path, dtype=dtype.newbyteorder(order), offset=offset)
    if interleave == "bsq":
        data = raw.reshape(bands, rows, cols)
    elif interleave == "bil":
        data = raw.reshape(rows, bands, cols).transpose(1, 0, 2)
    elif interleave == "bip":
        data = raw.reshape(rows, cols, bands).transpose(2, 0, 1)
    else:
        raise ValueError(f"unknown interleave {interleave!r}")
    if "wavelength" in h and isinstance(h["wavelength"], str):
        h["wavelength"] = np.array(
            [float(v) for v in h["wavelength"].split(",") if v.strip()]
        )
    return data, h


def write_envi(hdr_path: str, data, interleave: str = "bsq",
               wavelength=None, description: str = "radtxfr_tpu export",
               **extra) -> None:
    """Write (bands, rows, cols) as an ENVI cube + header (a tensor is
    copied to the host)."""
    data = _host(data)
    bands, rows, cols = data.shape
    interleave = interleave.lower()
    code = _DTYPE_CODES[np.dtype(data.dtype)]

    base = os.path.splitext(hdr_path)[0]
    if interleave == "bsq":
        payload = data
    elif interleave == "bil":
        payload = data.transpose(1, 0, 2)
    elif interleave == "bip":
        payload = data.transpose(1, 2, 0)
    else:
        raise ValueError(f"unknown interleave {interleave!r}")
    payload.astype(data.dtype.newbyteorder("<")).tofile(base + ".img")

    lines = [
        "ENVI",
        f"description = {{{description}}}",
        f"samples = {cols}",
        f"lines = {rows}",
        f"bands = {bands}",
        "header offset = 0",
        "file type = ENVI Standard",
        f"data type = {code}",
        f"interleave = {interleave}",
        "byte order = 0",
    ]
    if wavelength is not None:
        wl = ", ".join(f"{w:.6f}" for w in _host(wavelength).ravel())
        lines.append(f"wavelength = {{{wl}}}")
    for k, v in extra.items():
        lines.append(f"{k} = {v}")
    with open(hdr_path, "w") as f:
        f.write("\n".join(lines) + "\n")
