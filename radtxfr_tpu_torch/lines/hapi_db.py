"""Reader and writer of hapi's directory-as-database table format
(counterpart of ``radtxfr_tpu/lines/hapi_db.py``).

Users of the reference hold line data as hapi ``.data``/``.header`` table
pairs (fixed-column text rows + JSON header with ``order``/``format``
metadata — written by ``cache2storage``, parsed by ``storage2cache``,
``misc/hapi.py:1595-1672``). This module loads those tables into
:class:`~.store.LineStore` columns on a device (the card unless asked
otherwise; float64, hapi's type, unless asked otherwise), discovers tables
and raw ``.par`` files (cf. ``scanForNewParfiles``, ``misc/hapi.py:1689``)
in a database directory, and writes tables and ``.par`` files from the
store's float64 host columns: the same bytes as the JAX package writes, and
each package reads the other's files.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from .store import LineStore, from_arrays, parse_par
from .tips import iso_row_index

__all__ = [
    "parse_format", "load_table_columns", "load_table", "save_table",
    "write_par", "HapiDatabase",
]

_FMT_RE = re.compile(r"^%(\d*)(?:\.(\d*))?([edfsEDFS])$")

#: columns LineStore consumes, in hapi naming
_STORE_COLS = {
    "nu": "nu0", "sw": "sw", "elower": "elower", "gamma_air": "gamma_air",
    "gamma_self": "gamma_self", "n_air": "n_air", "delta_air": "delta_air",
}


def parse_format(fmt: str):
    """'%12.6f' -> (width, converter)."""
    m = _FMT_RE.match(fmt.strip())
    if not m:
        raise ValueError(f"unsupported column format {fmt!r}")
    width = int(m.group(1) or 0)
    kind = m.group(3).lower()
    if kind == "d":
        conv = lambda s: int(s) if s.strip() else 0
    elif kind in ("e", "f"):
        conv = lambda s: float(s) if s.strip() else 0.0
    else:
        conv = lambda s: s.strip()
    return width, conv


def load_table_columns(data_path: str, header_path: str | None = None) -> dict:
    """Parse one hapi table -> {column_name: np.ndarray/list}."""
    if header_path is None:
        header_path = os.path.splitext(data_path)[0] + ".header"
    with open(header_path) as f:
        header = json.load(f)
    order = header["order"]
    fmts = [parse_format(header["format"][name]) for name in order]

    cols = {name: [] for name in order}
    with open(data_path) as f:
        for line in f:
            line = line.rstrip("\n")
            pos = 0
            row = {}
            ok = True
            for name, (width, conv) in zip(order, fmts):
                piece = line[pos:pos + width]
                try:
                    row[name] = conv(piece)
                except ValueError:
                    ok = False
                    break
                pos += width
            if ok and pos <= len(line) + 1:
                for name in order:
                    cols[name].append(row[name])
    out = {}
    for name in order:
        vals = cols[name]
        if vals and isinstance(vals[0], (int, float)):
            out[name] = np.asarray(vals)
        else:
            out[name] = vals
    return out


def load_table(data_path: str, header_path: str | None = None,
               dtype=None, device=None) -> LineStore:
    """Parse one hapi table into a :class:`LineStore` on ``device`` (None:
    the card) in ``dtype`` (None: float64, hapi's)."""
    cols = load_table_columns(data_path, header_path)
    missing = [k for k in ("nu", "sw", "molec_id", "local_iso_id") if k not in cols]
    if missing:
        raise ValueError(f"table lacks required columns: {missing}")
    n = len(cols["nu"])
    get = lambda k: cols.get(k, np.zeros(n))
    return from_arrays(
        nu0=cols["nu"], sw=cols["sw"], elower=get("elower"),
        gamma_air=get("gamma_air"), gamma_self=get("gamma_self"),
        n_air=get("n_air"), delta_air=get("delta_air"),
        mol_id=np.asarray(cols["molec_id"], dtype=np.int32),
        local_iso_id=np.asarray(cols["local_iso_id"], dtype=np.int32),
        sd_air=get("SD_air"),
        device=device, dtype=dtype or torch.float64,
    )


def _store_rows(store: LineStore):
    """LineStore -> per-line hapi-named numeric columns (its host
    columns)."""
    rev = {r: (m, i) for (m, i), r in iso_row_index().items()}
    h = store.host
    local_iso = np.array([rev[int(r)][1] for r in h["iso_row"]],
                         dtype=np.int64)
    return {
        "molec_id": np.asarray(h["mol_id"], dtype=np.int64),
        "local_iso_id": local_iso,
        "nu": h["nu0"],
        "sw": h["sw"],
        "elower": h["elower"],
        "gamma_air": h["gamma_air"],
        "gamma_self": h["gamma_self"],
        "n_air": h["n_air"],
        "delta_air": h["delta_air"],
    }


#: hapi standard column formats (PARAMETER_META, misc/hapi.py:583ff)
_SAVE_FORMATS = {
    "molec_id": "%2d", "local_iso_id": "%1d", "nu": "%12.6f", "sw": "%10.3E",
    "elower": "%10.4f", "gamma_air": "%6.4f", "gamma_self": "%6.4f",
    "n_air": "%7.4f", "delta_air": "%9.6f",
}


def save_table(store: LineStore, directory: str, name: str) -> str:
    """Write a LineStore back out as a hapi ``.data``/``.header`` table pair.

    The inverse of :func:`load_table` — hapi's ``cache2storage``
    (``misc/hapi.py:1595``, called from ``db_commit`` ``:5223``): fixed-column
    text rows plus a JSON header carrying ``order``/``format`` metadata, so
    the written table round-trips through hapi itself.
    """
    rows = _store_rows(store)
    order = list(_SAVE_FORMATS)
    data_path = os.path.join(directory, name + ".data")
    header_path = os.path.join(directory, name + ".header")
    n = store.n_lines
    with open(data_path, "w") as f:
        for k in range(n):
            f.write("".join(_SAVE_FORMATS[c] % rows[c][k] for c in order) + "\n")
    header = {
        "table_name": name,
        "number_of_rows": n,
        "order": order,
        "format": dict(_SAVE_FORMATS),
        "default": {c: 0 for c in order},
        "table_type": "column-fixed",
        "size_in_bytes": os.path.getsize(data_path),
    }
    with open(header_path, "w") as f:
        json.dump(header, f, indent=2)
    return data_path


def write_par(store: LineStore, path: str) -> str:
    """Export a LineStore as 160-char HITRAN ``.par`` records.

    Interop writer (new — the reference only reads ``.par``): fills the
    fields the store holds at their standard HITRAN2004 columns (cf.
    ``_PAR_FIELDS`` in :mod:`.store`) and blanks the rest, so the file
    re-parses with :func:`~.store.parse_par` and with hapi.
    """
    rows = _store_rows(store)

    def ffmt(v, width, decimals):
        """Fortran-style Fw.d: drops the leading zero of |v|<1 if the field
        would otherwise overflow (HITRAN prints .0678, -.001234)."""
        s = f"{v:{width}.{decimals}f}"
        if len(s) > width:
            # drop ONLY a leading zero ("0.0678" -> ".0678"); an interior
            # "0." (e.g. "10000.12") must not be touched — that silently
            # rescales the value by 10x
            t = s.lstrip()
            if t.startswith("0."):
                s = t[1:].rjust(width)
            elif t.startswith("-0."):
                s = ("-" + t[2:]).rjust(width)
        if len(s) > width:
            raise ValueError(f"value {v!r} does not fit F{width}.{decimals}")
        return s

    with open(path, "w") as f:
        for k in range(store.n_lines):
            rec = [" "] * 160

            def put(start, text):
                rec[start:start + len(text)] = text

            put(0, "%2d" % rows["molec_id"][k])
            put(2, "%1d" % rows["local_iso_id"][k])
            put(3, ffmt(rows["nu"][k], 12, 6))
            put(15, "%10.3E" % rows["sw"][k])
            put(25, "%10.3E" % 0.0)  # Einstein A: not stored
            put(35, ffmt(rows["gamma_air"][k], 5, 4))
            put(40, ffmt(rows["gamma_self"][k], 5, 3))
            put(45, ffmt(rows["elower"][k], 10, 4))
            put(55, ffmt(rows["n_air"][k], 4, 2))
            put(59, ffmt(rows["delta_air"][k], 8, 6))
            f.write("".join(rec) + "\n")
    return path


class HapiDatabase:
    """A directory of hapi tables / .par files (hapi ``db_begin`` analog);
    tables load onto ``device`` (None: the card)."""

    def __init__(self, directory: str, device=None):
        self.directory = directory
        self.device = device
        self._tables: dict[str, LineStore] = {}

    def table_names(self) -> list[str]:
        names = set()
        for fn in os.listdir(self.directory):
            base, ext = os.path.splitext(fn)
            if ext in (".data", ".par"):
                names.add(base)
        return sorted(names)

    def load(self, name: str, dtype=None, device=None) -> LineStore:
        """The table ``name`` (a ``.data`` table, else a ``.par`` file) on
        ``device`` (None: the database's) in ``dtype`` (None: float64),
        loaded once."""
        if name not in self._tables:
            data = os.path.join(self.directory, name + ".data")
            par = os.path.join(self.directory, name + ".par")
            device = self.device if device is None else device
            if os.path.exists(data):
                self._tables[name] = load_table(data, dtype=dtype,
                                                device=device)
            elif os.path.exists(par):
                self._tables[name] = parse_par(
                    par, device=device, dtype=dtype or torch.float64)
            else:
                raise FileNotFoundError(f"no table {name!r} in {self.directory}")
        return self._tables[name]

    def commit(self, name: str, store: LineStore | None = None) -> str:
        """Persist a table to the directory (hapi ``db_commit``,
        ``misc/hapi.py:5223``). With ``store`` given, registers it under
        ``name`` first."""
        if store is not None:
            self._tables[name] = store
        if name not in self._tables:
            raise KeyError(f"no loaded table {name!r} to commit")
        return save_table(self._tables[name], self.directory, name)

    def describe(self, name: str) -> dict:
        store = self.load(name)
        nu = store.host["nu0"]
        return {
            "name": name,
            "number_of_rows": store.n_lines,
            "nu_range": (float(nu.min()), float(nu.max())) if nu.size else None,
            "molecules": sorted(set(store.host["mol_id"].tolist())),
        }
