"""hapi-named drop-in API (counterpart of ``radtxfr_tpu/hapi_compat.py``,
the reference's ``misc/hapi.py`` surface).

A user of HITRAN's hapi can ``import radtxfr_tpu_torch.hapi_compat as
hapi`` and keep the same program: the database verbs
(``db_begin``/``fetch``/``select``/``tableList``…), the isotopologue
registry accessors, TIPS partition sums, the PROFILE_*/CPF families, the
five ``absorptionCoefficient_*`` drivers, spectra synthesis and the slit
convolutions carry hapi's names, argument conventions, defaults and return
shapes, computed by the port's reference engine in PyTorch.

Devices and return types:

* ``db_begin(dir, device=None)`` loads the tables onto ``device``, the card
  unless asked otherwise (``device="cpu"``); without a card a default call
  raises, and nothing falls back to the CPU. Tables are float64, hapi's
  type.
* The work is computed on the device of the table (the drivers) or of the
  tensor inputs (spectra, convolutions, profiles, CPFs); inputs that are
  not tensors go to the database's device once ``db_begin`` named one,
  else to the card.
* What hapi users hold comes back: every function whose JAX counterpart
  returns a NumPy or a JAX array returns a host NumPy array (the drivers,
  the spectra, the convolutions, ``PROFILE_*``, the CPFs); the tables
  themselves are :class:`~.lines.store.LineStore` objects, as there.
* The drivers run the reference engine (:mod:`.kernels.xsect` and
  :mod:`.kernels.ht_driver`), not the CUDA kernels, and accumulate in
  float64. Their intensity threshold and partition sums are computed on
  the host in float64 whatever the table's device, so a line is kept or
  cut alike on the card and on the CPU.

Deliberate divergences from hapi (all documented per function, as in the
JAX module):

* Tables are packed :class:`~.lines.store.LineStore` columns, not per-row
  dicts; row-object internals (``getRowObject`` etc.) have no equivalent.
* ``EnvDependences`` / custom ``partitionFunction`` are honoured by ALL
  drivers (per-line callbacks evaluated on the host, exactly hapi's loop
  semantics incl. the post-override intensity threshold and the HT
  driver's override-key quirks); the Doppler driver ignores
  ``EnvDependences`` as hapi's own does (``misc/hapi.py:11384-11581``).
* ``fetch`` needs network access and is gated as :mod:`.lines.fetch`.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from . import DATA_DIR, as_numpy, as_tensor_on, resolve_device
from .core.constants import T_REF
from .kernels import faddeeva as _fad
from .kernels import htp as _htp
from .kernels import profiles as _prof
from .kernels import spectra as _spec
from .kernels.ht_driver import ht_xsect_from_params
from .kernels.ht_driver import xsect_ht as _xsect_ht
from .kernels.lineparams import LineParams
from .kernels.lineparams import compute_line_params as _line_params
from .kernels.xsect import xsect_from_params as _xsect
from .lines import fetch as _fetch
from .lines import hapi_db as _db
from .lines import query as _query
from .lines import tips as _tips
from .lines.store import IsoTables, LineStore, from_arrays

__all__ = [
    # DB / tables
    "db_begin", "db_commit", "tableList", "describeTable", "dropTable",
    "select", "sort", "group", "getColumn", "getColumns", "extractColumns",
    "fetch", "fetch_by_ids", "getStickXY",
    # table editing (misc/hapi.py:1710-2960; stubs-in-hapi implemented here)
    "createTable", "insertRow", "deleteRows", "arrangeTable",
    "addColumn", "deleteColumn", "deleteColumns", "renameColumn",
    "splitColumn", "saveCache", "loadCache", "databaseBegin",
    "databaseCommit",
    # registry
    "ISO", "ISO_ID", "abundance", "molecularMass", "moleculeName",
    "isotopologueName", "print_iso", "print_iso_id",
    # partition sums
    "partitionSum", "PYTIPS",
    # profiles / CPF
    "PROFILE_HT", "PROFILE_HTP", "PROFILE_SDRAUTIAN", "PROFILE_RAUTIAN",
    "PROFILE_SDVOIGT", "PROFILE_VOIGT", "PROFILE_LORENTZ", "PROFILE_DOPPLER",
    "cpf", "cpf3", "hum1_wei", "cef",
    # environment dependences
    "EnvironmentDependency_Intensity", "EnvironmentDependency_GammaD",
    "EnvironmentDependency_Gamma0", "EnvironmentDependency_Gamma2",
    "EnvironmentDependency_Delta0", "EnvironmentDependency_Delta2",
    "EnvironmentDependency_anuVC", "volumeConcentration",
    # absorption drivers
    "absorptionCoefficient_Voigt", "absorptionCoefficient_SDVoigt",
    "absorptionCoefficient_Lorentz", "absorptionCoefficient_Doppler",
    "absorptionCoefficient_HT",
    # spectra + instrument functions
    "transmittanceSpectrum", "absorptionSpectrum", "radianceSpectrum",
    "SLIT_RECTANGULAR", "SLIT_TRIANGULAR", "SLIT_GAUSSIAN",
    "SLIT_DISPERSION", "SLIT_COSINUS", "SLIT_DIFFRACTION", "SLIT_MICHELSON",
    "convolveSpectrum", "convolveSpectrumSame", "convolveSpectrumFull",
    # legacy shortcuts / readers (misc/hapi.py:11555-11734)
    "absorptionCoefficient_Gauss", "abscoef_HT", "abscoef_Voigt",
    "abscoef_Lorentz", "abscoef_Doppler", "abscoef_Gauss", "abscoef",
    "read_hotw", "read_xsect",
    # misc
    "arange_", "save_to_file", "getHelp",
    # table aliases / verbs / internals (documented hapi surface)
    "getTableList", "describe", "length", "filter", "selectInto",
    "AtoB", "BD_TIPS_2011_PYTHON", "pcqsdhc",
    "print_profiles", "print_slit_functions", "print_data_tutorial",
    "print_spectra_tutorial", "print_plotting_tutorial",
    "print_python_tutorial",
]

_K_BOLTS_CGS = 1.380648813e-16  # hapi cBolts (misc/hapi.py:84)


# ===========================================================================
# Local table registry (hapi LOCAL_TABLE_CACHE, misc/hapi.py:5205-5243)
# ===========================================================================

#: name -> LineStore (the in-memory database)
_TABLES: dict[str, LineStore] = {}
#: name -> extra non-.par columns (HT columns etc.), host arrays
_EXTRAS: dict[str, dict] = {}
_DB_DIR: str | None = None
#: the device ``db_begin`` loaded the tables onto (None before it ran)
_DEVICE: torch.device | None = None


def _work_device(*args) -> torch.device:
    """The device to compute on: the first tensor argument's, else the
    database's (``db_begin``), else the card."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(_DEVICE)


def _on(dev, a):
    """``a`` as a tensor on ``dev``: a tensor keeps its dtype, a Python
    number stays a number, anything else goes through ``np.asarray``
    (float64 for lists of floats)."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    if isinstance(a, (int, float, complex)):
        return a
    return as_tensor_on(np.asarray(a), dev)


def db_begin(db: str | None = None, device=None) -> None:
    """Open a directory-as-database and load every table onto ``device``
    (None: the card) in float64 (hapi ``db_begin``, ``misc/hapi.py:5205``;
    also scans ``.par`` files like ``scanForNewParfiles`` ``:1689``)."""
    global _DB_DIR, _DEVICE
    _DEVICE = resolve_device(device)
    _DB_DIR = db or "."
    os.makedirs(_DB_DIR, exist_ok=True)
    hdb = _db.HapiDatabase(_DB_DIR, device=_DEVICE)
    for name in hdb.table_names():
        data = os.path.join(_DB_DIR, name + ".data")
        if os.path.exists(data):
            cols = _db.load_table_columns(data)
            core = {"nu", "sw", "elower", "gamma_air", "gamma_self", "n_air",
                    "delta_air", "molec_id", "local_iso_id", "SD_air"}
            # LineStore rows are nu-sorted (from_arrays); keep the extra
            # columns aligned with them.
            order = np.argsort(np.asarray(cols["nu"], dtype=np.float64),
                               kind="stable")
            _EXTRAS[name] = {k: np.asarray(v)[order] for k, v in cols.items()
                             if k not in core and np.asarray(v).dtype != object}
        _TABLES[name] = hdb.load(name)


def db_commit() -> None:
    """Write every in-memory table back to the database directory
    (hapi ``db_commit``, ``misc/hapi.py:5223``)."""
    if _DB_DIR is None:
        raise RuntimeError("no database opened; call db_begin(dir) first")
    for name, store in _TABLES.items():
        _db.save_table(store, _DB_DIR, name)


def tableList() -> list[str]:
    """Names of all loaded tables (hapi ``tableList``, ``misc/hapi.py:5168``)."""
    return sorted(_TABLES)


def describeTable(TableName: str) -> None:
    """Print a table summary (hapi ``describeTable``, ``misc/hapi.py:2316``)."""
    store = _get_table(TableName)
    nu = store.host["nu0"]
    print("-----------------------------------------")
    print(f"{TableName} summary:")
    print(f"Number of rows: {store.n_lines}")
    if nu.size:
        print(f"nu range: {nu.min():.6f} .. {nu.max():.6f} cm-1")
    print(f"Molecules: {sorted(set(store.host['mol_id'].tolist()))}")
    print("-----------------------------------------")


def dropTable(TableName: str) -> None:
    """Remove a table from memory (hapi ``dropTable``, ``misc/hapi.py:2398``)."""
    _TABLES.pop(TableName, None)
    _EXTRAS.pop(TableName, None)


def _get_table(name: str) -> LineStore:
    if name not in _TABLES:
        raise KeyError(
            f"{name}: no such table. Check tableList() for more info.")
    return _TABLES[name]


def _register(name: str, store: LineStore) -> None:
    _TABLES[name] = store


def _with_column(store: LineStore, name: str, values) -> LineStore:
    """``store`` with its host and device column ``name`` replaced by
    ``values`` (same rows, device and dtype)."""
    host = dict(store.host)
    host[name] = as_numpy(values, host[name].dtype)
    return LineStore.from_numpy(**host, device=store.sw.device,
                                dtype=store.sw.dtype)


# ===========================================================================
# Table editing verbs (hapi misc/hapi.py:1710-2960)
#
# hapi's table model is a per-column dict under LOCAL_TABLE_CACHE; ours is a
# packed LineStore (the engine's nine .par columns) plus an ``extras`` dict
# for everything else. Row operations (insertRow/deleteRows/arrangeTable)
# act on both, column operations (addColumn/deleteColumn/renameColumn/
# splitColumn) on the extras only: the core schema is what the engine
# consumes and cannot be dropped or renamed (attempting it raises).
#
# Four of these are no-op stubs in hapi itself (``renameColumn``
# ``misc/hapi.py:2516``, ``insertRow`` ``:2519``, ``deleteRows`` ``:2522``,
# ``splitColumn`` ``:2937``); they are implemented with real semantics here
# and the divergence is documented in MIGRATION.md.
# ===========================================================================

#: per-table column metadata for generic (createTable) tables:
#: name -> {"order": [...], "format": {...}, "default": {...}}
_META: dict[str, dict] = {}

#: the engine's packed columns (hapi-visible names)
_CORE_COLUMNS = ("molec_id", "local_iso_id", "nu", "sw", "elower",
                 "gamma_air", "gamma_self", "n_air", "delta_air", "SD_air")
_CORE_DEFAULTS = {"molec_id": 1, "local_iso_id": 1}


def _row_source(name: str) -> dict:
    """Merged {column: host array} view (core + extras + LineNumber) for
    expression evaluation — richer than hapi's VarDictionary, which sees
    core columns only."""
    store = _get_table(name)
    src = dict(_db._store_rows(store))
    src["SD_air"] = store.host["sd_air"]
    for k, v in _EXTRAS.get(name, {}).items():
        src[k] = np.asarray(v)
    src["LineNumber"] = np.arange(store.n_lines)
    return src


def _take_rows(name: str, dest: str, idx) -> LineStore:
    """Row subset by index array, keeping extras aligned.

    The result is re-sorted by line centre with a stable sort: a
    :class:`LineStore` is nu-sorted by invariant (the engines' planning
    depends on it), so an arbitrary ``idx`` order cannot be preserved — a
    documented divergence from hapi's ``arrangeTable`` row order.
    """
    store = _get_table(name)
    idx = np.asarray(idx)
    idx = idx[np.argsort(store.host["nu0"][idx], kind="stable")]
    out = store.subset(idx)
    _TABLES[dest] = out
    if name in _EXTRAS:
        _EXTRAS[dest] = {k: np.asarray(v)[idx]
                         for k, v in _EXTRAS[name].items()}
    if name in _META:
        _META[dest] = {k: (list(v) if isinstance(v, list) else dict(v))
                       for k, v in _META[name].items()}
    return out


def createTable(TableName, RowObjectDefault):
    """Create an empty table from a ``(name, default, format)`` row spec
    (hapi ``createTable``, ``misc/hapi.py:2373``), on the database's
    device (the card before any ``db_begin``).

    Core ``.par`` columns land in an (empty) :class:`LineStore`; any other
    names become extras columns. Defaults/formats are kept per table and
    used by :func:`insertRow`.
    """
    order, formats, defaults = [], {}, {}
    for par_name, par_value, par_format in RowObjectDefault:
        order.append(par_name)
        formats[par_name] = par_format
        defaults[par_name] = par_value
    empty = np.zeros(0)
    _TABLES[TableName] = from_arrays(
        empty, empty, empty, empty, empty, empty, empty,
        np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64),
        device=resolve_device(_DEVICE), dtype=torch.float64)
    _EXTRAS[TableName] = {k: np.zeros(0) for k in order
                          if k not in _CORE_COLUMNS}
    _META[TableName] = {"order": order, "format": formats,
                        "default": defaults}


def insertRow(TableName=None, RowDict=None, **values):
    """Append one row (column-name -> value).

    hapi's ``insertRow`` is an argument-less no-op stub
    (``misc/hapi.py:2519``); this one actually inserts. Missing core
    columns take the table's :func:`createTable` defaults (else 0, with
    ``molec_id``/``local_iso_id`` defaulting to (1, 1) so the isotopologue
    registry lookup stays valid); missing extras take their defaults.
    """
    if TableName is None:
        return None  # exact hapi signature/behavior: insertRow() is a no-op
    vals = dict(RowDict or {})
    vals.update(values)
    store = _get_table(TableName)
    defaults = _META.get(TableName, {}).get("default", {})

    def core(name, fallback=0.0):
        return vals.get(name, defaults.get(
            name, _CORE_DEFAULTS.get(name, fallback)))

    rows = _db._store_rows(store)
    new = {k: np.concatenate([np.asarray(rows[k], dtype=np.float64),
                              [float(core(k))]])
           for k in rows}
    sd = np.concatenate([store.host["sd_air"], [float(core("SD_air"))]])
    _TABLES[TableName] = from_arrays(
        new["nu"], new["sw"], new["elower"], new["gamma_air"],
        new["gamma_self"], new["n_air"], new["delta_air"],
        new["molec_id"].astype(np.int64),
        new["local_iso_id"].astype(np.int64), sd_air=sd,
        device=store.sw.device, dtype=store.sw.dtype)
    # from_arrays re-sorts by nu; extras must follow the same permutation
    order = np.argsort(new["nu"], kind="stable")
    extras = _EXTRAS.get(TableName, {})
    for k, v in list(extras.items()):
        v = np.concatenate([np.asarray(v),
                            np.asarray([vals.get(k, defaults.get(k, 0))],
                                       dtype=np.asarray(v).dtype)])
        extras[k] = v[order]
    if extras:
        _EXTRAS[TableName] = extras
    return _TABLES[TableName]


def deleteRows(TableName, ParameterNames=None, Conditions=None):
    """Drop rows matching a condition expression (query DSL).

    hapi's ``deleteRows`` is a no-op stub (``misc/hapi.py:2522``);
    ``ParameterNames`` is kept for signature compatibility and ignored,
    as there. Conditions may reference extras columns too.
    """
    if Conditions is None:
        return _get_table(TableName)
    mask = np.asarray(_query.filter_mask(_row_source(TableName), Conditions),
                      dtype=bool)
    return _take_rows(TableName, TableName, np.nonzero(~mask)[0])


def arrangeTable(TableName, DestinationTableName=None, RowIDList=None):
    """Subset/reorder rows by explicit row ids (hapi ``arrangeTable``,
    ``misc/hapi.py:2609``)."""
    dest = DestinationTableName or TableName
    if RowIDList is None:
        RowIDList = np.arange(_get_table(TableName).n_lines)
    return _take_rows(TableName, dest, as_numpy(RowIDList, np.int64))


def addColumn(TableName, ParameterName, Before=None, Expression=None,
              Type=None, Default=None, Format=None):
    """Add an extras column, constant or computed from an ``Expression`` in
    the condition/arithmetic DSL (hapi ``addColumn``, ``misc/hapi.py:2462``;
    expression semantics per ``evaluateExpression`` ``:2144`` with the
    ``LineNumber`` pseudo-column available, as in hapi)."""
    store = _get_table(TableName)
    extras = _EXTRAS.setdefault(TableName, {})
    if ParameterName in _CORE_COLUMNS or ParameterName in extras:
        raise ValueError(f'Column "{ParameterName}" already exists')
    if Type is None:
        Type = float
    if Default is None:
        Default = {int: 0, float: 0.0, str: "", bool: False}.get(Type, 0.0)
    if Expression is None:
        col = np.full(store.n_lines, Default,
                      dtype=object if Type is str else None)
    else:
        col = np.broadcast_to(
            np.asarray(_query.evaluate(_row_source(TableName), Expression)),
            (store.n_lines,)).copy()
    extras[ParameterName] = col
    meta = _META.setdefault(
        TableName, {"order": list(_CORE_COLUMNS), "format": {},
                    "default": {}})
    if Before is not None and Before in meta["order"]:
        meta["order"].insert(meta["order"].index(Before), ParameterName)
    else:
        meta["order"].append(ParameterName)
    if Format is not None:
        meta["format"][ParameterName] = Format
    meta["default"][ParameterName] = Default
    return col


def deleteColumn(TableName, ParameterName):
    """Remove an extras column (hapi ``deleteColumn``, ``misc/hapi.py:2497``).
    Core engine columns cannot be dropped — raises instead."""
    if ParameterName in _CORE_COLUMNS:
        raise ValueError(
            f'"{ParameterName}" is a core engine column of the packed '
            "LineStore and cannot be deleted (documented divergence)")
    extras = _EXTRAS.get(TableName, {})
    if ParameterName not in extras:
        raise KeyError(f'No such column "{ParameterName}"')
    del extras[ParameterName]
    meta = _META.get(TableName)
    if meta and ParameterName in meta["order"]:
        meta["order"].remove(ParameterName)
        meta["format"].pop(ParameterName, None)
        meta["default"].pop(ParameterName, None)


def deleteColumns(TableName, ParameterNames):
    """Remove several extras columns (hapi ``deleteColumns``,
    ``misc/hapi.py:2510``)."""
    for p in (ParameterNames if isinstance(ParameterNames, (list, tuple, set))
              else [ParameterNames]):
        deleteColumn(TableName, p)


def renameColumn(TableName, OldParameterName, NewParameterName):
    """Rename an extras column. hapi's ``renameColumn`` is a no-op stub
    (``misc/hapi.py:2516``); this one renames. Core columns raise."""
    if OldParameterName in _CORE_COLUMNS:
        raise ValueError(
            f'"{OldParameterName}" is a core engine column and cannot be '
            "renamed")
    extras = _EXTRAS.get(TableName, {})
    if OldParameterName not in extras:
        raise KeyError(f'No such column "{OldParameterName}"')
    extras[NewParameterName] = extras.pop(OldParameterName)
    meta = _META.get(TableName)
    if meta and OldParameterName in meta["order"]:
        meta["order"][meta["order"].index(OldParameterName)] = \
            NewParameterName
        for d in (meta["format"], meta["default"]):
            if OldParameterName in d:
                d[NewParameterName] = d.pop(OldParameterName)


def splitColumn(TableName, SourceParameterName, ParameterNames, Splitter):
    """Split a string extras column on a delimiter into typed columns.

    hapi's ``splitColumn`` is a no-op stub (``misc/hapi.py:2937``); this is
    the delimiter-based sibling of :func:`extractColumns`. Fields that
    parse as numbers become float columns, the rest stay strings; short
    rows pad with empty fields.
    """
    extras = _EXTRAS.get(TableName, {})
    if SourceParameterName not in extras:
        raise KeyError(f"{SourceParameterName}: not an extra column of "
                       f"{TableName}")
    src = [str(s) for s in extras[SourceParameterName]]
    parts = [s.split(Splitter) for s in src]
    for j, name in enumerate(ParameterNames):
        vals = [p[j].strip() if j < len(p) else "" for p in parts]
        try:
            col = np.asarray([float(v) for v in vals])
        except ValueError:
            col = np.asarray(vals, dtype=object)
        extras[name] = col
    return {n: extras[n] for n in ParameterNames}


def saveCache():
    """Write every loaded table back to the database directory (hapi
    ``saveCache``, ``misc/hapi.py:1732``; drops the query buffer first,
    as there)."""
    _TABLES.pop("__BUFFER__", None)
    _EXTRAS.pop("__BUFFER__", None)
    db_commit()


def loadCache():
    """(Re)load every table from the database directory onto its device
    (hapi ``loadCache``, ``misc/hapi.py:1718``)."""
    if _DB_DIR is None:
        raise RuntimeError("no database opened; call db_begin(dir) first")
    db_begin(_DB_DIR, device=_DEVICE)


def databaseBegin(db=None, device=None):
    """DB-backend-level open (hapi ``databaseBegin``,
    ``misc/hapi.py:1745``) — same as :func:`db_begin`."""
    db_begin(db, device=device)


def databaseCommit():
    """DB-backend-level commit (hapi ``databaseCommit``,
    ``misc/hapi.py:1753``) — same as :func:`saveCache`."""
    saveCache()


def select(TableName, DestinationTableName="__BUFFER__", ParameterNames=None,
           Conditions=None, Output=False, File=None):
    """Rows matching a condition expression into a destination table
    (hapi ``select``, ``misc/hapi.py:2567``; expression DSL per
    :mod:`.lines.query`).

    Divergence: hapi prints by default (``Output=True``); here the result
    is registered under ``DestinationTableName`` and printing is opt-in.
    """
    store = _get_table(TableName)
    out = _query.select(store, Conditions) if Conditions is not None else store
    _register(DestinationTableName, out)
    if Output or File:
        rows = _db._store_rows(out)
        names = ParameterNames or list(rows)
        lines = [" ".join(str(rows[p][k]) for p in names)
                 for k in range(out.n_lines)]
        if File:
            with open(File, "w") as f:
                f.write("\n".join(lines) + "\n")
        else:
            print("\n".join(lines))
    return out


def sort(TableName, DestinationTableName=None, ParameterNames=None,
         Accending=True, Output=False, File=None):
    """Reorder rows by column(s) (hapi ``sort``, ``misc/hapi.py:2679``);
    a list of names sorts lexicographically, first name most significant."""
    store = _get_table(TableName)
    out = _query.sort(store, by=ParameterNames or "nu",
                      descending=not Accending)
    _register(DestinationTableName or TableName, out)
    return out


def group(TableName, DestinationTableName="__BUFFER__", ParameterNames=None,
          GroupParameterNames=None, Output=True):
    """Group-by aggregation (hapi ``group``, ``misc/hapi.py:2731``).

    ``ParameterNames`` entries are ``(FUNC, expr)`` pairs with FUNC in
    :data:`.lines.query.GROUP_FUNCTIONS`. Returns the
    ``{key: values, agg: values}`` dict (hapi mutates a destination table).
    """
    store = _get_table(TableName)
    aggs = {}
    for i, p in enumerate(ParameterNames or []):
        how, expr = (p[0], p[1] if len(p) > 1 else None) \
            if isinstance(p, (tuple, list)) else ("COUNT", None)
        aggs[f"{str(how).lower()}_{expr if isinstance(expr, str) else i}"] = (how, expr)
    out = _query.group(store, GroupParameterNames or "molec_id", aggs)
    if Output:
        print(out)
    return out


def getColumn(TableName, ParameterName):
    """One column as a list (hapi ``getColumn``, ``misc/hapi.py:2422``)."""
    return _query._col(_get_table(TableName), ParameterName).tolist()


def getColumns(TableName, ParameterNames):
    """Several columns (hapi ``getColumns``, ``misc/hapi.py:2441``)."""
    return [getColumn(TableName, p) for p in ParameterNames]


def extractColumns(TableName, SourceParameterName, ParameterFormats,
                   ParameterNames=None, FixCol=False):
    """Split a string column into typed columns (hapi ``extractColumns``,
    ``misc/hapi.py:2815``) — operates on the table's extras dict."""
    extras = _EXTRAS.get(TableName, {})
    table = dict(extras)
    if SourceParameterName not in table:
        raise KeyError(f"{SourceParameterName}: not an extra column of "
                       f"{TableName}")
    names = ParameterNames or [f"col{i}" for i in range(len(ParameterFormats))]
    _EXTRAS[TableName] = _query.extract_columns(
        table, SourceParameterName, ParameterFormats, names, fix_col=FixCol)
    return _EXTRAS[TableName]


def fetch(TableName, M, I, numin, numax, ParameterGroups=None,
          Parameters=None):
    """Download lines from hitran.org into a table (hapi ``fetch``,
    ``misc/hapi.py:5276``). Network-gated like :func:`.lines.fetch.fetch`.

    ``ParameterGroups``/``Parameters`` request hitran.org's extended column
    sets (e.g. ``['sdvoigt']``, ``['ht']``); the extra columns land in the
    table's extras (consumed by the HT driver) and an ``SD_air`` column is
    merged into the line store for the SD-Voigt engine
    (``misc/hapi.py:3118-3168``)."""
    return fetch_by_ids(
        TableName,
        _fetch._global_ids(M, I if isinstance(I, (list, tuple)) else [I]),
        numin, numax, ParameterGroups=ParameterGroups, Parameters=Parameters)


def fetch_by_ids(TableName, iso_id_list, numin, numax, ParameterGroups=None,
                 Parameters=None):
    """hapi ``fetch_by_ids`` (``misc/hapi.py:5245``) — global iso ids; the
    table lands on the database's device (the card before any
    ``db_begin``)."""
    out = _fetch.fetch_by_ids(iso_id_list, numin, numax,
                              pargroups=tuple(ParameterGroups or ()),
                              params=tuple(Parameters or ()),
                              device=resolve_device(_DEVICE))
    if isinstance(out, tuple):
        store, extras = out
        _EXTRAS[TableName] = {
            k: v for k, v in extras.items()
            if np.asarray(v).dtype != object}
    else:
        store = out
    _register(TableName, store)
    if _DB_DIR is not None:
        _db.save_table(store, _DB_DIR, TableName)
    return store


def getStickXY(TableName):
    """Stick-spectrum polyline (hapi ``getStickXY``, ``misc/hapi.py:11684``)."""
    return _query.stick_xy(_get_table(TableName))


# ===========================================================================
# Isotopologue registry (hapi ISO/ISO_ID, misc/hapi.py:3234,3372)
# ===========================================================================

@functools.lru_cache(maxsize=1)
def _registry_full():
    path = os.path.join(DATA_DIR, "iso_registry.npz")
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


@functools.lru_cache(maxsize=1)
def _iso_dicts():
    r = _registry_full()
    iso = {}
    iso_id = {}
    for k in range(len(r["mol"])):
        m, i = int(r["mol"][k]), int(r["iso"][k])
        gid = int(r["global_id"][k])
        row = [gid, str(r["iso_name"][k]), float(r["abundance"][k]),
               float(r["molar_mass"][k]), str(r["mol_name"][k])]
        iso[(m, i)] = row
        iso_id[gid] = [m, i, row[1], row[2], row[3], row[4]]
    return iso, iso_id


def __getattr__(name):  # lazy ISO / ISO_ID module attributes
    if name == "ISO":
        return _iso_dicts()[0]
    if name == "ISO_ID":
        return _iso_dicts()[1]
    raise AttributeError(name)


def abundance(M, I):
    """Natural abundance (hapi ``abundance``, ``misc/hapi.py:5088``)."""
    return _iso_dicts()[0][(int(M), int(I))][2]


def molecularMass(M, I):
    """Molar mass [g/mol] (hapi ``molecularMass``, ``misc/hapi.py:5109``)."""
    return _iso_dicts()[0][(int(M), int(I))][3]


def moleculeName(M):
    """Molecule name (hapi ``moleculeName``, ``misc/hapi.py:5130``)."""
    for (m, _i), row in _iso_dicts()[0].items():
        if m == int(M):
            return row[4]
    raise KeyError(f"unknown molecule number {M}")


def isotopologueName(M, I):
    """Isotopologue name (hapi ``isotopologueName``, ``misc/hapi.py:5150``)."""
    return _iso_dicts()[0][(int(M), int(I))][1]


def print_iso():
    """Registry listing keyed by (M, I) (hapi ``print_iso``)."""
    print("The dictionary \"ISO\" contains information on isotopologues in HITRAN")
    print("M    I    id    iso_name    abundance    mass    mol_name")
    for (m, i), (gid, iname, ab, mass, mname) in sorted(_iso_dicts()[0].items()):
        print(f"{m:4d} {i:4d} : {gid:5d} {iname:>18s} {ab:.6E} {mass:10.6f} {mname:>8s}")


def print_iso_id():
    """Registry listing keyed by global id (hapi ``print_iso_id``)."""
    print("The dictionary \"ISO_ID\" contains information on \"global\" IDs of isotopologues in HITRAN")
    print("id    M    I    iso_name    abundance    mass    mol_name")
    for gid, (m, i, iname, ab, mass, mname) in sorted(_iso_dicts()[1].items()):
        print(f"{gid:5d} : {m:4d} {i:4d} {iname:>18s} {ab:.6E} {mass:10.6f} {mname:>8s}")


# ===========================================================================
# Partition sums (hapi partitionSum/PYTIPS, misc/hapi.py:9589,10030)
# ===========================================================================

@functools.lru_cache(maxsize=1)
def _q_host() -> torch.Tensor:
    """The TIPS-2011 table as a float64 CPU tensor (the host's Q(T))."""
    return torch.as_tensor(_tips.load_tips_tables()[3], dtype=torch.float64)


def _q_all_host(T: float) -> np.ndarray:
    """Q(T) of every isotopologue row, on the host in float64."""
    q = _q_host()
    return _tips.partition_sum(q, torch.arange(q.shape[0]),
                               torch.tensor(float(T), dtype=torch.float64)
                               ).numpy()


def PYTIPS(M, I, T):
    """Q(T) for one isotopologue (hapi ``PYTIPS``, ``misc/hapi.py:10030``),
    on the host in float64."""
    row = _tips.iso_row_index()[(int(M), int(I))]
    return float(_tips.partition_sum(
        _q_host(), torch.tensor([row]),
        torch.tensor(float(T), dtype=torch.float64))[0])


def partitionSum(M, I, T, step=None):
    """hapi ``partitionSum`` (``misc/hapi.py:9589``): scalar/list T -> Q
    values; (Tmin, Tmax) + ``step`` -> (T grid, Q array)."""
    if not step:
        if not isinstance(T, (list, tuple)):
            return PYTIPS(M, I, T)
        return [PYTIPS(M, I, t) for t in T]
    TT = np.arange(T[0], T[1], step)
    return TT, np.array([PYTIPS(M, I, t) for t in TT])


# ===========================================================================
# Line profiles + CPF (hapi PROFILE_*/cpf family, misc/hapi.py:9645-10160),
# computed on the device of the tensor inputs, returned as NumPy
# ===========================================================================

def _profile(fn, *args):
    dev = _work_device(*args)
    out = fn(*(_on(dev, a) for a in args))
    if isinstance(out, tuple):
        return tuple(as_numpy(o) for o in out)
    return as_numpy(out)


def PROFILE_HT(sg0, GamD, Gam0, Gam2, Shift0, Shift2, anuVC, eta, sg):
    """Hartmann-Tran pCqSDHC -> (Re, Im) (hapi ``PROFILE_HT``,
    ``misc/hapi.py:10034``)."""
    return _profile(_htp.profile_ht, sg0, GamD, Gam0, Gam2, Shift0, Shift2,
                    anuVC, eta, sg)


PROFILE_HTP = PROFILE_HT  # hapi backwards-compat alias (misc/hapi.py:10087)


def PROFILE_SDRAUTIAN(sg0, GamD, Gam0, Gam2, Shift0, Shift2, anuVC, sg):
    """hapi ``PROFILE_SDRAUTIAN`` (``misc/hapi.py:10089``)."""
    return _profile(_htp.profile_sdrautian, sg0, GamD, Gam0, Gam2, Shift0,
                    Shift2, anuVC, sg)


def PROFILE_RAUTIAN(sg0, GamD, Gam0, Shift0, anuVC, eta, sg):
    """hapi ``PROFILE_RAUTIAN`` (``misc/hapi.py:10104``; its ``eta``
    argument is ignored there too)."""
    return _profile(_htp.profile_rautian, sg0, GamD, Gam0, Shift0, anuVC, sg)


def PROFILE_SDVOIGT(sg0, GamD, Gam0, Gam2, Shift0, Shift2, sg):
    """hapi ``PROFILE_SDVOIGT`` (``misc/hapi.py:10117``)."""
    return _profile(_htp.profile_sdvoigt, sg0, GamD, Gam0, Gam2, Shift0,
                    Shift2, sg)


def PROFILE_VOIGT(sg0, GamD, Gam0, sg):
    """hapi ``PROFILE_VOIGT`` (``misc/hapi.py:10131``) -> (Re, Im)."""
    return _profile(_htp.profile_ht, sg0, GamD, Gam0, 0.0, 0.0, 0.0, 0.0,
                    0.0, sg)


def PROFILE_LORENTZ(sg0, Gam0, sg):
    """hapi ``PROFILE_LORENTZ`` (``misc/hapi.py:10142``)."""
    return _profile(lambda s0, g0, s: _prof.lorentz(s - s0, g0),
                    sg0, Gam0, sg)


def PROFILE_DOPPLER(sg0, GamD, sg):
    """hapi ``PROFILE_DOPPLER`` (``misc/hapi.py:10152``)."""
    return _profile(lambda s0, gd, s: _prof.doppler(s - s0, gd),
                    sg0, GamD, sg)


def cpf(X, Y):
    """Full Humlicek 3-region CPF (hapi ``cpf``, ``misc/hapi.py:9677``)."""
    return _profile(_fad.cpf_humlicek, X, Y)


def cpf3(X, Y):
    """15-term asymptotic CPF (hapi ``cpf3``, ``misc/hapi.py:9645``)."""
    return _profile(_fad.cpf3, X, Y)


def hum1_wei(x, y, n=24):
    """Humlicek-1 + Weideman blend, hapi's default CPF
    (``misc/hapi.py:9833-9846``)."""
    return _profile(lambda a, b: _fad.wofz_real(*_fad._pair(a, b), n), x, y)


def cef(x, y, N=24):
    """Weideman rational series -> complex w (hapi ``cef``,
    ``misc/hapi.py:9812``)."""
    return _profile(lambda a, b: _fad.cef(a, b, N), x, y)


# ===========================================================================
# Environment dependences (misc/hapi.py:10169-10200)
# ===========================================================================

def EnvironmentDependency_Intensity(LineIntensityRef, T, Tref, SigmaT,
                                    SigmaTref, LowerStateEnergy, LineCenter):
    """hapi ``misc/hapi.py:10169``."""
    const = 1.4388028496642257
    ch = np.exp(-const * LowerStateEnergy / T) * (1 - np.exp(-const * LineCenter / T))
    zn = np.exp(-const * LowerStateEnergy / Tref) * (1 - np.exp(-const * LineCenter / Tref))
    return LineIntensityRef * SigmaTref / SigmaT * ch / zn


def EnvironmentDependency_GammaD(GammaD_ref, T, Tref):
    """hapi ``misc/hapi.py:10178``."""
    return GammaD_ref * np.sqrt(T / Tref)


def EnvironmentDependency_Gamma0(Gamma0_ref, T, Tref, p, pref,
                                 TempRatioPower):
    """hapi ``misc/hapi.py:10183``."""
    return Gamma0_ref * p / pref * (Tref / T) ** TempRatioPower


def EnvironmentDependency_Gamma2(Gamma2_ref, T, Tref, p, pref,
                                 TempRatioPower):
    """hapi ``misc/hapi.py:10187``."""
    return Gamma2_ref * p / pref * (Tref / T) ** TempRatioPower


def EnvironmentDependency_Delta0(Delta0_ref, p, pref):
    """hapi ``misc/hapi.py:10191``."""
    return Delta0_ref * p / pref


def EnvironmentDependency_Delta2(Delta2_ref, p, pref):
    """hapi ``misc/hapi.py:10195``."""
    return Delta2_ref * p / pref


def EnvironmentDependency_anuVC(anuVC_ref, T, Tref, p, pref):
    """hapi ``misc/hapi.py:10199``."""
    return anuVC_ref * Tref / T * p / pref


def volumeConcentration(p, T):
    """Number density [molecules/cm^3] at p [atm], T [K]
    (hapi ``volumeConcentration``, ``misc/hapi.py:10163``)."""
    return (p / 9.869233e-7) / (_K_BOLTS_CGS * T)


# ===========================================================================
# Absorption-coefficient drivers (misc/hapi.py:10302-11580)
# ===========================================================================

def arange_(lower, upper, step):
    """Drift-free uniform grid (hapi ``arange_``, ``misc/hapi.py:133``)."""
    return np.asarray(_spec.arange_drift_free(lower, upper, step))


def save_to_file(fname, fformat, *arg):
    """Column text dump (hapi ``save_to_file``, ``misc/hapi.py:10287``)."""
    with open(fname, "w") as f:
        for vals in zip(*arg):
            f.write((fformat + "\n") % tuple(vals))


def _list_of(a):
    return a if isinstance(a, (list, tuple)) else [a]


def _local_iso(store: LineStore) -> np.ndarray:
    """The HITRAN local isotopologue number of each line (host)."""
    return _tips.load_tips_tables()[1][store.host["iso_row"]]


def _driver_common(Components, SourceTables, Environment, OmegaRange,
                   OmegaStep, OmegaWing, OmegaGrid,
                   WavenumberRange, WavenumberStep, WavenumberWing,
                   WavenumberWingHW, WavenumberGrid, OmegaWingHW):
    """hapi ``getDefaultValuesForXsect`` semantics (``misc/hapi.py:10231``)."""
    if WavenumberRange is not None:
        OmegaRange = WavenumberRange
    if WavenumberStep is not None:
        OmegaStep = WavenumberStep
    if WavenumberWing is not None:
        OmegaWing = WavenumberWing
    if WavenumberWingHW is not None:
        OmegaWingHW = WavenumberWingHW
    if WavenumberGrid is not None:
        OmegaGrid = WavenumberGrid

    tables = [t for t in _list_of(SourceTables) if t is not None] or ["__BUFFER__"]
    stores = [_get_table(t) for t in tables]

    if Components is None:
        comps = set()
        for s in stores:
            comps |= set(zip(s.host["mol_id"].tolist(),
                             _local_iso(s).tolist()))
        Components = sorted(comps)
    else:
        Components = [tuple(c) for c in _list_of(Components)]
        if Components and not isinstance(Components[0], tuple):
            Components = [tuple(Components)]

    env = {"T": 296.0, "p": 1.0}
    env.update(Environment or {})

    if OmegaGrid is not None:
        grid = as_numpy(OmegaGrid).astype(np.float64)
    else:
        if OmegaRange is None:
            nus = np.concatenate([s.host["nu0"] for s in stores])
            OmegaRange = (float(nus.min()), float(nus.max()))
        step = 0.01 if OmegaStep is None else float(OmegaStep)
        grid = arange_(OmegaRange[0], OmegaRange[1], step)
    wing = 0.0 if OmegaWing is None else float(OmegaWing)
    return tables, stores, Components, env, grid, wing, float(OmegaWingHW)


def _component_mask_and_ratio(store: LineStore, components):
    """Line keep-mask + per-line abundance ratio for hapi Components tuples
    (M, I[, D]) (``misc/hapi.py:10996-11009``), on the host."""
    local = _local_iso(store)
    mol = store.host["mol_id"]
    keep = np.zeros(store.n_lines, dtype=bool)
    ratio = np.ones(store.n_lines)
    for comp in components:
        m, i = int(comp[0]), int(comp[1])
        sel = (mol == m) & (local == i)
        keep |= sel
        if len(comp) > 2 and comp[2] is not None:
            ratio[sel] = float(comp[2]) / abundance(m, i)
    return keep, ratio


def _threshold_mask(store: LineStore, T: float, threshold: float) -> np.ndarray:
    """hapi cuts lines whose T-scaled intensity (before the abundance
    factor) is below ``IntensityThreshold`` (``misc/hapi.py:11078-11082``).
    Q(T) and the scaled intensities are computed on the host in float64
    from the store's host columns, whatever its device, so a line near the
    threshold is kept or cut alike on the card and the CPU."""
    if threshold <= 0.0:
        return np.ones(store.n_lines, dtype=bool)
    h = store.host
    rows = h["iso_row"]
    qt = _q_all_host(T)
    qref = _q_all_host(T_REF)
    const = 1.4388028496642257
    e, nu = h["elower"], h["nu0"]
    ch = np.exp(-const * e / T) * (1 - np.exp(-const * nu / T))
    zn = np.exp(-const * e / T_REF) * (1 - np.exp(-const * nu / T_REF))
    s = h["sw"] * (qref[rows] / qt[rows]) * ch / zn
    return s >= threshold


def _resolve_diluent(Diluent, GammaL):
    if Diluent:
        d = {str(k).lower(): float(v) for k, v in dict(Diluent).items()}
        if abs(sum(d.values()) - 1.0) > 1e-6:
            import warnings

            warnings.warn("diluent fractions do not sum to 1")
        return d
    if GammaL == "gamma_air":
        return {"air": 1.0}
    if GammaL == "gamma_self":
        return {"self": 1.0}
    raise ValueError(f"unknown GammaL value: {GammaL!r}")


def _hook_columns(sub: LineStore, name: str, keep: np.ndarray):
    """The host columns a hooked driver's per-line loop sees: the core
    columns (hapi names) and the table's extras of the kept rows; plus
    each line's molar mass."""
    h = sub.host
    loc = _local_iso(sub)
    iso_h = IsoTables.load(device="cpu", dtype=torch.float64)
    mass = iso_h.molar_mass.numpy()[h["iso_row"]]
    cols = {"nu": h["nu0"], "sw": h["sw"], "elower": h["elower"],
            "gamma_air": h["gamma_air"], "gamma_self": h["gamma_self"],
            "n_air": h["n_air"], "delta_air": h["delta_air"],
            "SD_air": h["sd_air"], "molec_id": h["mol_id"],
            "local_iso_id": loc}
    extras = _EXTRAS.get(name) or {}
    idx = np.nonzero(keep)[0]
    for k, v in extras.items():
        if np.ndim(v) == 1 and len(v) == keep.size:
            cols.setdefault(k, np.asarray(v)[idx])
    return cols, mass


def _hook_common(cols, mass, T, p, pf, env_dep, Environment):
    """The per-line callbacks' shared pieces (``misc/hapi.py:10931-11082``):
    the partition sums at T and Tref through ``pf``, the ``Env`` dict, each
    line's override dict, the (possibly overridden) intensity and the
    Doppler width."""
    mol, loc = cols["molec_id"], cols["local_iso_id"]
    n = cols["nu"].size
    pf = pf or PYTIPS
    Tref, pref = float(T_REF), 1.0
    q_t, q_ref = {}, {}
    for m_i in {(int(m), int(i)) for m, i in zip(mol, loc)}:
        q_t[m_i] = float(pf(m_i[0], m_i[1], T))
        q_ref[m_i] = float(pf(m_i[0], m_i[1], Tref))
    sig_t = np.array([q_t[(int(m), int(i))] for m, i in zip(mol, loc)])
    sig_ref = np.array([q_ref[(int(m), int(i))] for m, i in zip(mol, loc)])

    Env = {"T": T, "p": p}
    Env.update({k: v for k, v in (Environment or {}).items()})
    Env["Tref"], Env["pref"] = Tref, pref

    def custom(i):
        if env_dep is None:
            return {}
        return env_dep(Env, {k: v[i] for k, v in cols.items()}) or {}

    cds = [custom(i) for i in range(n)]

    s_def = np.asarray(EnvironmentDependency_Intensity(
        cols["sw"], T, Tref, sig_t, sig_ref, cols["elower"], cols["nu"]))
    strength = np.array([_get(cd, "sw", s_def[i]) for i, cd in enumerate(cds)])

    c_mass_mol = 1.66053873e-27
    m_kg = mass * c_mass_mol * 1000.0
    c_bolts, cc = 1.380648813e-16, 2.99792458e10
    gamma_d = np.sqrt(2 * c_bolts * T * np.log(2) / m_kg / cc**2) * cols["nu"]
    return cds, strength, gamma_d


def _get(cd, key, default):
    return float(cd[key]) if key in cd else default


def _n_fallback(cols, sp, n):
    """hapi's temperature exponent of diluent ``sp``: ``n_<sp>``, else
    ``n_air``; for self, a present-but-zero ``n_self`` falls back too."""
    n_db = cols.get(f"n_{sp}", np.full(n, np.nan))
    if sp == "self":
        return np.where(np.isnan(n_db) | (n_db == 0.0), cols["n_air"], n_db)
    return np.where(np.isnan(n_db), cols["n_air"], n_db)


def _hooked_xsect(profile, sub, name, keep, T, p, diluent, grid,
                  wing_abs, wing_hw, pf, env_dep, ratio, Environment,
                  threshold, line_shift):
    """Driver hot loop with the user extension hooks evaluated on the host
    (hapi ``EnvDependences`` / custom ``partitionFunction``,
    ``misc/hapi.py:10931-11138``): per-line parameters are assembled in
    NumPy exactly as the reference loop does — custom ``sw`` /
    ``gamma_<sp>`` / ``delta_<sp>`` / ``SD_<sp>`` overrides, the hapi
    ``n_self``/``deltap`` fallback rules, the post-override intensity
    threshold — then uploaded once as a ready-made :class:`LineParams` in
    float64 to the grid's device and summed by the reference engine.
    """
    cols, mass = _hook_columns(sub, name, keep)
    n = cols["nu"].size
    cds, strength, gamma_d = _hook_common(cols, mass, T, p, pf, env_dep,
                                          Environment)
    Tref, pref = float(T_REF), 1.0
    col = lambda nm, d=0.0: cols.get(nm, np.full(n, d))  # noqa: E731

    gamma0 = np.zeros(n)
    shift0 = np.zeros(n)
    gamma2 = np.zeros(n)
    if profile != "doppler":
        for sp, abun in diluent.items():
            sp = sp.lower()
            g_db = col(f"gamma_{sp}")
            n_db = _n_fallback(cols, sp, n)
            d_db = col(f"delta_{sp}")
            dp_db = col(f"deltap_{sp}")
            g_def = np.asarray(EnvironmentDependency_Gamma0(
                g_db, T, Tref, p, pref, n_db))
            s_def_sp = (d_db + dp_db * (T - Tref)) * p / pref
            sd_def = col(f"SD_{sp}") * p / pref
            for i, cd in enumerate(cds):
                gamma0[i] += abun * _get(cd, f"gamma_{sp}", g_def[i])
                shift0[i] += abun * _get(cd, f"delta_{sp}", s_def_sp[i])
                if profile == "sdvoigt":
                    # hapi: Gamma0DB multiplies OUTSIDE the override
                    # (misc/hapi.py:10889-10890)
                    gamma2[i] += (abun * _get(cd, f"SD_{sp}", sd_def[i])
                                  * g_db[i])
    elif line_shift:
        shift0 = cols["delta_air"] * p / pref

    wing = np.maximum(wing_abs,
                      np.maximum(wing_hw * gamma0, wing_hw * gamma_d))
    m = strength >= threshold
    if not m.any():
        return torch.zeros_like(grid)
    centered_inside = profile in ("sdvoigt", "ht")
    t = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                  device=grid.device)
    params = LineParams(
        nu0=t(cols["nu"][m]),
        nu0_shifted=t(cols["nu"][m] if centered_inside
                      else cols["nu"][m] + shift0[m]),
        strength=t(strength[m] * np.asarray(ratio)[m]),
        gamma_d=t(gamma_d[m]),
        gamma_0=t(gamma0[m]),
        wing=t(wing[m]),
        gamma_2=t(gamma2[m]),
        shift0=t(shift0[m]))
    return _xsect(grid, params, profile=profile)


def _hooked_xsect_ht(sub, name, keep, T, p, diluent, grid, wing_abs,
                     wing_hw, pf, env_dep, ratio, Environment, threshold):
    """HT driver hot loop with the user extension hooks, on the host
    (``misc/hapi.py:10455-10650``): per-line HT parameters are assembled
    with hapi's exact override keys — ``gamma_HT_0_<sp>_296`` falling
    back to ``gamma_<sp>``, the shift override under the ``deltap_*``
    keys (hapi's quirk), ``gamma_HT_2/delta_HT_2/nu_HT`` overrides, eta
    built from the OVERRIDDEN Gamma0T/Shift0T — then uploaded once and
    evaluated by the reference pcqsdhc engine
    (:func:`~.kernels.ht_driver.ht_xsect_from_params`)."""
    Tref = float(T_REF)
    cols, mass = _hook_columns(sub, name, keep)
    n = cols["nu"].size
    cds, strength, gamma_d = _hook_common(cols, mass, T, p, pf, env_dep,
                                          Environment)
    col = lambda nm, d=0.0: cols.get(nm, np.full(n, d))  # noqa: E731
    nz = lambda a, b: np.where(a != 0.0, a, b)  # noqa: E731

    gamma0 = np.zeros(n)
    shift0 = np.zeros(n)
    gamma2 = np.zeros(n)
    shift2 = np.zeros(n)
    nuvc = np.zeros(n)
    eta_num = np.zeros(n, dtype=np.complex128)
    for sp, abun in diluent.items():
        sp = sp.lower()
        g_plain = col(f"gamma_{sp}")
        g0db = nz(col(f"gamma_HT_0_{sp}_296"), g_plain)
        ndb = nz(col(f"n_HT_{sp}_296"), _n_fallback(cols, sp, n))
        d0 = nz(col(f"delta_HT_0_{sp}_296"), col(f"delta_{sp}"))
        dp = nz(col(f"deltap_HT_{sp}_296"), col(f"deltap_{sp}"))
        g2db = nz(col(f"gamma_HT_2_{sp}_296"), col(f"SD_{sp}") * g0db)
        d2db = col(f"delta_HT_2_{sp}_296")
        nuvc_db = col(f"nu_HT_{sp}")
        kap_db = col(f"kappa_HT_{sp}")
        eta_db = col(f"eta_HT_{sp}")

        g0t_def = g0db * p * (Tref / T) ** ndb
        s0t_def = (d0 + dp * (T - Tref)) * p
        g2_def = g2db * p
        d2_def = d2db * p
        nv_def = nuvc_db * (Tref / T) ** kap_db * p
        for i, cd in enumerate(cds):
            g0t = _get(cd, f"gamma_HT_0_{sp}_296",
                       _get(cd, f"gamma_{sp}", g0t_def[i]))
            # hapi's shift override lives under the deltap_* keys
            # (misc/hapi.py:10579-10582)
            s0t = _get(cd, f"deltap_HT_{sp}_296",
                       _get(cd, f"deltap_{sp}", s0t_def[i]))
            gamma0[i] += abun * g0t
            shift0[i] += abun * s0t
            gamma2[i] += abun * _get(cd, f"gamma_HT_2_{sp}_296", g2_def[i])
            shift2[i] += abun * _get(cd, f"delta_HT_2_{sp}_296", d2_def[i])
            nuvc[i] += abun * _get(cd, f"nu_HT_{sp}", nv_def[i])
            eta_num[i] += eta_db[i] * abun * (g0t + 1j * s0t)
    with np.errstate(invalid="ignore", divide="ignore"):
        eta = eta_num / (gamma0 + 1j * shift0)
    eta = np.where(np.isfinite(eta), eta, 0.0)

    wing = np.maximum(wing_abs,
                      np.maximum(wing_hw * gamma0, wing_hw * gamma_d))
    m = strength >= threshold
    if not m.any():
        return torch.zeros_like(grid)
    t = lambda a: torch.as_tensor(a, device=grid.device)  # noqa: E731
    prm = dict(
        strength=t(strength[m] * np.asarray(ratio)[m]),
        gamma_d=t(gamma_d[m]), gamma0=t(gamma0[m]), shift0=t(shift0[m]),
        gamma2=t(gamma2[m]), shift2=t(shift2[m]), nuvc=t(nuvc[m]),
        eta=t(eta[m]), wing=t(wing[m]))
    return ht_xsect_from_params(grid, t(cols["nu"][m]), prm, chunk=128)


def _abs_coefficient(profile, Components, SourceTables, partitionFunction,
                     Environment, OmegaRange, OmegaStep, OmegaWing,
                     IntensityThreshold, OmegaWingHW, GammaL, HITRAN_units,
                     LineShift, File, Format, OmegaGrid,
                     WavenumberRange, WavenumberStep, WavenumberWing,
                     WavenumberWingHW, WavenumberGrid, Diluent,
                     EnvDependences):
    # hapi's Doppler driver accepts EnvDependences but never calls it
    # (misc/hapi.py:11384-11581) — faithful: ignore it there.
    hooked = ((EnvDependences is not None and profile != "doppler")
              or partitionFunction not in (None, PYTIPS))

    tables, stores, comps, env, grid_h, wing_abs, wing_hw = _driver_common(
        Components, SourceTables, Environment, OmegaRange, OmegaStep,
        OmegaWing, OmegaGrid, WavenumberRange, WavenumberStep,
        WavenumberWing, WavenumberWingHW, WavenumberGrid, OmegaWingHW)

    T = float(env["T"])
    p = float(env["p"])
    diluent = _resolve_diluent(Diluent, GammaL) if profile != "doppler" else {}

    # the work runs on the (first) table's device; the sum is float64
    dev = stores[0].sw.device
    grid = torch.as_tensor(grid_h, dtype=torch.float64, device=dev)
    k_total = torch.zeros_like(grid)
    for name, store in zip(tables, stores):
        keep, ratio = _component_mask_and_ratio(store, comps)
        if hooked:
            # the intensity threshold applies AFTER a custom 'sw'/pf
            # (misc/hapi.py:11075-11082) — it lives inside the hooked path
            if not keep.any():
                continue
            sub = store.subset(np.nonzero(keep)[0])
            if profile == "ht":
                k_total = k_total + _hooked_xsect_ht(
                    sub, name, keep, T, p, diluent, grid,
                    wing_abs, wing_hw, partitionFunction, EnvDependences,
                    ratio[keep], Environment, float(IntensityThreshold))
            else:
                k_total = k_total + _hooked_xsect(
                    profile, sub, name, keep, T, p, diluent, grid,
                    wing_abs, wing_hw, partitionFunction, EnvDependences,
                    ratio[keep], Environment, float(IntensityThreshold),
                    bool(LineShift))
            continue
        keep &= _threshold_mask(store, T, float(IntensityThreshold))
        if not keep.any():
            continue
        sub = store.subset(np.nonzero(keep)[0])
        ratio = ratio[keep]
        if not LineShift and profile == "doppler":
            # hapi quirk: every driver accepts LineShift but only the
            # Doppler one honors it (misc/hapi.py:11511; the Voigt/SDVoigt/
            # Lorentz/HT drivers always apply the Diluent delta columns)
            sub = _with_column(sub, "delta_air", np.zeros(sub.n_lines))
        iso_tab = IsoTables.load(device=sub.sw.device, dtype=sub.sw.dtype)

        exotic = set(diluent) - {"air", "self"}
        if profile == "ht" or exotic:
            if profile in ("lorentz", "doppler"):
                raise NotImplementedError(
                    f"diluents {sorted(exotic)} are not supported by the "
                    f"{profile} driver (hapi supports air/self there too)")
            extras = _EXTRAS.get(name) or None
            if extras is not None:
                idx = np.nonzero(keep)[0]
                extras = {k: v[idx] for k, v in extras.items()
                          if np.ndim(v) == 1 and len(v) == keep.size}
            if not np.all(ratio == 1.0):
                # the HT driver computes strengths itself; fold the
                # abundance ratio into sw (misc/hapi.py:10536-10540)
                sub = _with_column(sub, "sw", sub.host["sw"] * ratio)
            k = _xsect_ht(grid.to(sub.sw.device), sub, iso_tab, T, p,
                          diluent=diluent, extras=extras,
                          wing_abs=wing_abs, wing_hw=wing_hw)
        else:
            params = _line_params(
                sub, iso_tab, T, p,
                vmr_self=diluent.get("self", 0.0),
                wing_abs=wing_abs, wing_hw=wing_hw,
                abundance_ratio=ratio, profile=profile)
            k = _xsect(grid.to(sub.sw.device), params, profile=profile)
        k_total = k_total + k.to(dev)

    if not HITRAN_units:
        k_total = k_total * volumeConcentration(p, T)
    k_np = as_numpy(k_total)
    if File:
        save_to_file(File, Format or "%.12f %e", grid_h, k_np)
    return grid_h, k_np


def _make_driver(profile, hapi_name, ref_line):
    def driver(Components=None, SourceTables=None, partitionFunction=None,
               Environment=None, OmegaRange=None, OmegaStep=None,
               OmegaWing=None, IntensityThreshold=0.0, OmegaWingHW=50.0,
               GammaL="gamma_air", HITRAN_units=True, LineShift=True,
               File=None, Format=None, OmegaGrid=None, WavenumberRange=None,
               WavenumberStep=None, WavenumberWing=None,
               WavenumberWingHW=None, WavenumberGrid=None, Diluent={},
               EnvDependences=None):
        return _abs_coefficient(
            profile, Components, SourceTables, partitionFunction,
            Environment, OmegaRange, OmegaStep, OmegaWing,
            IntensityThreshold, OmegaWingHW, GammaL, HITRAN_units, LineShift,
            File, Format, OmegaGrid, WavenumberRange, WavenumberStep,
            WavenumberWing, WavenumberWingHW, WavenumberGrid, Diluent,
            EnvDependences)

    driver.__name__ = hapi_name
    driver.__doc__ = (
        f"hapi ``{hapi_name}`` (``misc/hapi.py:{ref_line}``): absorption "
        f"coefficient on a uniform grid using the {profile} profile, "
        f"hapi argument conventions and defaults, the reference engine on "
        f"the table's device underneath (float64 accumulation). Returns "
        f"(Wavenum, Xsect) as host NumPy arrays.")
    return driver


absorptionCoefficient_Voigt = _make_driver("voigt", "absorptionCoefficient_Voigt", 10906)
absorptionCoefficient_SDVoigt = _make_driver("sdvoigt", "absorptionCoefficient_SDVoigt", 10657)
absorptionCoefficient_Lorentz = _make_driver("lorentz", "absorptionCoefficient_Lorentz", 11144)
absorptionCoefficient_Doppler = _make_driver("doppler", "absorptionCoefficient_Doppler", 11384)
absorptionCoefficient_HT = _make_driver("ht", "absorptionCoefficient_HT", 10302)

#: hapi alias (``misc/hapi.py:11560``)
absorptionCoefficient_Gauss = absorptionCoefficient_Doppler


def _abscoef_alias(driver, hapi_name, ref_line):
    """Legacy ``abscoef*`` shortcut (hapi ``misc/hapi.py:11563-11578``):
    positional (table, step, grid, env, file) -> keyword driver call."""

    def alias(table=None, step=None, grid=None, env=None, file=None):
        return driver(SourceTables=table, OmegaStep=step, OmegaGrid=grid,
                      Environment=env if env is not None
                      else {"T": 296.0, "p": 1.0},
                      File=file)

    alias.__name__ = hapi_name
    alias.__doc__ = (f"Legacy shortcut for ``{driver.__name__}`` "
                     f"(hapi ``{hapi_name}``, ``misc/hapi.py:{ref_line}``).")
    return alias


abscoef_HT = _abscoef_alias(absorptionCoefficient_HT, "abscoef_HT", 11563)
abscoef_Voigt = _abscoef_alias(absorptionCoefficient_Voigt, "abscoef_Voigt",
                               11566)
abscoef_Lorentz = _abscoef_alias(absorptionCoefficient_Lorentz,
                                 "abscoef_Lorentz", 11569)
abscoef_Doppler = _abscoef_alias(absorptionCoefficient_Doppler,
                                 "abscoef_Doppler", 11572)
abscoef_Gauss = abscoef_Doppler  # hapi ``misc/hapi.py:11575``
#: hapi's bare ``abscoef`` default is the LORENTZ driver (``:11577``)
abscoef = _abscoef_alias(absorptionCoefficient_Lorentz, "abscoef", 11577)


def read_hotw(filename):
    """Read a two-column (nu, coef) cross-section text file as fetched from
    HITRAN-on-the-Web (hapi ``read_hotw``, ``misc/hapi.py:11711``); lines
    that do not parse as two floats are skipped, as there."""
    nu, coef = [], []
    with open(filename) as f:
        for line in f:
            parts = line.split()
            try:
                v, c = float(parts[0]), float(parts[1])
            except (ValueError, IndexError):
                continue
            nu.append(v)
            coef.append(c)
    return np.asarray(nu), np.asarray(coef)


#: hapi backwards-compatibility alias (``misc/hapi.py:11734``)
read_xsect = read_hotw


# ===========================================================================
# Spectra + slit convolution (misc/hapi.py:11582-11900), computed on the
# device of the coefficient (a tensor's, else the database's or the card),
# returned as NumPy
# ===========================================================================

def _spectrum(fn, Omegas, AbsorptionCoefficient, File, Format, **kw):
    dev = _work_device(AbsorptionCoefficient, Omegas)
    out = as_numpy(fn(_on(dev, Omegas), _on(dev, AbsorptionCoefficient),
                      **kw))
    if File:
        save_to_file(File, Format, as_numpy(Omegas), out)
    return as_numpy(Omegas), out


def transmittanceSpectrum(Omegas, AbsorptionCoefficient, Environment=None,
                          File=None, Format="%e %e", Wavenumber=None):
    """Beer-Lambert transmittance (hapi ``transmittanceSpectrum``,
    ``misc/hapi.py:11582``)."""
    if Wavenumber is not None:
        Omegas = Wavenumber
    path = float((Environment or {}).get("l", 100.0))
    return _spectrum(_spec.transmittance_spectrum, Omegas,
                     AbsorptionCoefficient, File, Format, path_cm=path)


def absorptionSpectrum(Omegas, AbsorptionCoefficient, Environment=None,
                       File=None, Format="%e %e", Wavenumber=None):
    """hapi ``absorptionSpectrum`` (``misc/hapi.py:11613``)."""
    if Wavenumber is not None:
        Omegas = Wavenumber
    path = float((Environment or {}).get("l", 100.0))
    return _spectrum(_spec.absorption_spectrum, Omegas,
                     AbsorptionCoefficient, File, Format, path_cm=path)


def radianceSpectrum(Omegas, AbsorptionCoefficient, Environment=None,
                     File=None, Format="%e %e", Wavenumber=None):
    """Single-temperature radiance [W/sr/cm^2/cm^-1]
    (hapi ``radianceSpectrum``, ``misc/hapi.py:11644``)."""
    if Wavenumber is not None:
        Omegas = Wavenumber
    env = {"l": 100.0, "T": 296.0}
    env.update(Environment or {})
    return _spectrum(_spec.radiance_spectrum, Omegas, AbsorptionCoefficient,
                     File, Format, path_cm=float(env["l"]),
                     T=float(env["T"]))


SLIT_RECTANGULAR = _spec.HAPI_SLITS["rectangular"]
SLIT_TRIANGULAR = _spec.HAPI_SLITS["triangular"]
SLIT_GAUSSIAN = _spec.HAPI_SLITS["gaussian"]
SLIT_DISPERSION = _spec.HAPI_SLITS["dispersion"]
SLIT_COSINUS = _spec.HAPI_SLITS["cosinus"]
SLIT_DIFFRACTION = _spec.HAPI_SLITS["diffraction"]
SLIT_MICHELSON = _spec.HAPI_SLITS["michelson"]


def convolveSpectrum(Omega, CrossSection, Resolution=0.1, AF_wing=10.0,
                     SlitFunction=SLIT_RECTANGULAR, Wavenumber=None,
                     CrossSectionV=None):
    """Slit convolution, edge-trimmed (hapi ``convolveSpectrum``,
    ``misc/hapi.py:11826``). Returns (omega, y, i_low, i_high, slit)."""
    if Wavenumber is not None:
        Omega = Wavenumber
    if CrossSectionV is not None:
        CrossSection = CrossSectionV
    dev = _work_device(CrossSection)
    om, y, i1, i2, slit = _spec.convolve_spectrum(
        Omega, _on(dev, CrossSection), resolution=Resolution,
        af_wing=AF_wing, slit=SlitFunction)
    return om, as_numpy(y), i1, i2, np.asarray(slit)


def _convolve_mode(Omega, CrossSection, Resolution, AF_wing, SlitFunction,
                   mode):
    Omega = as_numpy(Omega).astype(np.float64)
    dev = _work_device(CrossSection)
    y = _on(dev, CrossSection).to(torch.float64)
    step = float(Omega[1] - Omega[0])
    x = arange_(-AF_wing, AF_wing + step, step)
    w = np.asarray(SlitFunction(x, Resolution), dtype=np.float64)
    w = w / (w.sum() * step)
    return Omega, as_numpy(_spec.convolve_1d(y, w, mode) * step), w


def convolveSpectrumSame(Omega, CrossSection, Resolution=0.1, AF_wing=10.0,
                         SlitFunction=SLIT_RECTANGULAR):
    """'same'-mode slit convolution, no trim (hapi ``convolveSpectrumSame``,
    ``misc/hapi.py:11868``)."""
    Omega, y, w = _convolve_mode(Omega, CrossSection, Resolution, AF_wing,
                                 SlitFunction, "same")
    return Omega, y, 0, len(Omega), w


def convolveSpectrumFull(Omega, CrossSection, Resolution=0.1, AF_wing=10.0,
                         SlitFunction=SLIT_RECTANGULAR):
    """'full'-mode slit convolution (hapi ``convolveSpectrumFull``,
    ``misc/hapi.py:11886``)."""
    Omega, y, w = _convolve_mode(Omega, CrossSection, Resolution, AF_wing,
                                 SlitFunction, "full")
    return Omega, y, None, None, w


def getHelp(arg=None):
    """hapi-style interactive help (``misc/hapi.py:4987``)."""
    from .utils.help import get_help

    get_help(arg)


# ===========================================================================
# Remaining documented hapi surface: table aliases, the filter/selectInto
# verbs, the TIPS internals, the bare HTP profile, and the tutorial printers
# (misc/hapi.py:2313,2526,3216,5186,5311,9568,9850,3519-4006)
# ===========================================================================

def getTableList():
    """hapi ``getTableList`` (``misc/hapi.py:2313``) — same as
    :func:`tableList`."""
    return tableList()


def describe(TableName):
    """hapi ``describe`` (``misc/hapi.py:5186``) — same summary as
    :func:`describeTable`."""
    describeTable(TableName)


def length(TableName):
    """Row count of a table (hapi ``length``, ``misc/hapi.py:2557``)."""
    return _get_table(TableName).n_lines


def filter(TableName, Conditions):  # noqa: A001 — hapi's own name
    """hapi ``filter`` (``misc/hapi.py:3216``): ``select`` with output
    suppressed, result into the buffer table."""
    select(TableName=TableName, Conditions=Conditions, Output=False)


def selectInto(DestinationTableName, TableName, ParameterNames, Conditions):
    """hapi ``selectInto`` (``misc/hapi.py:2526``): select into a named
    destination table, **appending** if it already exists (hapi does
    ``number_of_rows += row_count``, ``:2555``).

    Divergences: tables are fixed-schema :class:`LineStore` columns, so
    ``ParameterNames`` does not project columns (all line-parameter columns
    are kept), and rows stay nu-sorted (a stable sort) rather than in
    insertion order.
    """
    store = _get_table(TableName)
    out = _query.select(store, Conditions) if Conditions is not None else store
    if DestinationTableName in _TABLES:
        prev = _TABLES[DestinationTableName]
        cat = {k: np.concatenate([prev.host[k], out.host[k]])
               for k in prev.host}
        order = np.argsort(cat["nu0"], kind="stable")
        out = LineStore.from_numpy(**{k: v[order] for k, v in cat.items()},
                                   device=prev.sw.device,
                                   dtype=prev.sw.dtype)
    _register(DestinationTableName, out)
    return out


def AtoB(aa, A, B, npt):
    """Lagrange 3-/4-point interpolation of the tabulated map A -> B at
    ``aa`` (hapi ``AtoB``, ``misc/hapi.py:5311``; the TIPS-2011
    interpolator): 3-point at the table edges (I < 3 or I == npt), 4-point
    in the interior. Vectorized over ``aa``, host NumPy."""
    A = as_numpy(A, np.float64)[:npt]
    B = as_numpy(B, np.float64)[:npt]
    scalar = np.ndim(aa) == 0
    aa = np.atleast_1d(as_numpy(aa, np.float64))
    i = np.searchsorted(A, aa, side="left") + 1          # hapi's 1-based I
    edge = (i < 3) | (i >= npt)
    j3 = np.clip(i, 3, npt) - 1                          # 3-point J (0-based)
    x0, x1, x2 = A[j3 - 2], A[j3 - 1], A[j3]
    bb3 = (B[j3 - 2] * (aa - x1) * (aa - x2) / ((x0 - x1) * (x0 - x2))
           + B[j3 - 1] * (aa - x0) * (aa - x2) / ((x1 - x0) * (x1 - x2))
           + B[j3] * (aa - x0) * (aa - x1) / ((x2 - x0) * (x2 - x1)))
    j4 = np.clip(i, 3, npt - 1) - 1                      # 4-point J (0-based)
    xs = [A[j4 - 2], A[j4 - 1], A[j4], A[j4 + 1]]
    ys = [B[j4 - 2], B[j4 - 1], B[j4], B[j4 + 1]]
    bb4 = np.zeros_like(aa)
    for k in range(4):
        term = ys[k]
        for m in range(4):
            if m != k:
                term = term * (aa - xs[m]) / (xs[k] - xs[m])
        bb4 = bb4 + term
    bb = np.where(edge, bb3, bb4)
    return float(bb[0]) if scalar else bb


def BD_TIPS_2011_PYTHON(M, I, T):
    """TIPS-2011 (gi, Q(T)) for one isotopologue (hapi
    ``BD_TIPS_2011_PYTHON``, ``misc/hapi.py:9568``), with its 70-3000 K
    range check."""
    T = float(T)
    if T < 70.0 or T > 3000.0:
        raise Exception("TIPS: T must be between 70K and 3000K.")
    try:
        row = _tips.iso_row_index()[(int(M), int(I))]
    except KeyError:
        # hapi's diagnostic for unknown isotopologues (misc/hapi.py:9579-9580)
        raise Exception("TIPS: no data for M,I = %d,%d." % (int(M), int(I)))
    _m, _i, gsi, q = _tips.load_tips_tables()
    return float(gsi[row]), PYTIPS(M, I, T)


def pcqsdhc(sg0, GamD, Gam0, Gam2, Shift0, Shift2, anuVC, eta, sg):
    """The bare pCqSDHC profile -> (Re, Im) (hapi ``pcqsdhc``,
    ``misc/hapi.py:9850``); same as :func:`PROFILE_HT`."""
    return _profile(_htp.pcqsdhc, sg0, GamD, Gam0, Gam2, Shift0, Shift2,
                    anuVC, eta, sg)


def _print_help_section(title, names):
    print(title)
    print("-" * len(title))
    for n in names:
        print(f"  {n}")
    print("Use getHelp(<name>) for details.")


def print_profiles():
    """Profile overview (hapi ``print_profiles``, ``misc/hapi.py:3519``)."""
    _print_help_section(
        "Line-shape profiles (PyTorch, on the card or the CPU):",
        ["PROFILE_HT", "PROFILE_SDRAUTIAN", "PROFILE_RAUTIAN",
         "PROFILE_SDVOIGT", "PROFILE_VOIGT", "PROFILE_LORENTZ",
         "PROFILE_DOPPLER", "pcqsdhc"])


def print_slit_functions():
    """Slit-function overview (hapi ``print_slit_functions``)."""
    _print_help_section(
        "Instrument slit functions (for convolveSpectrum):",
        ["SLIT_RECTANGULAR", "SLIT_TRIANGULAR", "SLIT_GAUSSIAN",
         "SLIT_DISPERSION", "SLIT_COSINUS", "SLIT_DIFFRACTION",
         "SLIT_MICHELSON"])


def print_data_tutorial():
    """Database-layer overview (hapi ``print_data_tutorial``)."""
    _print_help_section(
        "Local database verbs (directory of .data/.header/.par tables):",
        ["db_begin", "db_commit", "fetch", "fetch_by_ids", "tableList",
         "describeTable", "select", "selectInto", "filter", "sort", "group",
         "getColumn", "getColumns", "extractColumns", "dropTable",
         "save_to_file"])


def print_spectra_tutorial():
    """Spectra-layer overview (hapi ``print_spectra_tutorial``)."""
    _print_help_section(
        "Absorption/spectra pipeline:",
        ["absorptionCoefficient_Voigt (and _SDVoigt/_HT/_Lorentz/_Doppler)",
         "transmittanceSpectrum", "absorptionSpectrum", "radianceSpectrum",
         "convolveSpectrum", "getStickXY"])


def print_plotting_tutorial():
    """Plotting pointer (hapi ``print_plotting_tutorial``)."""
    print("Plot with matplotlib: nu, k = absorptionCoefficient_Voigt(...);\n"
          "plt.plot(nu, k). getStickXY(table) gives stick-spectrum polylines.")


def print_python_tutorial():
    """Python pointer (hapi ``print_python_tutorial``)."""
    print("All functions return numpy arrays; the engines underneath are\n"
          "PyTorch, on the card unless db_begin(dir, device='cpu') or CPU\n"
          "tensors ask for the CPU. See MIGRATION.md for the native API.")
