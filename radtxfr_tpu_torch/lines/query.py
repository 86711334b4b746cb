"""Condition-expression queries over a :class:`LineStore` (counterpart of
``radtxfr_tpu/lines/query.py``).

hapi's Lisp-ish tuple condition DSL and SQL-ish verbs
(``select``/``filter``/``sort``/``group``/``extractColumns`` —
``misc/hapi.py:1780-2815``), applied to packed columns instead of per-row
Python objects. The same expression trees work:

    select(store, ("and", ("between", "nu", 690, 1410),
                          ("==", "molec_id", 1)))

The full reference operator set is supported (aliases included, cf. the
``OPERATORS`` table ``misc/hapi.py:1998-2066``): LIST, AND/&/&&, OR/|/||,
NOT/!, RANGE/BETWEEN, IN/SUBSET, </LESS/LT, >/MORE/MT, <=/LESSOREQUAL/LTE,
>=/MOREOREQUAL/MTE, =/==/EQ/EQUAL/EQUALS, !=/<>/~=/NE/NOTEQUAL, +/SUM,
-/DIFF, */MUL, //DIV, STR/STRING, SET, MATCH/LIKE, SEARCH, FINDALL — all
vectorized over the line axis (hapi evaluates per row,
``evaluateExpression`` ``misc/hapi.py:2144``).

The expressions are evaluated in host NumPy over the store's float64 host
columns (``LineStore.host``; a tensor column of a dict source is copied to
the host); ``select`` and ``sort`` return LineStores on the store's device
in its dtype. Group aggregation (hapi ``group`` + ``GROUP_FUNCTION_NAMES``,
``misc/hapi.py:1927-1995,2731``) is one pass of sorted-segment reductions:
``group(store, by=..., aggregates={...})`` with the COUNT/SUM/AVG/MIN/MAX/
MUL/SSQ reducers.
"""

from __future__ import annotations

import re

import numpy as np

from .. import as_numpy
from .store import LineStore

__all__ = [
    "evaluate", "select", "filter_mask", "sort", "group", "extract_columns",
    "stick_xy", "GROUP_FUNCTIONS",
]

#: LineStore column aliases matching hapi parameter names
_ALIASES = {
    "nu": "nu0",
    "sw": "sw",
    "elower": "elower",
    "gamma_air": "gamma_air",
    "gamma_self": "gamma_self",
    "n_air": "n_air",
    "delta_air": "delta_air",
    "molec_id": "mol_id",
    "sd_air": "sd_air",
}


def _col(source, name: str) -> np.ndarray:
    """Resolve a column by name from a LineStore (its float64/int64 host
    columns) or a {name: array or tensor} dict."""
    if isinstance(source, dict):
        if name in source:
            v = source[name]
            return as_numpy(v) if not isinstance(v, list) else np.asarray(v)
        raise KeyError(f"unknown column {name!r}")
    key = _ALIASES.get(name, name)
    if key in source.host:
        return source.host[key]
    if hasattr(source, name):
        return as_numpy(getattr(source, name))
    raise KeyError(f"unknown column {name!r}")


def _chain(args, cmp):
    """hapi's many-arg comparisons hold pairwise along the chain
    (operationLESS et al., misc/hapi.py:1807-1841)."""
    out = cmp(args[0], args[1])
    for a, b in zip(args[1:-1], args[2:]):
        out = out & cmp(a, b)
    return out


def evaluate(source, expr):
    """Evaluate a condition/arithmetic expression -> per-line NumPy array.

    ``source`` is a :class:`LineStore` or a ``{name: column}`` dict (as
    returned by :func:`~.hapi_db.load_table_columns`).
    """
    if isinstance(expr, str):
        return _col(source, expr)
    if isinstance(expr, (int, float, np.number)):
        return expr
    if not isinstance(expr, (tuple, list)) or not expr:
        raise ValueError(f"bad expression: {expr!r}")
    op, *args = expr
    op = str(op).upper()
    # String/set literals take unevaluated arguments (hapi STR/SET special
    # cases, misc/hapi.py:2152-2156).
    if op in ("STR", "STRING"):
        return str(args[0])
    if op == "SET":
        return list(args[0])
    ev = lambda e: evaluate(source, e)
    if op in ("IN", "SUBSET"):
        # the membership list may be a literal tuple/list of values
        # (hapi also accepts ('LIST', ...) / ('SET', ...) forms)
        rhs = args[1]
        if isinstance(rhs, (tuple, list)) and not (
                rhs and isinstance(rhs[0], str)):
            return np.isin(np.asarray(ev(args[0])), np.asarray(rhs))
    vals = [ev(a) for a in args]
    if op == "LIST":
        return list(vals)
    if op in ("AND", "&", "&&"):
        out = np.asarray(vals[0], dtype=bool)
        for v in vals[1:]:
            out = out & np.asarray(v, dtype=bool)
        return out
    if op in ("OR", "|", "||"):
        out = np.asarray(vals[0], dtype=bool)
        for v in vals[1:]:
            out = out | np.asarray(v, dtype=bool)
        return out
    if op in ("NOT", "!"):
        return ~np.asarray(vals[0], dtype=bool)
    if op in ("RANGE", "BETWEEN"):
        x = np.asarray(vals[0])
        return (x >= vals[1]) & (x <= vals[2])
    if op in ("IN", "SUBSET"):
        return np.isin(np.asarray(vals[0]), np.asarray(vals[1]))
    if op in ("<", "LESS", "LT"):
        return _chain(vals, np.less)
    if op in (">", "MORE", "MT"):
        return _chain(vals, np.greater)
    if op in ("<=", "LESSOREQUAL", "LTE"):
        return _chain(vals, np.less_equal)
    if op in (">=", "MOREOREQUAL", "MTE"):
        return _chain(vals, np.greater_equal)
    if op in ("=", "==", "EQ", "EQUAL", "EQUALS"):
        return _chain(vals, np.equal)
    if op in ("!=", "<>", "~=", "NE", "NOTEQUAL"):
        return np.not_equal(vals[0], vals[1])
    if op in ("+", "SUM"):
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out
    if op in ("-", "DIFF"):
        return np.subtract(vals[0], vals[1]) if len(vals) > 1 else -np.asarray(vals[0])
    if op in ("*", "MUL"):
        out = vals[0]
        for v in vals[1:]:
            out = out * v
        return out
    if op in ("/", "DIV"):
        return np.divide(vals[0], vals[1])
    if op == "ABS":
        return np.abs(vals[0])
    # Regex operations apply elementwise over string columns (hapi
    # operationMATCH/SEARCH/FINDALL, misc/hapi.py:1885-1908).
    if op in ("MATCH", "LIKE"):
        pat = str(vals[0])
        rx = re.compile(pat)
        return np.array([bool(rx.match(str(s))) for s in np.atleast_1d(vals[1])])
    if op == "SEARCH":
        pat = str(vals[0])
        rx = re.compile(pat)
        return np.array([bool(rx.search(str(s))) for s in np.atleast_1d(vals[1])])
    if op == "FINDALL":
        pat = str(vals[0])
        rx = re.compile(pat)
        return [rx.findall(str(s)) for s in np.atleast_1d(vals[1])]
    raise ValueError(f"unknown operation {op!r}")


def filter_mask(source, conditions) -> np.ndarray:
    """Boolean per-line mask for a condition expression (hapi ``filter``,
    ``misc/hapi.py:3216`` — which prints matches; here the mask is data)."""
    mask = evaluate(source, conditions)
    n = len(_col(source, "nu") if not isinstance(source, dict) else
            next(iter(source.values())))
    return np.broadcast_to(np.asarray(mask, dtype=bool), (n,)).copy()


def select(store: LineStore, conditions) -> LineStore:
    """Rows matching a boolean condition expression (hapi ``select``), on
    the store's device in its dtype."""
    mask = filter_mask(store, conditions)
    return store.subset(np.nonzero(mask)[0])


def sort(store: LineStore, by="nu", descending: bool = False) -> LineStore:
    """Rows reordered by column(s) (hapi ``sort``, quickSort
    ``misc/hapi.py:2655-2729``). ``by`` may be one column name or a
    sequence — multi-key sorts are lexicographic, first name most
    significant (hapi's tuple comparator ``compareLESS`` semantics)."""
    names = [by] if isinstance(by, str) else list(by)
    # np.lexsort: LAST key is primary, so reverse
    keys = [np.asarray(_col(store, n)) for n in reversed(names)]
    order = np.lexsort(keys)
    if descending:
        order = order[::-1]
    # the only LineStore not sorted by nu0, as the JAX one
    return store.subset(order, require_sorted=False)


def _seg_reduce(vals: np.ndarray, inv: np.ndarray, n_groups: int, how: str):
    """Segment reduction of ``vals`` grouped by inverse index ``inv``."""
    if how == "COUNT":
        return np.bincount(inv, minlength=n_groups)
    if how == "SUM":
        return np.bincount(inv, weights=vals, minlength=n_groups)
    if how == "AVG":
        s = np.bincount(inv, weights=vals, minlength=n_groups)
        c = np.maximum(np.bincount(inv, minlength=n_groups), 1)
        return s / c
    if how == "SSQ":
        return np.bincount(inv, weights=vals * vals, minlength=n_groups)
    if how == "MUL":
        out = np.ones(n_groups, dtype=np.asarray(vals).dtype)
        np.multiply.at(out, inv, vals)
        return out
    if how == "MIN":
        out = np.full(n_groups, np.inf)
        np.minimum.at(out, inv, vals)
        return out
    if how == "MAX":
        out = np.full(n_groups, -np.inf)
        np.maximum.at(out, inv, vals)
        return out
    raise ValueError(f"unknown group function {how!r}")


#: hapi GROUP_FUNCTION_NAMES (misc/hapi.py:1927-1940)
GROUP_FUNCTIONS = ("COUNT", "SUM", "MUL", "AVG", "MIN", "MAX", "SSQ")


def group(source, by, aggregates) -> dict:
    """Group-by with aggregation (hapi ``group``, ``misc/hapi.py:2731``).

    Parameters
    ----------
    source : LineStore or {name: column} dict
    by : str or sequence of str — grouping key column(s)
    aggregates : {out_name: (FUNC, expr)} with FUNC in :data:`GROUP_FUNCTIONS`
        and ``expr`` any :func:`evaluate` expression (ignored for COUNT).

    Returns ``{key_name: key_values, out_name: aggregated_values}`` with one
    entry per distinct key, keys in sorted order.
    """
    keys = [by] if isinstance(by, str) else list(by)
    key_cols = [np.asarray(_col(source, k)) for k in keys]
    stacked = np.rec.fromarrays(key_cols, names=[f"k{i}" for i in range(len(keys))])
    uniq, inv = np.unique(stacked, return_inverse=True)
    n_groups = len(uniq)
    n_rows = len(key_cols[0])
    out = {k: np.asarray(uniq[f"k{i}"]) for i, k in enumerate(keys)}
    for name, (how, expr) in aggregates.items():
        how = str(how).upper()
        if how == "COUNT":
            vals = np.ones(n_rows)
        else:
            vals = np.broadcast_to(np.asarray(evaluate(source, expr), dtype=float),
                                   (n_rows,))
        out[name] = _seg_reduce(vals, inv, n_groups, how)
    return out


def extract_columns(table: dict, source_name: str, formats, names,
                    fix_col: bool = False) -> dict:
    """Split a string column into typed columns (hapi ``extractColumns``,
    ``misc/hapi.py:2815``).

    ``formats`` are C-style specs (``'%5d'``, ``'%12.6f'``, ``'%10s'``)
    applied left-to-right to each row string; with ``fix_col`` the widths
    are taken from the specs (fixed-column mode), otherwise the row is
    whitespace-split. Adds the new columns to (a copy of) ``table``.
    """
    from .hapi_db import parse_format

    specs = [parse_format(f) for f in formats]
    rows = [str(s) for s in table[source_name]]
    cols: list[list] = [[] for _ in names]
    for row in rows:
        if fix_col:
            pos = 0
            for j, (width, conv) in enumerate(specs):
                cols[j].append(conv(row[pos:pos + width]))
                pos += width
        else:
            pieces = row.split()
            for j, (_, conv) in enumerate(specs):
                cols[j].append(conv(pieces[j]) if j < len(pieces) else conv(""))
    out = dict(table)
    for name, vals in zip(names, cols):
        out[name] = (np.asarray(vals)
                     if vals and isinstance(vals[0], (int, float)) else vals)
    return out


def stick_xy(store: LineStore):
    """(X, Y) polyline tracing a stick spectrum (hapi ``getStickXY``,
    ``misc/hapi.py:11684`` — its per-line loop vectorized to a repeat +
    masked write), host NumPy."""
    cent = _col(store, "nu").astype(np.float64)
    intens = _col(store, "sw").astype(np.float64)
    x = np.repeat(cent, 3)
    y = np.zeros_like(x)
    y[1::3] = intens
    return x, y
