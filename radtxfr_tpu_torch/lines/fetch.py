"""HITRAN online fetch, hapi ``fetch``/``fetch_by_ids`` (counterpart of
``radtxfr_tpu/lines/fetch.py``).

Builds the same ``/lbl/api`` query URLs as the reference (``queryHITRAN``,
``misc/hapi.py:3118-3168``) and parses the returned ``.par``-formatted
payload into a :class:`LineStore` (on the card unless asked otherwise,
float64). Network access is optional and failure-isolated: without it the
URL builder and the payload parser still work, and the download raises a
``ConnectionError`` that names the offline loaders.
"""

from __future__ import annotations

import functools
import os
import urllib.parse
import urllib.request

import numpy as np
import torch

from .. import DATA_DIR
from .store import from_arrays, parse_par
from .tips import load_tips_tables

__all__ = ["build_query_url", "fetch_by_ids", "fetch", "PARAMETER_GROUPS",
           "prepare_parlist", "parse_custom_payload"]

HITRAN_HOST = "http://hitran.org"

# ---------------------------------------------------------------------------
# Extended-parameter request machinery (hapi ParameterGroups/Parameters,
# ``misc/hapi.py:2970-3090``). The group names and member parameter names
# are the hitran.org lbl/api protocol vocabulary (unavoidable constants).
# ---------------------------------------------------------------------------

def _merge(*lists):
    out, seen = [], set()
    for ls in lists:
        for p in ls:
            if p not in seen:
                seen.add(p)
                out.append(p)
    return out


_PARLIST_DOTPAR = ["par_line"]
_PARLIST_ID = ["trans_id"]
_PARLIST_STANDARD = ["molec_id", "local_iso_id", "nu", "sw", "a", "elower",
                     "gamma_air", "delta_air", "gamma_self", "n_air",
                     "n_self", "gp", "gpp"]
_PARLIST_LABELS = ["statep", "statepp"]
_PARLIST_LINEMIXING = ["y_air", "y_self"]
_PARLIST_VOIGT_AIR = ["gamma_air", "delta_air", "deltap_air", "n_air"]
_PARLIST_VOIGT_SELF = ["gamma_self", "delta_self", "deltap_self", "n_self"]
_PARLIST_VOIGT_H2 = ["gamma_H2", "delta_H2", "deltap_H2", "n_H2"]
_PARLIST_VOIGT_CO2 = ["gamma_CO2", "delta_CO2", "n_CO2"]
_PARLIST_VOIGT_HE = ["gamma_He", "delta_He", "n_He"]
_PARLIST_VOIGT_ALL = _merge(_PARLIST_VOIGT_AIR, _PARLIST_VOIGT_SELF,
                            _PARLIST_VOIGT_H2, _PARLIST_VOIGT_CO2,
                            _PARLIST_VOIGT_HE)
_PARLIST_SDVOIGT_AIR = ["gamma_air", "delta_air", "deltap_air", "n_air",
                        "SD_air"]
_PARLIST_SDVOIGT_SELF = ["gamma_self", "delta_self", "deltap_self", "n_self",
                         "SD_self"]
_PARLIST_SDVOIGT_ALL = _merge(_PARLIST_SDVOIGT_AIR, _PARLIST_SDVOIGT_SELF)
_PARLIST_GALATRY_AIR = ["gamma_air", "delta_air", "deltap_air", "n_air",
                        "beta_g_air"]
_PARLIST_GALATRY_SELF = ["gamma_self", "delta_self", "deltap_self", "n_self",
                         "beta_g_self"]
_PARLIST_GALATRY_ALL = _merge(_PARLIST_GALATRY_AIR, _PARLIST_GALATRY_SELF)
_PARLIST_HT_SELF = [
    f"{base}_self_{T}" for T in (50, 150, 296, 700)
    for base in ("gamma_HT_0", "n_HT", "gamma_HT_2", "delta_HT_0",
                 "deltap_HT", "delta_HT_2")
] + ["nu_HT_self", "kappa_HT_self", "eta_HT_self"]
_PARLIST_HT_AIR = ["gamma_HT_0_air_296", "n_HT_air_296", "gamma_HT_2_air_296",
                   "delta_HT_0_air_296", "deltap_HT_air_296",
                   "delta_HT_2_air_296", "nu_HT_air", "kappa_HT_air",
                   "eta_HT_air"]
_PARLIST_HT_ALL = _merge(_PARLIST_HT_SELF, _PARLIST_HT_AIR)
_PARLIST_ALL = _merge(_PARLIST_ID, _PARLIST_DOTPAR, _PARLIST_STANDARD,
                      _PARLIST_LABELS, _PARLIST_LINEMIXING,
                      _PARLIST_VOIGT_ALL, _PARLIST_SDVOIGT_ALL,
                      _PARLIST_GALATRY_ALL, _PARLIST_HT_ALL)

#: hapi ``PARAMETER_GROUPS`` (``misc/hapi.py:3032-3062``)
PARAMETER_GROUPS = {
    "par_line": _PARLIST_DOTPAR, "160-char": _PARLIST_DOTPAR,
    ".par": _PARLIST_DOTPAR,
    "id": _PARLIST_ID, "standard": _PARLIST_STANDARD,
    "labels": _PARLIST_LABELS, "linemixing": _PARLIST_LINEMIXING,
    "voigt_air": _PARLIST_VOIGT_AIR, "voigt_self": _PARLIST_VOIGT_SELF,
    "voigt_h2": _PARLIST_VOIGT_H2, "voigt_co2": _PARLIST_VOIGT_CO2,
    "voigt_he": _PARLIST_VOIGT_HE, "voigt": _PARLIST_VOIGT_ALL,
    "sdvoigt_air": _PARLIST_SDVOIGT_AIR,
    "sdvoigt_self": _PARLIST_SDVOIGT_SELF,
    "sdvoigt": _PARLIST_SDVOIGT_ALL,
    "galatry_air": _PARLIST_GALATRY_AIR,
    "galatry_self": _PARLIST_GALATRY_SELF,
    "galatry": _PARLIST_GALATRY_ALL,
    "ht": _PARLIST_HT_ALL, "all": _PARLIST_ALL,
}

#: parameters already carried by the 160-char ``.par`` record
#: (``HITRAN_DEFAULT_HEADER['format']``, ``misc/hapi.py:492-533``)
_DOTPAR_ASSUMED = frozenset({
    "molec_id", "local_iso_id", "nu", "sw", "a", "gamma_air", "gamma_self",
    "elower", "n_air", "delta_air", "global_upper_quanta",
    "global_lower_quanta", "local_upper_quanta", "local_lower_quanta",
    "ierr", "iref", "line_mixing_flag", "gp", "gpp",
})


def prepare_parlist(pargroups=(), params=(), dotpar: bool = True) -> list[str]:
    """The reference's request-parameter list assembly (``prepareParlist``,
    ``misc/hapi.py:3063-3092``): par_line default, group expansion (names
    case-insensitive), single params lowercased, deduplicated in order,
    minus parameters the ``.par`` record already carries."""
    parlist = list(_PARLIST_DOTPAR) if dotpar else []
    for g in pargroups:
        parlist += PARAMETER_GROUPS[g.lower()]
    parlist += [p.lower() for p in params]
    parlist = _merge(parlist)
    if dotpar:
        # only the .par branch assumes columns (misc/hapi.py:3070-3074)
        return [p for p in parlist
                if p == "par_line" or p not in _DOTPAR_ASSUMED]
    return parlist


@functools.lru_cache(maxsize=1)
def _registry_lut():
    with np.load(os.path.join(DATA_DIR, "iso_registry.npz")) as f:
        return {(int(m), int(i)): int(g)
                for m, i, g in zip(f["mol"], f["iso"], f["global_id"])}


def _global_ids(mol_id: int, iso_ids) -> list[int]:
    """Map (molecule, local iso) to HITRAN global isotopologue ids."""
    lut = _registry_lut()
    return [lut[(mol_id, int(i))] for i in iso_ids]


def build_query_url(global_iso_ids, nu_min: float, nu_max: float,
                    host: str = HITRAN_HOST, pargroups=(), params=(),
                    head: bool = False) -> str:
    """The reference's lbl/api GET URL (``misc/hapi.py:3130-3144``)."""
    iso_str = ",".join(str(int(i)) for i in global_iso_ids)
    if pargroups or params:
        # custom par search (misc/hapi.py:3130-3135): comma-separated rows
        # with request_params columns appended after the 160-char record
        parlist = prepare_parlist(pargroups, params)
        return (f"{host}/lbl/api?iso_ids_list={iso_str}"
                f"&numin={float(nu_min)}&numax={float(nu_max)}"
                f"&head={head}&fixwidth=0&sep=[comma]"
                f"&request_params={','.join(parlist)}")
    # the old-fashioned .par search (misc/hapi.py:3136-3140): NO
    # head/fixwidth/sep flags — those belong to the custom request_params
    # branch and would switch the payload to comma-separated rows that the
    # fixed-column .par parser cannot read.
    qparams = {
        "iso_ids_list": iso_str,
        "numin": float(nu_min),
        "numax": float(nu_max),
    }
    return f"{host}/lbl/api?{urllib.parse.urlencode(qparams)}"


def _parse_extra(v: str):
    v = v.strip()
    if v in ("", "#"):
        return 0.0   # hapi default for absent extended parameters
    try:
        return float(v)
    except ValueError:
        return v     # label columns (statep/statepp, quanta strings)


def parse_custom_payload(text_or_lines, parlist, device=None,
                         dtype=torch.float64):
    """Parse a custom-par-search payload (``sep=[comma]`` rows) into a
    :class:`LineStore` plus extra-parameter columns.

    Each row is the 160-char ``.par`` record followed by the requested
    extra columns, comma-separated — the layout hapi's ``storage2cache``
    reads back from the downloaded ``.data`` file (``misc/hapi.py:3145``
    with the header from ``prepareHeader`` ``:3094-3116``). Returns
    ``(store, extras)`` with extras row-aligned to the nu-sorted store;
    values ``''``/``'#'`` take hapi's 0 default. If ``SD_air`` is among the
    extras it is merged into the store's ``sd_air`` column so the SD-Voigt
    engine consumes it directly. The store lands on ``device`` (None: the
    card) in ``dtype``.
    """
    if isinstance(text_or_lines, str):
        rows = text_or_lines.splitlines()
    else:
        rows = list(text_or_lines)
    rows = [r for r in rows if r.strip()]
    has_par = "par_line" in parlist
    if not has_par:
        raise ValueError(
            "custom payloads without the par_line column cannot build a "
            "LineStore; include 'par_line' (hapi dotpar=True default)")
    extra_names = [p for p in parlist if p != "par_line"]
    par_rows, extra_vals = [], {k: [] for k in extra_names}
    for r in rows:
        par, _, rest = r.partition(",")
        par_rows.append(par)
        vals = rest.split(",") if extra_names else []
        for k, v in zip(extra_names, vals):
            extra_vals[k].append(_parse_extra(v))
        for k in extra_names[len(vals):]:
            extra_vals[k].append(0.0)

    # LineStore rows are nu-sorted (from_arrays); align the extras.
    nu_raw = np.array([float(r[3:15]) for r in par_rows])
    order = np.argsort(nu_raw, kind="stable")
    extras = {}
    for k, v in extra_vals.items():
        a = np.asarray(v)
        extras[k] = a[order] if a.size == order.size else a

    sd = extras.get("SD_air", extras.get("sd_air"))
    if sd is not None and np.asarray(sd).dtype != object:
        # re-parse with the SD column folded in (parse_par has no sd slot)
        h = parse_par(par_rows, device="cpu", dtype=torch.float64).host
        store = from_arrays(
            nu0=h["nu0"], sw=h["sw"], elower=h["elower"],
            gamma_air=h["gamma_air"], gamma_self=h["gamma_self"],
            n_air=h["n_air"], delta_air=h["delta_air"], mol_id=h["mol_id"],
            local_iso_id=load_tips_tables()[1][h["iso_row"]],
            sd_air=np.asarray(sd, dtype=np.float64), device=device,
            dtype=dtype)
    else:
        store = parse_par(par_rows, device=device, dtype=dtype)
    return store, extras


def fetch_by_ids(global_iso_ids, nu_min: float, nu_max: float,
                 timeout: float = 60.0, host: str = HITRAN_HOST,
                 pargroups=(), params=(), device=None, dtype=torch.float64):
    """Download lines for explicit global isotopologue ids.

    With ``pargroups``/``params`` (hapi ``ParameterGroups``/``Parameters``,
    e.g. ``pargroups=['sdvoigt']`` or ``pargroups=['ht']``) the extended
    column sets are requested and returned as ``(store, extras)``; plain
    calls return just the :class:`LineStore` (on ``device``, None: the
    card, in ``dtype``).
    """
    url = build_query_url(global_iso_ids, nu_min, nu_max, host=host,
                          pargroups=pargroups, params=params)
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            text = r.read().decode()
    except OSError as e:
        raise ConnectionError(
            f"HITRAN fetch failed ({e}); in offline environments load lines "
            f"from a .par file (lines.parse_par) or hapi table "
            f"(lines.hapi_db) instead"
        ) from e
    if pargroups or params:
        return parse_custom_payload(text, prepare_parlist(pargroups, params),
                                    device=device, dtype=dtype)
    return parse_par(text.splitlines(), device=device, dtype=dtype)


def fetch(mol_id: int, iso_ids, nu_min: float, nu_max: float, **kw):
    """hapi ``fetch`` analog: molecule number + local isotopologue list."""
    return fetch_by_ids(_global_ids(mol_id, iso_ids), nu_min, nu_max, **kw)
