"""Line database as a structure of tensors (counterpart of
``radtxfr_tpu/lines/store.py``).

:class:`LineStore` holds the HITRAN columns sorted by line centre, as
tensors on one device in one float dtype, plus float64 host copies of every
column (``host``) for static planning: the bucket plans decompose line
centres into exact (grid index, fraction) pairs in float64, which a float32
copy would quantize by ~6e-5 cm^-1 at 1000 cm^-1.

Sources: :func:`parse_par` (the HITRAN 160-character ``.par`` records,
files through the native parser of :mod:`.native_parser`) and
:func:`from_arrays`.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from .. import DATA_DIR, as_numpy, resolve_device
from .tips import iso_row_index, load_tips_tables

_FLOAT_FIELDS = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
                 "delta_air", "sd_air")
_INT_FIELDS = ("iso_row", "mol_id")


@functools.lru_cache(maxsize=1)
def _iso_registry():
    with np.load(os.path.join(DATA_DIR, "iso_registry.npz")) as f:
        return {
            (int(m), int(i)): (float(a), float(mm))
            for m, i, a, mm in zip(
                f["mol"], f["iso"], f["abundance"], f["molar_mass"]
            )
        }


@dataclasses.dataclass(frozen=True)
class IsoTables:
    """Per-isotopologue physical data, indexed by compact row id."""

    q: torch.Tensor           # (n_iso, 119) TIPS-2011 partition sums
    abundance: torch.Tensor   # (n_iso,) natural abundance
    molar_mass: torch.Tensor  # (n_iso,) [g/mol]
    mol: torch.Tensor         # (n_iso,) HITRAN molecule number
    iso: torch.Tensor         # (n_iso,) local isotopologue number

    @staticmethod
    def from_numpy(q, abundance, molar_mass, mol, iso, device=None,
                   dtype=torch.float32) -> "IsoTables":
        """Build from NumPy columns (e.g. the JAX ``IsoTables`` fields);
        ``device`` None is the card."""
        device = resolve_device(device)
        f = lambda a: torch.tensor(as_numpy(a, np.float64), dtype=dtype,
                                   device=device)
        i = lambda a: torch.tensor(as_numpy(a, np.int64), device=device)
        return IsoTables(q=f(q), abundance=f(abundance),
                         molar_mass=f(molar_mass), mol=i(mol), iso=i(iso))

    @staticmethod
    def load(dtype=torch.float32, device=None) -> "IsoTables":
        mol, iso, _gsi, q = load_tips_tables()
        reg = _iso_registry()
        miss = (np.nan, np.nan)
        return IsoTables.from_numpy(
            q=q,
            abundance=[reg.get((int(m), int(i)), miss)[0]
                       for m, i in zip(mol, iso)],
            molar_mass=[reg.get((int(m), int(i)), miss)[1]
                        for m, i in zip(mol, iso)],
            mol=mol, iso=iso, device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class LineStore:
    """Structure-of-tensors HITRAN line list, sorted by ``nu0``."""

    nu0: torch.Tensor         # (L,) line center [cm^-1]
    sw: torch.Tensor          # (L,) intensity at 296 K [cm^-1/(molec cm^-2)]
    elower: torch.Tensor      # (L,) lower-state energy [cm^-1]
    gamma_air: torch.Tensor   # (L,) air-broadened HWHM [cm^-1/atm]
    gamma_self: torch.Tensor  # (L,) self-broadened HWHM [cm^-1/atm]
    n_air: torch.Tensor       # (L,) T-exponent for gamma_air
    delta_air: torch.Tensor   # (L,) air pressure shift [cm^-1/atm]
    iso_row: torch.Tensor     # (L,) int64 index into IsoTables
    mol_id: torch.Tensor      # (L,) int64 HITRAN molecule number
    sd_air: torch.Tensor      # (L,) speed-dependence ratio Gamma2/Gamma0
    #: float64 / int64 NumPy copies of every column, for host planning
    host: dict = dataclasses.field(repr=False, compare=False,
                                   default_factory=dict)

    def __len__(self) -> int:
        return int(self.nu0.shape[0])

    @property
    def n_lines(self) -> int:
        return int(self.nu0.shape[0])

    def host_view(self) -> "LineStore":
        """A LineStore whose columns are the host NumPy copies."""
        return dataclasses.replace(self, **self.host)

    def subset(self, keep, require_sorted: bool = True) -> "LineStore":
        """The rows ``keep`` (a boolean mask or index array), on the same
        device in the same dtype, the float64 host columns kept.
        ``require_sorted=False`` allows an order other than by ``nu0`` (the
        hapi ``sort`` verb's; the engines' plans need sorted centres)."""
        return LineStore.from_numpy(
            **{k: v[keep] for k, v in self.host.items()},
            device=self.sw.device, dtype=self.sw.dtype,
            require_sorted=require_sorted)

    def select_band(self, nu_min: float, nu_max: float,
                    margin: float = 0.0) -> "LineStore":
        """The lines within [nu_min - margin, nu_max + margin]."""
        nu0 = self.host["nu0"]
        return self.subset((nu0 >= nu_min - margin)
                           & (nu0 <= nu_max + margin))

    def select_molecules(self, mol_ids) -> "LineStore":
        """The lines of the HITRAN molecules ``mol_ids``."""
        return self.subset(np.isin(self.host["mol_id"],
                                   np.asarray(list(mol_ids))))

    @staticmethod
    def from_numpy(*, nu0, sw, elower, gamma_air, gamma_self, n_air,
                   delta_air, iso_row, mol_id, sd_air, device=None,
                   dtype=torch.float32,
                   require_sorted: bool = True) -> "LineStore":
        """Build from NumPy columns already sorted by ``nu0`` (e.g. the
        fields of the JAX ``LineStore.host_view()``); ``device`` None is
        the card. Unsorted centres raise unless ``require_sorted`` is
        False."""
        device = resolve_device(device)
        host = {k: np.array(as_numpy(v), dtype=np.float64) for k, v in dict(
            nu0=nu0, sw=sw, elower=elower, gamma_air=gamma_air,
            gamma_self=gamma_self, n_air=n_air, delta_air=delta_air,
            sd_air=sd_air).items()}
        host.update(iso_row=np.array(as_numpy(iso_row), dtype=np.int64),
                    mol_id=np.array(as_numpy(mol_id), dtype=np.int64))
        if require_sorted and np.any(np.diff(host["nu0"]) < 0):
            raise ValueError("line centers must be sorted")
        cols = {k: torch.as_tensor(host[k], dtype=dtype, device=device)
                for k in _FLOAT_FIELDS}
        cols.update({k: torch.as_tensor(host[k], device=device)
                     for k in _INT_FIELDS})
        return LineStore(**cols, host=host)


def from_arrays(nu0, sw, elower, gamma_air, gamma_self, n_air, delta_air,
                mol_id, local_iso_id, sd_air=None, dtype=torch.float32,
                device=None) -> LineStore:
    """Build a sorted :class:`LineStore` from NumPy columns.

    ``mol_id``/``local_iso_id`` are HITRAN numbers, mapped to the compact
    ``iso_row`` index of :class:`IsoTables`; ``sd_air`` defaults to zero.
    """
    row_of = iso_row_index()
    nu0 = as_numpy(nu0, np.float64)
    mol_id, local_iso_id = as_numpy(mol_id), as_numpy(local_iso_id)
    order = np.argsort(nu0, kind="stable")
    iso_row = np.array([row_of[(int(m), int(i))] for m, i in
                        zip(mol_id, local_iso_id)], dtype=np.int64)
    if sd_air is None:
        sd_air = np.zeros_like(nu0)
    s = lambda a: as_numpy(a, np.float64)[order]  # noqa: E731
    return LineStore.from_numpy(
        nu0=nu0[order], sw=s(sw), elower=s(elower), gamma_air=s(gamma_air),
        gamma_self=s(gamma_self), n_air=s(n_air), delta_air=s(delta_air),
        sd_air=s(sd_air), iso_row=iso_row[order],
        mol_id=np.asarray(mol_id, dtype=np.int64)[order],
        device=device, dtype=dtype)


# The fixed columns of the 160-character HITRAN2004+ .par record,
# (start, width), as hapi's PARAMETER_META slices them
# (misc/hapi.py:583ff) and native/par_parser.cpp reads them.
_PAR_FIELDS = {
    "molec_id": (0, 2),
    "local_iso_id": (2, 1),
    "nu": (3, 12),
    "sw": (15, 10),
    "a": (25, 10),
    "gamma_air": (35, 5),
    "gamma_self": (40, 5),
    "elower": (45, 10),
    "n_air": (55, 4),
    "delta_air": (59, 8),
}

# hapi maps the local iso id '0' to 10; 'A'/'B' stand for 11/12 (as the
# C++ parser)
_ISO_CHAR = {**{str(d): d for d in range(10)}, "0": 10,
             "A": 11, "a": 11, "B": 12, "b": 12}


def parse_par(path_or_lines, dtype=torch.float32, native: bool = True,
              device=None) -> LineStore:
    """A :class:`LineStore` on ``device`` (None: the card) from a HITRAN
    ``.par`` file or a list of its 160-character records.

    A file goes through the native C++ parser
    (:func:`~.native_parser.parse_par_native`) where it can be built, else
    through the Python parser, as lists of records do.
    """
    if isinstance(path_or_lines, (str, os.PathLike)) and native:
        from .native_parser import parse_par_native

        cols = parse_par_native(str(path_or_lines))
        if cols is not None:
            return from_arrays(
                nu0=cols["nu"], sw=cols["sw"], elower=cols["elower"],
                gamma_air=cols["gamma_air"], gamma_self=cols["gamma_self"],
                n_air=cols["n_air"], delta_air=cols["delta_air"],
                mol_id=cols["mol"], local_iso_id=cols["iso"],
                device=device, dtype=dtype)
    if isinstance(path_or_lines, (str, os.PathLike)):
        with open(path_or_lines) as f:
            records = f.read().splitlines()
    else:
        records = list(path_or_lines)
    records = [r for r in records if len(r) >= 67]

    def col(name, conv):
        s, w = _PAR_FIELDS[name]
        return np.array([conv(r[s:s + w]) for r in records])

    return from_arrays(
        nu0=col("nu", float), sw=col("sw", float),
        elower=col("elower", float), gamma_air=col("gamma_air", float),
        gamma_self=col("gamma_self", float), n_air=col("n_air", float),
        delta_air=col("delta_air", float),
        mol_id=col("molec_id", int),
        local_iso_id=np.array([_ISO_CHAR[r[2]] for r in records],
                              dtype=np.int32),
        device=device, dtype=dtype)
