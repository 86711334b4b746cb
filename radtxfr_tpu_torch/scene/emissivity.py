"""Surface emissivity database: ingest, resampling, mixtures (counterpart
of ``radtxfr_tpu/scene/emissivity.py``).

The reference's emissivity data layer (L3):

* ``Generate_ASTER_emissivity_DB.py`` — per-material reflectance ->
  emissivity (eps = 1 - R), µm -> cm^-1 with sort/trim/dedup, cubic
  resample onto a common axis, clamp to [0, 1] (``:81-117``);
* ``Generate_Emissivity_DB.py`` — pairwise linear mixtures over a fraction
  grid with tolerance clamping (``:23-46``).

The ASTER 2.0 library is licensed data the repo does not ship:
:func:`synthetic_db` draws plausible LWIR emissivities (Lorentzian
reststrahlen dips on a high-emissivity continuum) with NumPy's
``default_rng``, so its spectra equal the JAX package's bit for bit;
:func:`read_aster_export` and :func:`load_aster_dir` ingest real exports.
Ingest and mixing run on the host in float64; a database's tensors live on
one device (the card unless the caller passes another).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import as_numpy, as_tensor_on
from ..sensor.resolution import apply_resample, cubic_resample_weights

__all__ = ["EmissivityDB", "synthetic_db", "save_db", "load_db",
           "read_aster_export", "load_aster_dir"]


@dataclasses.dataclass(frozen=True)
class EmissivityDB:
    """A set of surface emissivity spectra on a common wavenumber axis."""

    X: torch.Tensor            # (nX,) wavenumber axis [cm^-1]
    emis: torch.Tensor         # (nE, nX) emissivities in [0, 1]
    material_id: torch.Tensor  # (nE,) int32 material ids
    names: tuple = ()

    @property
    def n_materials(self) -> int:
        return int(self.emis.shape[0])

    @staticmethod
    def _build(X, emis, names=(), material_id=None, device=None,
               dtype=torch.float64) -> "EmissivityDB":
        emis = as_tensor_on(emis, device, dtype)
        ids = (torch.arange(emis.shape[0], dtype=torch.int32)
               if material_id is None else torch.as_tensor(material_id))
        return EmissivityDB(X=as_tensor_on(X, emis.device, dtype), emis=emis,
                            material_id=ids.to(torch.int32).to(emis.device),
                            names=tuple(names))

    @staticmethod
    def from_spectra(spectra, X_out, reflectance: bool = False, names=(),
                     wavelength_um: bool = False, device=None,
                     dtype=torch.float64) -> "EmissivityDB":
        """Build a DB from per-material (x, y) spectra, as the ASTER ingest
        (``Generate_ASTER_emissivity_DB.py:81-117``): optional
        reflectance -> emissivity, µm -> cm^-1, sort + dedup, cubic
        resample onto ``X_out``, clamp to [0, 1] (host float64)."""
        X_out = as_numpy(X_out, np.float64)
        rows = []
        for x, y in spectra:
            x = as_numpy(x, np.float64)
            y = as_numpy(y, np.float64)
            if reflectance:
                y = 1.0 - y / 100.0 if y.max() > 1.5 else 1.0 - y
            if wavelength_um:
                x = 10000.0 / x
            order = np.argsort(x)
            x, y = x[order], y[order]
            keep = np.concatenate([[True], np.diff(x) > 0])
            x, y = x[keep], y[keep]
            idx, w = cubic_resample_weights(x, X_out)
            rows.append(np.clip(apply_resample(idx, w, torch.as_tensor(y))
                                .numpy(), 0.0, 1.0))
        emis = np.stack(rows)
        names = (tuple(names) if names else
                 tuple(f"material_{i}" for i in range(emis.shape[0])))
        return EmissivityDB._build(X_out, emis, names, device=device,
                                   dtype=dtype)

    def resample(self, X_new) -> "EmissivityDB":
        """The spectra cubic-resampled onto ``X_new``, clamped to [0, 1]."""
        X_new = as_numpy(X_new, np.float64)
        idx, w = cubic_resample_weights(
            self.X.double().cpu().numpy(), X_new)
        emis = torch.clamp(apply_resample(idx, w, self.emis.T).T, 0.0, 1.0)
        return dataclasses.replace(
            self, X=as_tensor_on(X_new, emis.device, self.X.dtype), emis=emis)

    def pairwise_mixtures(self, n_fractions: int = 11,
                          tol: float = 1e-3) -> "EmissivityDB":
        """All unordered material pairs mixed at a uniform fraction grid,
        clamped to [tol, 1 - tol] (``Generate_Emissivity_DB.py:23-46``)."""
        n = self.n_materials
        fr = np.linspace(0.0, 1.0, n_fractions)
        ii, jj = np.triu_indices(n, k=1)
        e = self.emis.cpu().numpy()
        mixes = (fr[None, :, None] * e[ii][:, None, :]
                 + (1.0 - fr[None, :, None]) * e[jj][:, None, :])
        mixes = np.clip(mixes.reshape(-1, e.shape[1]), tol, 1.0 - tol)
        return EmissivityDB._build(self.X, mixes, device=self.emis.device,
                                   dtype=self.emis.dtype)


def save_db(db: EmissivityDB, basename: str) -> None:
    """Export a DB as the reference does
    (``Generate_ASTER_emissivity_DB.py:123-170``): ``basename.npz``,
    ``basename.h5`` with units metadata, and a ``basename.csv`` material
    label map."""
    import csv

    from ..io.h5 import Var, write_h5

    X = db.X.cpu().numpy()
    emis = db.emis.cpu().numpy()
    ids = db.material_id.cpu().numpy()
    np.savez(basename + ".npz", X=X, emis=emis, material_ID=ids)
    write_h5(basename + ".h5", {
        "X": Var(X, units="cm^{-1}", name="Wavenumbers"),
        "emis": Var(emis, units="none", name="Emissivity",
                    info="(n_materials, nX), 0 <= emis <= 1"),
        "material_ID": Var(ids, units="none", name="Material ID"),
    })
    with open(basename + ".csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["material_ID", "name"])
        names = db.names or tuple(f"material_{i}"
                                  for i in range(db.n_materials))
        for i, name in zip(ids.tolist(), names):
            w.writerow([i, name])


def load_db(basename: str, device=None) -> EmissivityDB:
    """Load a DB written by :func:`save_db` (or the reference's NPZ layout,
    ``LWIR_HSI_Generator.py:86-90``) onto ``device`` (None: the card), in
    the file's float dtype."""
    with np.load(basename + ".npz") as f:
        emis = np.asarray(f["emis"])
        return EmissivityDB._build(f["X"], emis,
                                   material_id=np.asarray(f["material_ID"]),
                                   device=device,
                                   dtype=torch.as_tensor(emis[:0]).dtype)


def synthetic_db(n_materials: int = 24, X=None, seed: int = 0, device=None,
                 dtype=torch.float64) -> EmissivityDB:
    """Plausible LWIR emissivities: a near-unity continuum with
    reststrahlen dips, drawn on the host with ``default_rng(seed)``
    (``X`` default 690-1410 cm^-1 at 1 cm^-1)."""
    if X is None:
        X = np.arange(690.0, 1411.0, 1.0)
    X = as_numpy(X, np.float64)
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_materials):
        base = rng.uniform(0.88, 0.99)
        e = np.full_like(X, base)
        for _ in range(rng.integers(0, 4)):
            center = rng.uniform(X.min(), X.max())
            width = rng.uniform(10.0, 80.0)
            depth = rng.uniform(0.05, 0.5)
            e = e - depth / (1.0 + ((X - center) / width) ** 2)
        rows.append(np.clip(e, 0.02, 1.0))
    return EmissivityDB._build(
        X, np.stack(rows),
        names=tuple(f"synthetic_{i}" for i in range(n_materials)),
        device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# ASTER / ECOSTRESS spectral-library ASCII export ingest
# ---------------------------------------------------------------------------

def read_aster_export(path):
    """Parse one ASTER 2.0 / ECOSTRESS spectral-library ASCII export: a
    ``Key: value`` header followed by two columns (wavelength [µm],
    reflectance [percent]). Returns ``(meta, wavelength_um,
    reflectance_frac)``, the reflectance as [0, 1] fractions, clamped
    (``Generate_ASTER_emissivity_DB.py:96-101``)."""
    meta = {}
    xs, ys = [], []
    with open(path, errors="replace") as f:
        for line in f:
            s = line.strip()
            if not s:
                continue
            parts = s.split()
            if len(parts) >= 2:
                try:
                    x, y = float(parts[0]), float(parts[1])
                    xs.append(x)
                    ys.append(y)
                    continue
                except ValueError:
                    pass
            if ":" in s:
                k, _, v = s.partition(":")
                meta[k.strip()] = v.strip()
    x = np.asarray(xs, dtype=np.float64)
    y = np.asarray(ys, dtype=np.float64)
    y_units = meta.get("Y Units", "").lower()
    if "percent" in y_units or (y.size and y.max() > 1.5):
        y = y / 100.0
    return meta, x, np.clip(y, 0.0, 1.0)


def load_aster_dir(directory, lambda_min_um: float = 6.75,
                   lambda_max_um: float = 14.5, dX: float = 1.0,
                   pattern: str = "*.txt", coverage_margin_um: float = 0.25,
                   device=None):
    """An :class:`EmissivityDB` from a directory of ASTER/ECOSTRESS export
    files (``Generate_ASTER_emissivity_DB.py:58-117`` without the SQL
    layer): spectra covering [lambda_min - margin, lambda_max + margin] µm,
    the axis ``linspace(1e4/lambda_max, 1e4/lambda_min, int((X_max -
    X_min)/dX))``, eps = 1 - R through :meth:`EmissivityDB.from_spectra`.
    Returns (db, skipped files)."""
    import glob as _glob

    X_min = 10000.0 / lambda_max_um
    X_max = 10000.0 / lambda_min_um
    X = np.linspace(X_min, X_max, int((X_max - X_min) / dX))

    spectra, names, skipped = [], [], []
    for path in sorted(_glob.glob(os.path.join(directory, pattern))):
        meta, wl, refl = read_aster_export(path)
        if wl.size < 4:
            skipped.append(path)
            continue
        if (wl.min() > lambda_min_um - coverage_margin_um
                or wl.max() < lambda_max_um + coverage_margin_um):
            skipped.append(path)
            continue
        spectra.append((wl, refl))
        names.append(meta.get("Name", os.path.basename(path)))
    if not spectra:
        raise ValueError(
            f"no export files in {directory!r} cover "
            f"[{lambda_min_um - coverage_margin_um}, "
            f"{lambda_max_um + coverage_margin_um}] µm")
    db = EmissivityDB.from_spectra(spectra, X, reflectance=True,
                                   wavelength_um=True, names=names,
                                   device=device)
    return db, skipped
