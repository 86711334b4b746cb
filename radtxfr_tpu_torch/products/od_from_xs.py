"""Serving-path optical depth from precomputed cross-section tables
(counterpart of ``radtxfr_tpu/products/od_from_xs.py``).

The reference precomputes absorption cross-section grids over a (T, p)
lattice and exports them as AFIT_XS binaries
(``misc/RT_gen_AbsXS_files.py:15-31,87-92``) but ships no consumer. Here a
packed ``(molecule, T, p, nu)`` table lives in device memory, and the
bilinear (T, log p) corner weights times the column densities fold into a
small dense matrix, so a layered OD is one matrix product against the
flattened table: the trade for a band that is served repeatedly (HSI
simulation, retrievals, training-data generation).

At lattice nodes the table matches the line-by-line engine; between nodes
the error is second order in the (T, p) spacing. Tables are air-broadened
(``vmr_self = 0``, the reference generator's environment): per-layer
self-broadening is a line-by-line feature a (T, p) lattice cannot carry.

The product is a ``torch.matmul`` (the JAX package computes it outside any
Pallas kernel), with TF32 off unless ``precision="default"`` asks for it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import as_numpy, resolve_device
from ..core.constants import PA_PER_ATM
from ..lines.store import IsoTables, LineStore
from ..utils.profiling import span
from .od import species_column

__all__ = ["XsTable", "build_xs_table", "xs_table_from_files", "od_from_xs"]


@dataclasses.dataclass(frozen=True)
class XsTable:
    """Packed cross-section lattice sigma[molecule, T, p, nu]
    (cm^2/molecule), every tensor on one device."""

    sigma: torch.Tensor      # (nM, nT, nP, nX)
    T_grid: torch.Tensor     # (nT,) ascending [K]
    logp_grid: torch.Tensor  # (nP,) ascending log(p [atm])
    x: np.ndarray            # (nX,) host axis [cm^-1]
    mol_ids: tuple = ()

    @property
    def n_mol(self) -> int:
        return int(self.sigma.shape[0])

    @staticmethod
    def from_numpy(sigma, T_grid, logp_grid, x, mol_ids, device=None,
                   dtype=torch.float32) -> "XsTable":
        """A table from NumPy arrays (e.g. a JAX table's), on ``device``
        (None: the card) in ``dtype``."""
        device = resolve_device(device)
        t = lambda a: torch.as_tensor(as_numpy(a), device=device).to(dtype)
        return XsTable(sigma=t(sigma), T_grid=t(T_grid),
                       logp_grid=t(logp_grid),
                       x=as_numpy(x, np.float64),
                       mol_ids=tuple(int(m) for m in mol_ids))


def build_xs_table(lines: LineStore, iso: IsoTables, grid, T_grid,
                   p_grid_atm, mol_ids=None, profile: str = "voigt",
                   wing_abs: float = 0.0, wing_hw: float = 50.0,
                   chunk: int = 512) -> XsTable:
    """Fill an :class:`XsTable` with the reference engine
    (``compute_line_params`` and ``xsect_from_params``, plain PyTorch on
    the lines' device), one (molecule, T, p) entry at a time, as the
    reference's generator loops (``misc/RT_gen_AbsXS_files.py:87-92``).
    Each entry is a pure cross-section (``strength_scale=1``), so layer
    amounts enter only at lookup time. float32, like the JAX table."""
    from ..kernels.lineparams import compute_line_params
    from ..kernels.xsect import xsect_from_params

    grid = as_numpy(grid)
    if mol_ids is None:
        mol_ids = tuple(int(m) for m in np.unique(lines.host["mol_id"]))
    T_grid = as_numpy(T_grid, np.float64)
    p_grid = as_numpy(p_grid_atm, np.float64)
    dev = lines.sw.device
    gx = torch.as_tensor(grid, device=dev).to(lines.sw.dtype)

    def one(store, T, p):
        params = compute_line_params(store, iso, float(T), float(p),
                                     wing_abs=wing_abs, wing_hw=wing_hw,
                                     profile=profile)
        return xsect_from_params(gx, params, profile=profile, chunk=chunk)

    blocks = []
    for m in mol_ids:
        store_m = lines.select_molecules([m])
        blocks.append(torch.stack([torch.stack([one(store_m, T, p)
                                                for p in p_grid])
                                   for T in T_grid]))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return XsTable(sigma=torch.stack(blocks).to(torch.float32),
                   T_grid=f32(T_grid), logp_grid=f32(np.log(p_grid)),
                   x=grid, mol_ids=tuple(int(m) for m in mol_ids))


def xs_table_from_files(paths_by_mol: dict, device=None) -> XsTable:
    """Assemble a float32 table from AFIT_XS binaries
    (``io.afit_xs.xs_read``) on ``device`` (None: the card).

    ``paths_by_mol`` maps HITRAN molecule id -> list of filenames covering
    a full (T, p) lattice on one shared nu axis; a file on another axis, or
    a lattice entry no file holds, raises ``ValueError``."""
    from ..io.afit_xs import xs_read

    mol_ids = tuple(sorted(paths_by_mol))
    x_ref = None
    Ts, Ps = set(), set()
    entries = {}
    for m in mol_ids:
        for fn in paths_by_mol[m]:
            X, Y, meta = xs_read(fn)
            if x_ref is None:
                x_ref = X
            elif X.size != x_ref.size or abs(X[0] - x_ref[0]) > 1e-9:
                raise ValueError(f"{fn}: nu axis differs from the first file")
            Ts.add(meta["T"])
            Ps.add(meta["P_pa"])
            entries[(m, meta["T"], meta["P_pa"])] = Y
    T_grid = np.asarray(sorted(Ts))
    P_grid = np.asarray(sorted(Ps))
    sigma = np.zeros((len(mol_ids), T_grid.size, P_grid.size, x_ref.size),
                     dtype=np.float32)
    for im, m in enumerate(mol_ids):
        for it, T in enumerate(T_grid):
            for ip, P in enumerate(P_grid):
                try:
                    sigma[im, it, ip] = entries[(m, T, P)]
                except KeyError:
                    raise ValueError(
                        f"missing lattice entry mol={m} T={T} P_pa={P}")
    return XsTable.from_numpy(sigma, T_grid, np.log(P_grid / PA_PER_ATM),
                              x_ref, mol_ids, device=device)


def _lerp_axis(grid: torch.Tensor, v: torch.Tensor):
    """Bracketing index and fraction for clamped linear interpolation."""
    i = torch.clamp(torch.searchsorted(grid, v.to(grid.dtype).contiguous(),
                                       right=True) - 1, 0, grid.shape[0] - 2)
    f = (v - grid[i]) / (grid[i + 1] - grid[i])
    return i, torch.clamp(f, 0.0, 1.0)


def interp_sigma(table: XsTable, T, p_atm) -> torch.Tensor:
    """sigma(T, p) per molecule: bilinear in (T, log p), clamped at the
    lattice edges. ``T``/``p_atm`` scalars -> (nM, nX)."""
    like = lambda a: torch.as_tensor(a, dtype=table.T_grid.dtype,
                                     device=table.T_grid.device)
    it, ft = _lerp_axis(table.T_grid, like(T))
    ip, fp = _lerp_axis(table.logp_grid, torch.log(like(p_atm)))
    s = table.sigma
    s00 = s[:, it, ip]
    s01 = s[:, it, ip + 1]
    s10 = s[:, it + 1, ip]
    s11 = s[:, it + 1, ip + 1]
    return ((1 - ft) * (1 - fp) * s00 + (1 - ft) * fp * s01
            + ft * (1 - fp) * s10 + ft * fp * s11)


def od_from_xs(table: XsTable, atmos, vmr_cols=None,
               precision: str = "highest") -> torch.Tensor:
    """Layer optical depths from the lattice: (nL, nX) on the table's
    device.

    ``atmos`` is an :class:`~..atmos.profile.AtmosphericState`;
    ``vmr_cols`` maps table molecules to vmr columns (default: matching
    ``table.mol_ids`` against ``atmos.mol_ids``; a table molecule with no
    column raises ``ValueError``).

    The bilinear corner weights and column densities fold into a dense
    matrix M (nL, nM*nT*nP), four nonzeros per (layer, molecule), so the
    lookup is one product ``M @ sigma_flat``. ``precision`` 'highest'
    keeps full float32 (TF32 off, as the package sets it); 'default' lets
    the card's TF32 run inside this one product (about 1e-3 relative: the
    counterpart of the JAX package's bf16 ``Precision.DEFAULT``) and
    restores the setting afterwards. On the CPU the two agree.

    Spans: ``od``, holding ``od.xs_weights`` (M) and ``od.xs_matmul``.
    """
    if precision not in ("highest", "default"):
        raise ValueError(f"precision must be 'highest' or 'default', got "
                         f"{precision!r}")
    if vmr_cols is None:
        col = {m: i for i, m in enumerate(atmos.mol_ids)}
        try:
            vmr_cols = tuple(col[m] for m in table.mol_ids)
        except KeyError as e:
            raise ValueError(
                f"table molecule {e} has no vmr column in the atmosphere")
    with span("od"):
        n_m, n_t, n_p, n_x = table.sigma.shape
        sflat = table.sigma.reshape(n_m * n_t * n_p, n_x)
        dev, dtype = table.sigma.device, table.sigma.dtype
        T, p, pl, vmr = (a.to(dev) for a in (atmos.T, atmos.p, atmos.pl,
                                              atmos.vmr))
        cols = torch.as_tensor(vmr_cols, dtype=torch.int64, device=dev)

        with span("od.xs_weights"):
            it, ft = _lerp_axis(table.T_grid, T)                   # (nL,)
            ip, fp = _lerp_axis(table.logp_grid, torch.log(p / PA_PER_ATM))
            n_col = species_column(p[:, None], T[:, None], pl[:, None],
                                   vmr[:, cols]).to(dtype)         # (nL, nM)
            base = torch.arange(n_m, device=dev)[None, :] * (n_t * n_p)
            idx, val = [], []
            for di, dj, c in ((0, 0, (1 - ft) * (1 - fp)),
                              (0, 1, (1 - ft) * fp),
                              (1, 0, ft * (1 - fp)), (1, 1, ft * fp)):
                idx.append(base + ((it + di) * n_p + ip + dj)[:, None])
                val.append(n_col * c.to(dtype)[:, None])
            M = torch.zeros((T.shape[0], n_m * n_t * n_p), dtype=dtype,
                            device=dev)
            M.scatter_add_(1, torch.cat(idx, dim=1), torch.cat(val, dim=1))

        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = precision == "default"
        try:
            with span("od.xs_matmul"):
                return M @ sflat
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
