"""TIPS-2011 total internal partition sums (counterpart of
``radtxfr_tpu/lines/tips.py``).

The 143 isotopologue tables are one (n_iso, 119) tensor; the reference's
3/4-point Lagrange rule (``misc/hapi.py:5311`` ``AtoB``) is evaluated
branchlessly with gathers. The temperature nodes are uniform
(60 K + 25 K * k), so node bracketing is arithmetic.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import DATA_DIR

T_NODE0 = 60.0
T_NODE_STEP = 25.0
N_NODES = 119

#: Valid temperature range enforced by the reference (misc/hapi.py:9571)
T_MIN = 70.0
T_MAX = 3000.0


@functools.lru_cache(maxsize=1)
def load_tips_tables():
    """Return (keys_mol, keys_iso, gsi, q_table) as NumPy arrays."""
    with np.load(os.path.join(DATA_DIR, "tips2011.npz")) as f:
        return f["mol"].copy(), f["iso"].copy(), f["gsi"].copy(), f["q"].copy()


@functools.lru_cache(maxsize=1)
def iso_row_index() -> dict[tuple[int, int], int]:
    """Map (HITRAN molecule number, local iso number) -> row in the Q table."""
    mol, iso, _, _ = load_tips_tables()
    return {(int(m), int(i)): r for r, (m, i) in enumerate(zip(mol, iso))}


def partition_sum(q_table: torch.Tensor, iso_row: torch.Tensor,
                  T: torch.Tensor) -> torch.Tensor:
    """Q(T) via the reference's 3/4-point Lagrange rule, vectorized.

    ``iso_row`` and ``T`` broadcast together; T <= 85 K uses the bottom
    3-point stencil, T at the top node the top one (``misc/hapi.py:5311``).
    """
    T = torch.as_tensor(T, dtype=q_table.dtype, device=q_table.device)
    i = torch.ceil((T - T_NODE0) / T_NODE_STEP).to(torch.int64)
    i = torch.clamp(i, 1, N_NODES - 1)
    lo3 = i < 2
    hi3 = i == N_NODES - 1
    j4 = i - 2
    j3 = torch.where(lo3, torch.zeros_like(i), torch.full_like(i, N_NODES - 3))
    use3 = lo3 | hi3
    base = torch.where(use3, j3, j4)
    base, iso_row, T = torch.broadcast_tensors(base, iso_row, T)

    def node(k):
        return T_NODE0 + T_NODE_STEP * (base + k).to(T.dtype)

    a0, a1, a2, a3 = node(0), node(1), node(2), node(3)
    b0 = q_table[iso_row, base]
    b1 = q_table[iso_row, base + 1]
    b2 = q_table[iso_row, base + 2]
    b3 = q_table[iso_row, torch.clamp(base + 3, max=N_NODES - 1)]

    w0_4 = (T - a1) * (T - a2) * (T - a3) / ((a0 - a1) * (a0 - a2) * (a0 - a3))
    w1_4 = (T - a0) * (T - a2) * (T - a3) / ((a1 - a0) * (a1 - a2) * (a1 - a3))
    w2_4 = (T - a0) * (T - a1) * (T - a3) / ((a2 - a0) * (a2 - a1) * (a2 - a3))
    w3_4 = (T - a0) * (T - a1) * (T - a2) / ((a3 - a0) * (a3 - a1) * (a3 - a2))
    w0_3 = (T - a1) * (T - a2) / ((a0 - a1) * (a0 - a2))
    w1_3 = (T - a0) * (T - a2) / ((a1 - a0) * (a1 - a2))
    w2_3 = (T - a0) * (T - a1) / ((a2 - a0) * (a2 - a1))

    q4 = w0_4 * b0 + w1_4 * b1 + w2_4 * b2 + w3_4 * b3
    q3 = w0_3 * b0 + w1_3 * b1 + w2_3 * b2
    return torch.where(use3, q3, q4)


def partition_sum_ratio(q_table: torch.Tensor, iso_row, T,
                        t_ref: float = 296.0) -> torch.Tensor:
    """Q(T_ref)/Q(T): the factor entering HITRAN intensity scaling."""
    T = torch.as_tensor(T, dtype=q_table.dtype, device=q_table.device)
    q_t = partition_sum(q_table, iso_row, T)
    q_ref = partition_sum(q_table, iso_row,
                          torch.tensor(t_ref, dtype=T.dtype,
                                       device=T.device))
    return q_ref / q_t
