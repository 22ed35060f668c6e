"""Deterministic cartesian-product grid (Lemma 3.1).

Tuples of R_i carry ids 1..|R_i|; machines form a p_1 × ... × p_{t'} grid; the id-j
tuple of R_i goes to every machine whose dim-i coordinate is (j mod p_i); relations
beyond t' (too small to matter) are broadcast. Every combination is assembled at
exactly one machine, with load O(max_i (Π_{j≤i}|R_j|/p)^{1/i}) = the paper's (3.2).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.planner import grid_dims


def cp_cell_contribs(dims: Sequence[int], list_idx: int) -> Tuple[int, Tuple[int, ...]]:
    """Static (host-side) half of `cells_for_ids`: the flat-cell stride of
    ``list_idx``'s own coordinate plus the flat contribution of every
    combination of the *other* dimensions.  Shared by the numpy and the torch
    routing paths so both enumerate the exact same cells."""
    dims = list(dims)
    stride = math.prod(dims[list_idx + 1:]) if list_idx + 1 < len(dims) else 1
    other_dims = [d for i, d in enumerate(dims) if i != list_idx]
    n_other = math.prod(other_dims) if other_dims else 1
    contribs = np.zeros((n_other,), dtype=np.int64)
    if other_dims:
        grid = np.indices(other_dims).reshape(len(other_dims), -1).T
        j = 0
        for di in range(len(dims)):
            if di == list_idx:
                continue
            s = math.prod(dims[di + 1:]) if di + 1 < len(dims) else 1
            contribs += grid[:, j] * s
            j += 1
    return stride, tuple(int(c) for c in contribs)


def cp_cells_dev(ids: torch.Tensor, dims: Sequence[int], list_idx: int) -> torch.Tensor:
    """Torch cell enumeration for list ``list_idx``: (n,) ids on any device →
    (n, n_other) int32 flat cells, equal to `CartesianGrid.cells_for_ids`."""
    stride, contribs = cp_cell_contribs(dims, list_idx)
    coords = (ids.to(torch.int64) % dims[list_idx]).to(torch.int32)
    table = torch.tensor(contribs, dtype=torch.int32, device=ids.device)
    return coords[:, None] * stride + table[None, :]


class CartesianGrid:
    """Grid geometry for Lemma 3.1. Lists must be sorted by size desc."""

    def __init__(self, sizes: Sequence[int], p: int):
        self.sizes = list(sizes)
        self.p = p
        self.dims, self.t_prime, self.load_bound = grid_dims(self.sizes, p)
        self.size = math.prod(self.dims) if self.dims else 1

    def cells_for_ids(self, list_idx: int, ids: np.ndarray) -> np.ndarray:
        """(n, n_other) flat cell ids for tuples of list ``list_idx`` (< t')."""
        stride, contribs = cp_cell_contribs(self.dims, list_idx)
        coords = np.asarray(ids, dtype=np.int64) % self.dims[list_idx]
        return coords.reshape(-1, 1) * stride + np.asarray(contribs, np.int64)[None, :]

    def cells_for_ids_dev(self, list_idx: int, ids: torch.Tensor) -> torch.Tensor:
        """Torch twin of `cells_for_ids` (delegates to `cp_cells_dev`)."""
        return cp_cells_dev(ids, self.dims, list_idx)

    def theoretical_load(self) -> float:
        """The bound (3.2): O(max_i |Join(R_1..R_i)|^{1/i} / p^{1/i})."""
        best = 0.0
        prod = 1.0
        for i, s in enumerate(self.sizes, start=1):
            prod *= float(s)
            best = max(best, (prod / self.p) ** (1.0 / i))
        return best
