"""Deterministic cartesian-product grid (Lemma 3.1).

Tuples of R_i carry ids 1..|R_i|; machines form a p_1 × ... × p_{t'} grid; the id-j
tuple of R_i goes to every machine whose dim-i coordinate is (j mod p_i); relations
beyond t' (too small to matter) are broadcast. Every combination is assembled at
exactly one machine, with load O(max_i (Π_{j≤i}|R_j|/p)^{1/i}) = the paper's (3.2).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.planner import grid_dims
from ..core.query import Relation
from .simulator import MPCSimulator, scatter_input


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
    """Grid geometry + routing for Lemma 3.1. Lists must be sorted by size desc."""

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


def route_cartesian(
    sim: MPCSimulator,
    grid: CartesianGrid,
    lists: Sequence[Tuple[object, np.ndarray, np.ndarray]],
    deliver: Callable[[int, object, np.ndarray], None],
    broadcast_cells: Sequence[int],
) -> None:
    """Route id-carrying rows. ``lists[i] = (out_tag, ids, rows)`` sorted desc by size;
    lists with index ≥ t' are broadcast to every cell in ``broadcast_cells``.
    Must be called inside an open round."""
    for i, (tag, ids, rows) in enumerate(lists):
        if rows.ndim == 1:
            rows = rows.reshape(-1, 1)
        if rows.shape[0] == 0:
            continue
        if i < grid.t_prime:
            cells = grid.cells_for_ids(i, ids)
            for combo in range(cells.shape[1]):
                flat = cells[:, combo]
                order = np.argsort(flat, kind="stable")
                fs, rs = flat[order], rows[order]
                uniq = np.unique(fs)
                bounds = np.append(np.searchsorted(fs, uniq), fs.shape[0])
                for u_i, cell in enumerate(uniq.tolist()):
                    deliver(int(cell), tag, rs[bounds[u_i] : bounds[u_i + 1]])
        else:
            for cell in broadcast_cells:
                deliver(int(cell), tag, rows)


def cartesian_product_mpc(
    relations: Sequence[Relation],
    p: int,
    seed: int = 0,
    materialize: bool = False,
) -> Tuple[MPCSimulator, int, Optional[np.ndarray]]:
    """Standalone Lemma 3.1: unary/any-arity relations with disjoint schemes.
    Returns (sim, |CP| assembled, rows if materialize). Used by bench_cartesian."""
    rels = sorted(relations, key=len, reverse=True)
    sizes = [len(r) for r in rels]
    assert all(s > 0 for s in sizes)
    grid = CartesianGrid(sizes, p)

    sim = MPCSimulator(p, seed=seed)
    # input placement: even spread, ids assigned by global position (simulating the
    # paper's 'tuples have been labeled with ids' precondition).
    id_rows = []
    for i, r in enumerate(rels):
        ids = np.arange(len(r), dtype=np.int64)
        id_rows.append(np.concatenate([ids.reshape(-1, 1), r.data], axis=1))
        scatter_input(sim, ("cp-in", i), id_rows[-1], seed=seed + i)

    sim.begin_round("cartesian")
    for mid in range(sim.p):
        lists = []
        for i in range(len(rels)):
            local = sim.local(mid, ("cp-in", i), arity=1 + rels[i].arity)
            lists.append((("cp", i), local[:, 0], local[:, 1:]))
        route_cartesian(
            sim,
            grid,
            lists,
            deliver=lambda cell, tag, rows: sim.send(cell, tag, rows),
            broadcast_cells=range(grid.size),
        )
    sim.end_round()

    total = 0
    out = []
    for cell in range(grid.size):
        frags = [sim.local(cell, ("cp", i), arity=rels[i].arity) for i in range(len(rels))]
        if any(f.shape[0] == 0 for f in frags):
            continue
        count = math.prod(f.shape[0] for f in frags)
        total += count
        if materialize:
            prod = frags[0]
            for f in frags[1:]:
                n_a, n_b = prod.shape[0], f.shape[0]
                prod = np.concatenate(
                    [np.repeat(prod, n_b, axis=0), np.tile(f, (n_a, 1))], axis=1
                )
            out.append(prod)
    rows = np.concatenate(out, axis=0) if (materialize and out) else None
    return sim, total, rows
