"""HyperCube grid geometry (Lemma 3.3 / the BKS one-round algorithm).

Machines form a grid with one dimension per attribute; a tuple of relation with scheme
{X, Y} is sent to every cell whose X/Y coordinates equal h_X(u(X)), h_Y(u(Y)); a result
tuple is assembled at exactly one cell (the one matching all its hashed coordinates).
The dataplane grid route (``repro_torch.dataplane.grid``) enumerates cells with the
helpers below; ``route_hypercube`` is the same routing on the metered simulator
(the skew-free subqueries of Theorem 6.2), and ``skewfree_hypercube_join`` the
standalone one-round baseline — correct on any input, its load degrading under skew.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.optimize import linprog

from ..core.hypergraph import Hypergraph
from ..core.query import Attr, JoinQuery, Relation, reference_join
from ..device import resolve_device
from .simulator import MPCSimulator, scatter_input


def uniform_lp_shares(g: Hypergraph, p: int) -> Dict[Attr, int]:
    """One-round share optimizer for *uniform* data: choose exponents y_X ≥ 0 with
    Σ y_X ≤ 1 maximizing min_e Σ_{X∈e} y_X; share_X = round(p^{y_X}).
    (For a clique/cycle this recovers the classic p^{2/|V|}-style shares.)"""
    attrs = list(g.vertices)
    na = len(attrs)
    aidx = {a: i for i, a in enumerate(attrs)}
    # vars: y_0..y_{na-1}, t ; maximize t  s.t. t - Σ_{X∈e} y_X ≤ 0 ; Σ y ≤ 1 ; y ≥ 0
    nvar = na + 1
    c = np.zeros(nvar)
    c[-1] = -1.0
    a_ub = []
    b_ub = []
    for e in g.edges:
        row = np.zeros(nvar)
        row[-1] = 1.0
        for v in e:
            row[aidx[v]] = -1.0
        a_ub.append(row)
        b_ub.append(0.0)
    row = np.zeros(nvar)
    row[:na] = 1.0
    a_ub.append(row)
    b_ub.append(1.0)
    res = linprog(c, A_ub=np.array(a_ub), b_ub=np.array(b_ub), bounds=(0, None), method="highs")
    if not res.success:
        raise RuntimeError(res.message)
    shares = {}
    for a in attrs:
        shares[a] = max(1, int(round(p ** float(res.x[aidx[a]]))))
    # keep the grid within p cells
    while math.prod(shares.values()) > p:
        amax = max(shares, key=lambda a: shares[a])
        shares[amax] = max(1, shares[amax] - 1)
    return shares


def hc_cell_contribs(
    attrs: Sequence[Attr], dims: Sequence[int], fixed_attrs: Sequence[Attr]
) -> Tuple[Dict[Attr, int], Tuple[int, ...]]:
    """Static (host-side) half of `cells_for`: the flat-cell stride of every
    fixed attribute plus the flat contribution of every combination of the
    free dimensions.  Shared by the numpy and the torch routing paths so both
    enumerate the exact same cells."""
    attrs = tuple(attrs)
    dims = tuple(dims)
    fixed = set(fixed_attrs)
    strides: Dict[Attr, int] = {}
    for ai, a in enumerate(attrs):
        if a in fixed:
            strides[a] = math.prod(dims[ai + 1:]) if ai + 1 < len(dims) else 1
    free_dims = [d for a, d in zip(attrs, dims) if a not in fixed]
    n_free = math.prod(free_dims) if free_dims else 1
    contribs = np.zeros((n_free,), dtype=np.int64)
    if free_dims:
        grid = np.indices(free_dims).reshape(len(free_dims), -1).T
        j = 0
        for ai, a in enumerate(attrs):
            if a in fixed:
                continue
            s = math.prod(dims[ai + 1:]) if ai + 1 < len(dims) else 1
            contribs += grid[:, j] * s
            j += 1
    return strides, tuple(int(c) for c in contribs)


def hc_cells_dev(fixed_coords, free_contribs: Sequence[int], n: int,
                 device=None) -> torch.Tensor:
    """Torch cell enumeration from already-fixed coordinates: ``fixed_coords``
    is a sequence of ((n,) coordinate tensor, flat stride) pairs,
    ``free_contribs`` the flat ids of the free-dimension combos.  Returns
    (n, n_free) int32 flat cells on ``device`` (the card unless the caller
    names another), equal to `HyperCubeGrid.cells_for`."""
    device = resolve_device(device)
    flat = torch.zeros((n,), dtype=torch.int32, device=device)
    for coord, stride in fixed_coords:
        flat = flat + coord.to(torch.int32) * stride
    table = torch.tensor(free_contribs, dtype=torch.int32, device=device)
    return flat[:, None] + table[None, :]


class HyperCubeGrid:
    """Mixed-radix cell indexing over an ordered attribute list."""

    def __init__(self, attrs: Sequence[Attr], shares: Dict[Attr, int]):
        self.attrs = tuple(attrs)
        self.dims = tuple(int(shares[a]) for a in self.attrs)
        self.size = math.prod(self.dims) if self.dims else 1

    def share(self, attr: Attr) -> int:
        return self.dims[self.attrs.index(attr)]

    def cells_for(self, fixed: Dict[Attr, np.ndarray]) -> np.ndarray:
        """Vectorized: given per-attribute fixed coordinates (arrays of equal length n)
        for a subset of attrs, return (n, n_free_combos) flat cell ids covering all
        combinations of the free dims."""
        n = len(next(iter(fixed.values()))) if fixed else 1
        free_dims = [d for a, d in zip(self.attrs, self.dims) if a not in fixed]
        n_free = math.prod(free_dims) if free_dims else 1
        # enumerate free combos
        combos = np.zeros((n_free, len(self.attrs)), dtype=np.int64)
        if free_dims:
            grid = np.indices(free_dims).reshape(len(free_dims), -1).T
            j = 0
            for ai, a in enumerate(self.attrs):
                if a not in fixed:
                    combos[:, ai] = grid[:, j]
                    j += 1
        flat = np.zeros((n, n_free), dtype=np.int64)
        for ai, a in enumerate(self.attrs):
            stride = math.prod(self.dims[ai + 1 :]) if ai + 1 < len(self.dims) else 1
            if a in fixed:
                flat += (fixed[a].reshape(-1, 1)) * stride
            else:
                flat += combos[:, ai].reshape(1, -1) * stride
        return flat

    def cells_for_dev(self, fixed: Dict[Attr, torch.Tensor], device=None) -> torch.Tensor:
        """Torch twin of `cells_for`: the per-attribute coordinates in
        ``fixed`` are (n,) tensors.  Returns (n, n_free_combos) int32 flat
        cell ids equal to the numpy version, on the coordinates' device, or
        with no coordinates on ``device`` (the card unless the caller names
        another)."""
        strides, contribs = hc_cell_contribs(self.attrs, self.dims, tuple(fixed))
        n = next(iter(fixed.values())).shape[0] if fixed else 1
        if fixed:
            device = next(iter(fixed.values())).device
        return hc_cells_dev(
            [(coord, strides[a]) for a, coord in fixed.items()], contribs, n, device
        )


def route_hypercube(
    sim: MPCSimulator,
    grid: HyperCubeGrid,
    fragments: Iterable[Tuple[Tuple[Attr, ...], object, np.ndarray]],
    salt,
    deliver: Callable[[int, object, np.ndarray], None],
) -> None:
    """Route rows to HyperCube cells. ``fragments`` yields (scheme, out_tag, rows);
    ``deliver(cell, out_tag, rows)`` performs the sends (caller controls the physical
    mapping, enabling the Lemma 3.2 matrix composition). Must be called inside a round."""
    for scheme, out_tag, rows in fragments:
        if rows.shape[0] == 0:
            continue
        fixed = {}
        for col, attr in enumerate(scheme):
            if attr in grid.attrs:
                share = grid.dims[grid.attrs.index(attr)]
                fixed[attr] = sim.hashes.hash((salt, attr), rows[:, col], share)
        cells = grid.cells_for(fixed)  # (n, n_free)
        for combo in range(cells.shape[1]):
            flat = cells[:, combo]
            order = np.argsort(flat, kind="stable")
            flat_sorted = flat[order]
            rows_sorted = rows[order]
            bounds = np.searchsorted(flat_sorted, np.unique(flat_sorted))
            uniq = np.unique(flat_sorted)
            bounds = np.append(bounds, flat.shape[0])
            for i, cell in enumerate(uniq.tolist()):
                deliver(int(cell), out_tag, rows_sorted[bounds[i] : bounds[i + 1]])


def skewfree_hypercube_join(
    query: JoinQuery,
    shares: Dict[Attr, int],
    p: int,
    seed: int = 0,
    materialize: bool = True,
) -> Tuple[MPCSimulator, int, Optional[Relation]]:
    """Standalone one-round HyperCube join (Lemma 3.3 / the one-round baseline).

    Returns (sim with metered loads, result_count, result or None). Input placement is
    even; the single communication round routes every tuple to its hash cells; each cell
    joins its fragments locally. Correct on any input; optimal only when skew-free.
    """
    sim = MPCSimulator(p, seed=seed)
    for rel in query.relations:
        scatter_input(sim, ("in", rel.edge), rel.data, seed=seed + 1)

    attrs = query.attset
    grid = HyperCubeGrid(attrs, shares)
    assert grid.size <= p, (grid.size, p)

    sim.begin_round("hypercube")
    for mid in range(sim.p):
        frags = []
        for rel in query.relations:
            local = sim.local(mid, ("in", rel.edge))
            frags.append((rel.scheme, ("hc", rel.edge), local))
        route_hypercube(
            sim,
            grid,
            frags,
            salt="hc",
            deliver=lambda cell, tag, rows: sim.send(cell, tag, rows),
        )
    sim.end_round()

    total = 0
    out_rows = []
    for cell in range(grid.size):
        rels = []
        empty = False
        for rel in query.relations:
            rows = sim.local(cell, ("hc", rel.edge))
            if rows.shape[0] == 0:
                empty = True
                break
            rels.append(Relation.make(rel.scheme, rows))
        if empty:
            continue
        local_join = reference_join(JoinQuery.make(rels))
        total += len(local_join)
        if materialize and len(local_join):
            out_rows.append(local_join.data)
    result = None
    if materialize:
        data = (
            np.concatenate(out_rows, axis=0)
            if out_rows
            else np.zeros((0, len(attrs)), dtype=np.int64)
        )
        result = Relation.make(attrs, data)
    return sim, total, result
