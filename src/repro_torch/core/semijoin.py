"""Semi-join reduction Q'(η) → Q''(η) (paper Sec. 5.2) — planner-side oracle.

Two steps (quoting the paper):
  1. For every border attribute X: R''_X(η) = ∩ over cross edges e ∋ X of R'_e(η).
  2. For every light edge e = {X, Y}: R''_e(η) keeps tuples whose X-value is in
     R''_X(η) (if X is border) and Y-value is in R''_Y(η) (if Y is border).

The distributed implementation is the SimulatorExecutor's semijoin rounds (hash-partitioned,
load-metered, in repro_torch.mpc.executors);
this module is the small-data oracle used for validation and for the ICP benchmarks.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce
from typing import Dict, Optional, Tuple

import numpy as np

from .hypergraph import Edge
from .query import Attr, JoinQuery, Relation
from .taxonomy import Configuration, HPlan, HeavyStats, residual_relations


@dataclass(frozen=True)
class ReducedQuery:
    """Q''(η) = Q''_isolated ∪ Q''_light, plus the R''_X for border attrs (5.4)-(5.7)."""

    eta: Configuration
    unary: Dict[Attr, np.ndarray]          # R''_X(η) for every border attribute X
    light_rels: Dict[Edge, Relation]       # R''_e(η) for light edges e
    isolated: Tuple[Attr, ...]             # I

    def isolated_sizes(self) -> Dict[Attr, int]:
        return {a: int(self.unary[a].size) for a in self.isolated}

    def isolated_cp_size(self) -> int:
        out = 1
        for a in self.isolated:
            out *= int(self.unary[a].size)
        return out if self.isolated else 1


def _intersect_sorted(arrays) -> np.ndarray:
    arrays = list(arrays)
    if not arrays:
        return np.zeros(0, dtype=np.int64)
    return reduce(lambda a, b: np.intersect1d(a, b, assume_unique=False), arrays)


def semijoin_reduce(
    query: JoinQuery,
    stats: HeavyStats,
    plan: HPlan,
    eta: Configuration,
) -> Optional[ReducedQuery]:
    """Oracle semi-join reduction. Returns None if η is ruled out by an inactive edge
    (missing heavy-heavy pair) — Q'(η) is then empty."""
    residuals = residual_relations(query, stats, plan, eta)
    if residuals is None:
        return None

    # Step 1: unary intersections per border attribute.
    unary: Dict[Attr, np.ndarray] = {}
    for x in plan.border:
        lists = [
            rel.data[:, 0]
            for (e, scheme), rel in residuals.items()
            if scheme == (x,)
        ]
        unary[x] = _intersect_sorted(lists)

    # Step 2: shrink light edges by border-attribute membership.
    light_rels: Dict[Edge, Relation] = {}
    for e in plan.light_edges:
        rel = residuals[(e, next(s for (ee, s) in residuals if ee == e))]
        sel = np.ones(len(rel), dtype=bool)
        for attr in rel.scheme:
            if attr in unary:
                sel &= np.isin(rel.column(attr), unary[attr])
        light_rels[e] = Relation.make(rel.scheme, rel.data[sel])

    return ReducedQuery(
        eta=eta, unary=unary, light_rels=light_rels, isolated=plan.isolated
    )


def join_reduced(reduced: ReducedQuery, plan: HPlan) -> np.ndarray:
    """Oracle evaluation of Join(Q''(η)) = Join(Q''_isolated) × Join(Q''_light) (5.8).
    Output columns ordered by sorted(L). Used to validate the MPC engine per-config."""
    from .query import JoinQuery as JQ
    from .query import reference_join

    light_attrs = sorted(set(plan.light) - set(plan.isolated))
    if light_attrs:
        sub = JQ.make(tuple(reduced.light_rels[e] for e in plan.light_edges))
        light_join = reference_join(sub)
        light_rows = light_join.data  # columns sorted(light_attrs)
        if light_rows.shape[0] == 0:
            return np.zeros((0, len(plan.light)), dtype=np.int64)
    else:
        light_rows = np.zeros((1, 0), dtype=np.int64)

    rows = light_rows
    cols = list(light_attrs)
    for a in plan.isolated:
        vals = reduced.unary[a]
        if vals.size == 0:
            return np.zeros((0, len(plan.light)), dtype=np.int64)
        n = rows.shape[0]
        rows = np.repeat(rows, vals.size, axis=0)
        tiled = np.tile(vals, n).reshape(-1, 1)
        rows = np.concatenate([rows, tiled], axis=1)
        cols.append(a)
    perm = [cols.index(a) for a in sorted(plan.light)]
    return rows[:, perm] if rows.size else rows.reshape(0, len(plan.light))
