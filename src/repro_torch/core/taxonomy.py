"""Heavy/light taxonomy of the join result (paper Sec. 4).

Given heavy parameter λ: a value x is *heavy* iff some relation R and attribute
X ∈ scheme(R) have ≥ m/λ tuples with u(X) = x; *light* iff it appears but is not heavy.

A configuration η of H ⊆ attset(Q) assigns a heavy value to every attribute in H.
The residual relation R'_e(η) (for e active on H) keeps tuples of R_e that agree with η
on e∩H and are light on e\\H, projected to e\\H.

Everything here is *planner-side* metadata (heavy value sets, configuration enumeration,
statistics); the data movement happens in repro.mpc / repro.dataplane.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from .hypergraph import Edge, Hypergraph
from .query import Attr, JoinQuery, Relation, rows_sorted_unique


@dataclass(frozen=True)
class HeavyStats:
    """Heavy-value statistics of a query for a fixed λ (the paper's 'histogram').

    - heavy[X]: sorted array of heavy values on attribute X (across all relations).
    - Extended records (see DESIGN.md §6) so m_η is exactly computable on every host:
      * cond[(e, X, x)]  = #tuples in R_e with u(X) = x (heavy x) and u(other) light
      * pair[(e, x, y)]  = #tuples in R_e equal to the heavy-heavy pair (x, y)
                           (key ordered by the relation's scheme)
      * light_cnt[e]     = #tuples in R_e that are light on both attributes
    """

    lam: int
    m: int
    heavy: Dict[Attr, np.ndarray]
    cond: Dict[Tuple[Edge, Attr, int], int]
    pair: Dict[Tuple[Edge, int, int], int]
    light_cnt: Dict[Edge, int]

    def is_heavy(self, attr: Attr, values: np.ndarray) -> np.ndarray:
        hv = self.heavy.get(attr)
        if hv is None or hv.size == 0:
            return np.zeros(values.shape, dtype=bool)
        idx = np.searchsorted(hv, values)
        idx = np.clip(idx, 0, hv.size - 1)
        return hv[idx] == values

    def n_heavy(self) -> int:
        return sum(int(v.size) for v in self.heavy.values())


def _unique_counts(rel: Relation, col: int, memo: Optional[Dict]):
    """np.unique(column, return_counts=True) with an optional cross-query memo.

    ``memo`` is keyed by (physical table id, column): queries in one service
    batch that bind the same ``Relation.table`` share the sort behind the
    unique-count pass — the expensive part of ``compute_stats`` — once per
    table instead of once per query.  Guarded by the same data-identity check
    as the shared-input Scatter, so a stray relation reusing a table id with
    different tuples falls back to its own computation."""
    if memo is None or rel.table is None:
        return np.unique(rel.data[:, col], return_counts=True)
    key = (rel.table, col)
    hit = memo.get(key)
    if hit is not None and (hit[0] is rel.data or np.array_equal(hit[0], rel.data)):
        return hit[1]
    out = np.unique(rel.data[:, col], return_counts=True)
    if key not in memo:
        memo[key] = (rel.data, out)
    return out


def compute_stats(
    query: JoinQuery, lam: int, unique_memo: Optional[Dict] = None
) -> HeavyStats:
    """Exact heavy statistics (the MPC protocol that distributes these is in
    repro.mpc.statistics; this is the ground-truth computation used by the planner
    and by tests).  ``unique_memo`` optionally shares the per-table unique-count
    pass across queries binding the same physical table (see
    :func:`_unique_counts` — the service layer's batch path)."""
    m = query.m
    threshold = max(1, -(-m // lam))  # ceil(m / lam)
    heavy_sets: Dict[Attr, Set[int]] = {}
    for rel in query.relations:
        for col, attr in enumerate(rel.scheme):
            vals, cnts = _unique_counts(rel, col, unique_memo)
            hv = vals[cnts >= threshold]
            if hv.size:
                heavy_sets.setdefault(attr, set()).update(hv.tolist())
    heavy = {a: np.array(sorted(s), dtype=np.int64) for a, s in heavy_sets.items()}

    stats = HeavyStats(lam=lam, m=m, heavy=heavy, cond={}, pair={}, light_cnt={})
    for rel in query.relations:
        e = rel.edge
        if rel.arity != 2:
            # general route: only the all-light count is meaningful — the
            # cond/pair extended records are binary-taxonomy machinery the
            # general compiler never reads.
            heavy_any = np.zeros(len(rel), dtype=bool)
            for attr in rel.scheme:
                heavy_any |= stats.is_heavy(attr, rel.column(attr))
            stats.light_cnt[e] = int((~heavy_any).sum())
            continue
        x_attr, y_attr = rel.scheme
        hx = stats.is_heavy(x_attr, rel.column(x_attr))
        hy = stats.is_heavy(y_attr, rel.column(y_attr))
        stats.light_cnt[e] = int((~hx & ~hy).sum())
        # heavy on X, light on Y
        sel = hx & ~hy
        vals, cnts = np.unique(rel.column(x_attr)[sel], return_counts=True)
        for v, c in zip(vals.tolist(), cnts.tolist()):
            stats.cond[(e, x_attr, v)] = c
        sel = hy & ~hx
        vals, cnts = np.unique(rel.column(y_attr)[sel], return_counts=True)
        for v, c in zip(vals.tolist(), cnts.tolist()):
            stats.cond[(e, y_attr, v)] = c
        sel = hx & hy
        if sel.any():
            pairs = rel.data[sel]
            uniq, cnts = np.unique(pairs, axis=0, return_counts=True)
            for (vx, vy), c in zip(uniq.tolist(), cnts.tolist()):
                stats.pair[(e, vx, vy)] = int(c)
    return stats


@dataclass(frozen=True)
class Configuration:
    """A configuration η of H: heavy value per attribute of H (paper Sec. 4)."""

    attrs: Tuple[Attr, ...]           # sorted H
    values: Tuple[int, ...]

    def value(self, attr: Attr) -> int:
        return self.values[self.attrs.index(attr)]

    def as_dict(self) -> Dict[Attr, int]:
        return dict(zip(self.attrs, self.values))


def configurations(stats: HeavyStats, h_set: Sequence[Attr]) -> Iterator[Configuration]:
    """Enumerate config(Q, H): all heavy-value combinations over H. O(λ^{|H|})."""
    attrs = tuple(sorted(h_set))
    if not attrs:
        yield Configuration(attrs=(), values=())
        return
    pools = []
    for a in attrs:
        hv = stats.heavy.get(a)
        if hv is None or hv.size == 0:
            return  # no configuration exists
        pools.append(hv.tolist())
    for combo in itertools.product(*pools):
        yield Configuration(attrs=attrs, values=tuple(combo))


# ---------------------------------------------------------------------------
# Structure of the residual query under H (paper Sec. 5.1) — depends on H only.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HPlan:
    """Combinatorial structure shared by all configurations of a fixed H."""

    h_set: Tuple[Attr, ...]           # heavy attributes (sorted)
    light: Tuple[Attr, ...]           # L = attset \ H (sorted)
    isolated: Tuple[Attr, ...]        # I ⊆ L (paper (5.3))
    border: Tuple[Attr, ...]          # light attrs on ≥1 cross edge
    light_edges: Tuple[Edge, ...]     # both endpoints light
    cross_edges: Tuple[Edge, ...]     # one endpoint heavy, one light
    heavy_edges: Tuple[Edge, ...]     # both endpoints heavy


def plan_for_h(query: JoinQuery, h_set: Sequence[Attr]) -> HPlan:
    h = set(h_set)
    attset = set(query.attset)
    if not h <= attset:
        raise ValueError("H must be a subset of attset(Q)")
    light = attset - h
    light_edges, cross_edges, heavy_edges = [], [], []
    for rel in query.relations:
        e = rel.edge
        n_heavy = len(e & h)
        if n_heavy == 0:
            light_edges.append(e)
        elif n_heavy == 1:
            cross_edges.append(e)
        else:
            heavy_edges.append(e)
    border = {next(iter(e - h)) for e in cross_edges}
    # isolated: light attrs not incident to any light edge
    non_isolated = {v for e in light_edges for v in e}
    isolated = light - non_isolated
    return HPlan(
        h_set=tuple(sorted(h)),
        light=tuple(sorted(light)),
        isolated=tuple(sorted(isolated)),
        border=tuple(sorted(border)),
        light_edges=tuple(sorted(light_edges, key=lambda e: sorted(e))),
        cross_edges=tuple(sorted(cross_edges, key=lambda e: sorted(e))),
        heavy_edges=tuple(sorted(heavy_edges, key=lambda e: sorted(e))),
    )


def residual_size(
    query: JoinQuery, stats: HeavyStats, plan: HPlan, eta: Configuration
) -> int:
    """m_η: total input size of Q'(η), computed exactly from the extended histogram
    (paper Step 1 requires every machine to know m_η; see DESIGN.md §6)."""
    h = set(plan.h_set)
    total = 0
    for rel in query.relations:
        e = rel.edge
        x_attr, y_attr = rel.scheme
        inter = e & h
        if len(inter) == 0:
            total += stats.light_cnt[e]
        elif len(inter) == 1:
            (hx,) = inter
            total += stats.cond.get((e, hx, eta.value(hx)), 0)
        # |e∩H| == 2 → inactive edge: contributes no residual relation
    return total


def config_feasible(
    query: JoinQuery, stats: HeavyStats, plan: HPlan, eta: Configuration
) -> bool:
    """Inactive-edge feasibility of η from the extended histogram: every edge
    with both attributes in H must actually contain the η-pair, else Q'(η) is
    empty.  Every machine holds the histogram, so ruled-out configurations
    cost no communication (paper Sec. 6; the IR compiler consumes this)."""
    return all(
        heavy_pair_present(stats, query.relation_for(e), eta) for e in plan.heavy_edges
    )


def heavy_pair_present(
    stats: HeavyStats, rel: Relation, eta: Configuration
) -> bool:
    """For an inactive edge (both attrs heavy): does R_e contain the η-pair? If not,
    Q'(η) is empty (paper Sec. 1.3 example, R'_{D,K})."""
    x_attr, y_attr = rel.scheme
    key = (rel.edge, eta.value(x_attr), eta.value(y_attr))
    return stats.pair.get(key, 0) > 0


def heavy_masks(
    query: JoinQuery, stats: HeavyStats
) -> Dict[Edge, Tuple[np.ndarray, np.ndarray]]:
    """Per-edge (hx, hy) heavy masks, computed once per run.

    A stage-heavy program calls :func:`residual_relations` once per (H, η)
    stage; without this cache every call recomputes the same O(m) masks.
    Relations sharing a physical ``table`` additionally share the mask of any
    (attribute, column) they have in common — the self-join fast path: k
    pattern-edge copies of one edge set pay for each distinct mask once.
    Sharing is guarded by the same data check as the shared-input Scatter
    (``place_inputs``): a stray relation reusing a table id with different
    tuples falls back to its own mask instead of silently borrowing one."""
    cache: Dict[Tuple[str, Attr, int], Tuple[np.ndarray, np.ndarray]] = {}
    out: Dict[Edge, Tuple[np.ndarray, np.ndarray]] = {}
    for rel in query.relations:
        ms = []
        for col, attr in enumerate(rel.scheme):
            key = (rel.table, attr, col) if rel.table is not None else None
            m = None
            if key is not None and key in cache:
                data_ref, cached = cache[key]
                if data_ref is rel.data or np.array_equal(data_ref, rel.data):
                    m = cached
            if m is None:
                m = stats.is_heavy(attr, rel.data[:, col])
                if key is not None and key not in cache:
                    cache[key] = (rel.data, m)
            ms.append(m)
        out[rel.edge] = (ms[0], ms[1])
    return out


def sorted_rows(query: JoinQuery) -> Dict[Edge, bool]:
    """Per edge, whether its relation's rows are sorted and unique
    (:func:`rows_sorted_unique`), computed once per run like
    :func:`heavy_masks` and once per distinct ``data`` object: the k
    pattern-edge copies of one shared edge table pay for one O(m) check."""
    seen: Dict[int, bool] = {}
    out: Dict[Edge, bool] = {}
    for rel in query.relations:
        key = id(rel.data)      # the query holds every array alive meanwhile
        if key not in seen:
            seen[key] = rows_sorted_unique(rel.data)
        out[rel.edge] = seen[key]
    return out


def _residual(scheme: Tuple[Attr, ...], rows: np.ndarray, ordered: bool) -> Relation:
    if ordered:
        return Relation(scheme=scheme, data=np.asarray(rows, dtype=np.int64))
    return Relation.make(scheme, rows)


def residual_relations(
    query: JoinQuery,
    stats: HeavyStats,
    plan: HPlan,
    eta: Configuration,
    masks: Optional[Dict[Edge, Tuple[np.ndarray, np.ndarray]]] = None,
    ordered: Optional[Dict[Edge, bool]] = None,
) -> Optional[Dict[Tuple[Edge, Tuple[Attr, ...]], Relation]]:
    """Materialize Q'(η) in one process (oracle path for tests; the distributed path
    lives in repro.mpc.engine). Returns None if some inactive edge rules η out.

    Key: (original edge e, residual scheme e') — distinct cross edges can produce
    distinct unary relations over the same attribute, so e is part of the key.

    ``masks`` optionally supplies precomputed :func:`heavy_masks` so a caller
    evaluating many configurations does not recompute them per stage;
    ``ordered`` likewise supplies :func:`sorted_rows` (checked here per
    relation when absent).

    Every residual comes back sorted and unique, as :meth:`Relation.make`
    gives it.  Where the parent's rows already are, the residual is built
    from the masked rows with no ``np.unique``, which would return them
    unchanged: a masked subset of strictly increasing rows is strictly
    increasing, and so are a cross edge's light values, since the rows kept
    share the heavy column's value η(X) and the parent's (x, y) pairs are
    unique and ordered by x, then y.  Any other parent (``Relation(...)``
    built directly) is deduplicated as before.
    """
    h = set(plan.h_set)
    out: Dict[Tuple[Edge, Tuple[Attr, ...]], Relation] = {}
    for rel in query.relations:
        e = rel.edge
        inter = e & h
        if len(inter) == 2:
            if not heavy_pair_present(stats, rel, eta):
                return None
            continue
        x_attr, y_attr = rel.scheme
        if masks is not None:
            hx, hy = masks[e]
        else:
            hx = stats.is_heavy(x_attr, rel.column(x_attr))
            hy = stats.is_heavy(y_attr, rel.column(y_attr))
        sorted_parent = ordered[e] if ordered is not None else rows_sorted_unique(rel.data)
        if len(inter) == 0:
            sel = ~hx & ~hy
            out[(e, rel.scheme)] = _residual(rel.scheme, rel.data[sel], sorted_parent)
        else:
            (heavy_attr,) = inter
            light_attr = y_attr if heavy_attr == x_attr else x_attr
            heavy_col = rel.column(heavy_attr)
            light_is = ~(hy if light_attr == y_attr else hx)
            sel = (heavy_col == eta.value(heavy_attr)) & light_is
            out[(e, (light_attr,))] = _residual(
                (light_attr,), rel.column(light_attr)[sel].reshape(-1, 1), sorted_parent
            )
    return out
