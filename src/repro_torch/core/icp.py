"""Isolated cartesian product theorem accounting (paper Sec. 5.3-5.5).

These functions compute both sides of:

  Theorem 5.1 :  Σ_η |Join(Q''_isolated(η))| ≤ λ^{|H| - W_I} · m^{|I|}
  Theorem 5.4 :  Σ_η |Join(Q''_J(η))|        ≤ λ^{|H| - W_J} · m^{|J|}   (J ⊆ I)
  Lemma   5.5 :  Σ_η |Join(Q''_J(η))|        ≤ λ^{2ρ - |J| - |L|} · m^{|J|}

used by benchmarks (empirical verification of the paper's central theorem) and by the
engine's machine-allocation sanity checks. The left-hand sides are exact sums over all
configurations; the right-hand sides come from the LP machinery in hypergraph.py.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, Iterable, Sequence, Tuple

from .hypergraph import Edge, Hypergraph, fractional_edge_cover, zero_one_packing
from .query import Attr, JoinQuery
from .semijoin import semijoin_reduce
from .taxonomy import Configuration, HPlan, HeavyStats, configurations, plan_for_h


def packing_weight_of(
    w: Dict[Edge, Fraction], vertices: Iterable[Attr]
) -> Fraction:
    """W_J = Σ_{Y∈J} (weight of Y under W)  (paper (5.10)/(5.15))."""
    total = Fraction(0)
    vs = set(vertices)
    for e, we in w.items():
        total += we * len(e & vs)
    return total


@dataclass
class ICPCheck:
    h_set: Tuple[Attr, ...]
    j_set: Tuple[Attr, ...]
    lhs: int                  # Σ_η |Join(Q''_J(η))|
    rhs_thm54: float          # λ^{|H|-W_J} m^{|J|}
    rhs_lem55: float          # λ^{2ρ-|J|-|L|} m^{|J|}

    @property
    def ok(self) -> bool:
        # Lemma 5.5's rhs is the weaker (larger) bound used by the allocator.
        return self.lhs <= self.rhs_lem55 + 1e-9


def icp_lhs(
    query: JoinQuery,
    stats: HeavyStats,
    plan: HPlan,
    j_set: Sequence[Attr],
) -> int:
    """Exact Σ_η Π_{X∈J} |R''_X(η)| over every configuration η of H."""
    total = 0
    for eta in configurations(stats, plan.h_set):
        reduced = semijoin_reduce(query, stats, plan, eta)
        if reduced is None:
            continue
        prod = 1
        for x in j_set:
            prod *= int(reduced.unary[x].size)
        total += prod
    return total


def icp_check(
    query: JoinQuery,
    stats: HeavyStats,
    h_set: Sequence[Attr],
    j_set: Sequence[Attr] | None = None,
) -> ICPCheck:
    """Empirically verify Theorem 5.4 / Lemma 5.5 for (H, J). J defaults to I."""
    g = query.hypergraph
    plan = plan_for_h(query, h_set)
    j = tuple(sorted(j_set)) if j_set is not None else plan.isolated
    if not set(j) <= set(plan.isolated):
        raise ValueError("J must be a subset of the isolated attributes I")

    lam, m = stats.lam, stats.m
    rho_val, _ = fractional_edge_cover(g)
    _, packing, _ = zero_one_packing(g)
    w_j = packing_weight_of(packing, j)

    lhs = icp_lhs(query, stats, plan, j) if j else 0
    rhs54 = float(lam) ** float(len(plan.h_set) - w_j) * float(m) ** len(j)
    exp55 = 2 * float(rho_val) - len(j) - len(plan.light)
    rhs55 = float(lam) ** exp55 * float(m) ** len(j)
    return ICPCheck(
        h_set=tuple(sorted(h_set)), j_set=j, lhs=lhs, rhs_thm54=rhs54, rhs_lem55=rhs55
    )


def all_icp_checks(query: JoinQuery, stats: HeavyStats) -> list[ICPCheck]:
    """Every (H, J ⊆ I) pair with J non-empty — the full hypothesis of Thm 5.4."""
    out = []
    attrs = query.attset
    for r in range(len(attrs) + 1):
        for h in itertools.combinations(attrs, r):
            plan = plan_for_h(query, h)
            iso = plan.isolated
            for jr in range(1, len(iso) + 1):
                for j in itertools.combinations(iso, jr):
                    out.append(icp_check(query, stats, h, j))
    return out
