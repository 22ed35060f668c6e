"""Query planner: machine allocation for Theorem 6.2 (paper Sec. 6).

The planner is host-side, O(poly(λ, 2^k)) metadata work (like a query optimizer):

  - heavy parameter       λ = Θ(p^{1/(2ρ)})                       [Sec. 6]
  - Step-1 groups         p'_η  = ⌈p · m_η / (m · λ^{k-2})⌉        [Step 1]
  - Step-3 groups         p''_η = Θ(λ^{|L|} + p·Σ_J |CP_J(η)| / (λ^{2ρ-|J|-|L|} m^{|J|}))
                                                                  [(6.1)]
  - HyperCube share       λ per attribute of L \\ I                [Lemma 6.1]
  - CP grid machines      p''_η / λ^{|L|-|I|}                      [Lemma 6.1]

Virtual machine groups are mapped onto the p physical machines by a deterministic salted
hash (virtual id v of group g → (base(g) + v) mod p). Σ_η p''_η = O(p) (via Lemma 5.5)
keeps physical loads balanced up to constants; the simulator meters the truth.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from .hypergraph import fractional_edge_cover
from .query import Attr, JoinQuery
from .taxonomy import Configuration, HPlan, HeavyStats


def heavy_parameter(p: int, rho_val: Fraction | float, c: float = 1.0) -> int:
    """λ = Θ(p^{1/(2ρ)}), at least 2 so 'heavy' is meaningful."""
    lam = int(max(2, round(c * p ** (1.0 / (2.0 * float(rho_val))))))
    return lam


def _stable_base(p: int, *key) -> int:
    h = hashlib.blake2b(repr(key).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % p


@dataclass(frozen=True)
class MachineGroup:
    """A virtual group of `size` machines hashed onto physical ids (mod p)."""

    base: int
    size: int
    p: int

    def phys(self, virtual: int) -> int:
        if not 0 <= virtual < self.size:
            raise IndexError(virtual)
        return (self.base + virtual) % self.p


@dataclass
class ConfigPlan:
    eta: Configuration
    m_eta: int
    step1_group: MachineGroup           # p'_η machines holding Q'(η)
    # step-3 geometry (filled after sizes are known):
    hc_shape: Tuple[int, ...] = ()      # λ per attr of L\I (possibly empty)
    cp_machines: int = 1
    step3_group: Optional[MachineGroup] = None

    @property
    def hc_machines(self) -> int:
        out = 1
        for s in self.hc_shape:
            out *= s
        return out


@dataclass
class HPlanWithAlloc:
    plan: HPlan
    configs: List[ConfigPlan] = field(default_factory=list)


def step1_allocation(
    query: JoinQuery,
    stats: HeavyStats,
    plan: HPlan,
    etas_with_sizes: Sequence[Tuple[Configuration, int]],
    p: int,
) -> List[ConfigPlan]:
    """p'_η = ⌈p · m_η / (m λ^{k-2})⌉, hashed onto physical machines."""
    k = len(query.attset)
    lam = stats.lam
    denom = max(1.0, float(stats.m) * float(lam) ** max(0, k - 2))
    out = []
    for eta, m_eta in etas_with_sizes:
        if m_eta <= 0:
            continue
        size = max(1, math.ceil(p * m_eta / denom))
        size = min(size, p)
        grp = MachineGroup(base=_stable_base(p, "s1", plan.h_set, eta.values), size=size, p=p)
        out.append(ConfigPlan(eta=eta, m_eta=m_eta, step1_group=grp))
    return out


def step3_allocation(
    query: JoinQuery,
    stats: HeavyStats,
    plan: HPlan,
    cfg: ConfigPlan,
    isolated_sizes: Dict[Attr, int],
    p: int,
    rho_val: float,
) -> None:
    """Fill cfg.hc_shape / cp_machines / step3_group per (6.1) + Lemma 6.1 geometry."""
    lam = stats.lam
    l_minus_i = [a for a in plan.light if a not in plan.isolated]
    n_iso = len(plan.isolated)

    # (6.1): p''_η = Θ(λ^{|L|} + p Σ_J |CP_J| / (λ^{2ρ-|J|-|L|} m^{|J|}))
    base_term = float(lam) ** len(plan.light)
    sum_term = 0.0
    sizes = [max(0, isolated_sizes[a]) for a in plan.isolated]
    # Σ over non-empty J ⊆ I of Π_{X∈J}|R''_X| / (λ^{2ρ-|J|-|L|} m^{|J|})
    import itertools as _it

    for jr in range(1, n_iso + 1):
        for combo in _it.combinations(range(n_iso), jr):
            prod = 1.0
            for i in combo:
                prod *= float(sizes[i])
            denom = float(lam) ** (2 * rho_val - jr - len(plan.light)) * float(stats.m) ** jr
            sum_term += prod / max(denom, 1e-30)
    p_eta = max(1, math.ceil(base_term + p * sum_term))

    cfg.hc_shape = tuple(lam for _ in l_minus_i)
    hc = cfg.hc_machines
    cp = max(1, math.ceil(p_eta / max(1, lam ** max(0, len(plan.light) - n_iso))))
    cfg.cp_machines = cp
    total = hc * cp
    cfg.step3_group = MachineGroup(
        base=_stable_base(p, "s3", plan.h_set, cfg.eta.values), size=total, p=p
    )


def grid_dims(sizes: Sequence[int], p_grid: int) -> Tuple[List[int], int, float]:
    """Lemma 3.1 geometry: given |R_1| ≥ ... ≥ |R_t| and p machines, choose t' and the
    grid p_1 × ... × p_{t'}. Returns (dims for the first t' lists, t', L_{t'}).

    Invariant (the Lemma 3.1 machine budget): Π dims ≤ p_grid and every dim ≥ 1,
    unconditionally — the rounding guard only ever decrements dims that are > 1,
    so a dimension can never reach 0 and the worst case is the all-ones grid
    (product 1 ≤ p_grid).  The previous guard decremented the overall max and
    clamped afterwards, which could reinstate Π dims > p_grid after driving a
    dimension to 0."""
    t = len(sizes)
    if p_grid < 1:
        raise ValueError(f"p_grid must be >= 1, got {p_grid}")
    if t == 0 or any(s <= 0 for s in sizes):
        raise ValueError("empty list ⇒ empty CP; caller must skip")
    assert all(sizes[i] >= sizes[i + 1] for i in range(t - 1)), "sizes must be sorted desc"

    def load_i(i: int) -> float:  # L_i = (Π_{j≤i} |R_j| / p)^{1/i}
        prod = 1.0
        for j in range(i):
            prod *= float(sizes[j])
        return (prod / float(p_grid)) ** (1.0 / i)

    t_prime = 1
    for i in range(1, t + 1):
        if all(sizes[j] >= load_i(i) for j in range(i)):
            t_prime = i
    l_t = max(load_i(t_prime), 1.0)
    dims = [max(1, int(sizes[i] // l_t)) for i in range(t_prime)]
    # rounding guard: decrement the largest dim that is still > 1 (identical
    # choice to the old guard while the max exceeds 1, so established grids
    # are unchanged) until the budget holds.
    while math.prod(dims) > p_grid:
        i_dec = max(
            (i for i, d in enumerate(dims) if d > 1), key=lambda i: dims[i], default=None
        )
        if i_dec is None:
            break  # all dims are 1 ⇒ product is 1 ≤ p_grid
        dims[i_dec] -= 1
    return dims, t_prime, l_t


@dataclass
class QueryPlan:
    """Everything Theorem 6.2 needs, for all H ⊆ attset(Q)."""

    p: int
    lam: int
    rho_val: float
    h_plans: Dict[Tuple[Attr, ...], HPlanWithAlloc]
