"""Constant-size graph patterns: DSL, automorphisms, symmetry-breaking orientation.

Subgraph enumeration — reporting every occurrence of a constant-size pattern
P in a data graph G — is the paper's headline corollary workload (Sec. 1.4):
give every pattern vertex an attribute and let every pattern edge bind a
logical copy of G's edge relation; the rows of Join(Q) are exactly the
homomorphisms P → G, at load Õ(|E| / p^{1/ρ(P)}).

Raw homomorphisms over-report, in two independent ways:

  * **automorphisms** — an occurrence (a subgraph of G isomorphic to P) is hit
    once per σ ∈ Aut(P): 6× for a triangle, 8× for a 4-cycle;
  * **non-injectivity** — a homomorphism may collapse non-adjacent pattern
    vertices (a 4-cycle row with X0 = X2 is a path walked back and forth).

Both are handled here.  The automorphism blow-up is attacked at the *input*
with the classic orientation trick: fix a strict total order on G's vertices
(by id, or by degree with id tie-break — the O(m^{3/2}) triangle-counting
order) and replace the symmetric edge table (2|E| rows) by the oriented one
(|E| rows) for pattern edges carrying a constraint u → v ("the G-vertex bound
to u precedes the one bound to v").  A constraint set C is **sound** iff every
occurrence keeps ≥ 1 satisfying embedding — equivalently, for every linear
order on V(P) some σ ∈ Aut(P) maps it onto one satisfying C — and **complete**
iff exactly one survives.  Patterns are constant-size, so both properties are
decided by brute force over all |V(P)|! orders × Aut(P) (host-side planner
work, like the LP).  ``plan_orientation`` greedily orients edges while
soundness holds; cliques short-circuit to the total orientation, which is
complete, kills the 2|E| symmetrization, *and* implies injectivity.  Whatever
symmetry (or collapsibility) survives an incomplete orientation is removed
post-hoc: ``canonical_rows`` maps every row to the lexicographically smallest
automorphic image, so each occurrence is reported exactly once.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

#: Automorphisms/orientation are brute-forced over vertex permutations —
#: fine for the constant-size patterns of the corollary, meaningless beyond.
MAX_PATTERN_VERTICES = 8

#: plan_orientation's greedy soundness search costs ~ |V|! · |Aut| · 2|E|
#: host-side ops; above this budget (huge-automorphism near-cliques) it
#: falls back to the always-sound empty orientation + post-hoc dedup.
_ORIENTATION_BUDGET = 30_000_000


@dataclass(frozen=True)
class Pattern:
    """A constant-size undirected pattern: vertices 0..n-1, normalized edges."""

    name: str
    n_vertices: int
    edges: Tuple[Tuple[int, int], ...]   # (u, v) with u < v, sorted, unique

    @staticmethod
    def make(
        name: str, n_vertices: int, edges: Sequence[Tuple[int, int]]
    ) -> "Pattern":
        if not 1 <= n_vertices <= MAX_PATTERN_VERTICES:
            raise ValueError(
                f"patterns must have 1..{MAX_PATTERN_VERTICES} vertices, "
                f"got {n_vertices}"
            )
        norm: List[Tuple[int, int]] = []
        seen = set()
        for u, v in edges:
            u, v = int(u), int(v)
            if u == v:
                raise ValueError(f"pattern self-loop on vertex {u}")
            if not (0 <= u < n_vertices and 0 <= v < n_vertices):
                raise ValueError(f"edge ({u},{v}) outside 0..{n_vertices - 1}")
            e = (min(u, v), max(u, v))
            if e in seen:
                raise ValueError(f"duplicate pattern edge {e}")
            seen.add(e)
            norm.append(e)
        touched = {x for e in norm for x in e}
        if touched != set(range(n_vertices)):
            raise ValueError(
                "every pattern vertex must lie on an edge "
                f"(untouched: {sorted(set(range(n_vertices)) - touched)})"
            )
        return Pattern(name=name, n_vertices=n_vertices, edges=tuple(sorted(norm)))

    @property
    def k(self) -> int:
        return self.n_vertices

    def is_clique(self) -> bool:
        return len(self.edges) == self.n_vertices * (self.n_vertices - 1) // 2


# -- built-ins (the corollary's usual suspects) ------------------------------


def triangle() -> Pattern:
    """K_3 — the paper's canonical Sec. 1.4 example pattern."""
    return clique(3)


def clique(k: int) -> Pattern:
    """K_k: k vertices, all pairs adjacent."""
    if k < 2:
        raise ValueError("clique needs k >= 2")
    return Pattern.make(
        f"clique{k}", k, [(i, j) for i in range(k) for j in range(i + 1, k)]
    )


def cycle(k: int) -> Pattern:
    """C_k: k vertices in a cycle."""
    if k < 3:
        raise ValueError("cycle needs k >= 3")
    return Pattern.make(f"cycle{k}", k, [(i, (i + 1) % k) for i in range(k)])


def star(k: int) -> Pattern:
    """S_k: a hub (vertex 0) with k leaves."""
    if k < 1:
        raise ValueError("star needs k >= 1 leaves")
    return Pattern.make(f"star{k}", k + 1, [(0, i) for i in range(1, k + 1)])


def path(k: int) -> Pattern:
    """P_k: k vertices in a path (k - 1 edges)."""
    if k < 2:
        raise ValueError("path needs k >= 2 vertices")
    return Pattern.make(f"path{k}", k, [(i, i + 1) for i in range(k - 1)])


def from_edge_list(
    edges: Sequence[Tuple[int, int]], name: str = "custom"
) -> Pattern:
    """Arbitrary constant-size pattern given as an edge list; vertex ids are
    compacted to 0..n-1 preserving order."""
    verts = sorted({int(x) for e in edges for x in e})
    remap = {v: i for i, v in enumerate(verts)}
    return Pattern.make(name, len(verts), [(remap[u], remap[v]) for u, v in edges])


# -- automorphisms -----------------------------------------------------------


def automorphisms(pattern: Pattern) -> Tuple[Tuple[int, ...], ...]:
    """Aut(P) as vertex permutations, identity first (brute force — patterns
    are constant-size by construction)."""
    eset = set(pattern.edges)
    out = []
    for perm in itertools.permutations(range(pattern.n_vertices)):
        if all(
            (min(perm[u], perm[v]), max(perm[u], perm[v])) in eset
            for u, v in pattern.edges
        ):
            out.append(perm)
    return tuple(out)   # itertools yields the identity first


# -- symmetry-breaking orientation ------------------------------------------


@dataclass(frozen=True)
class OrientationPlan:
    """Directed constraints over pattern edges + what they do NOT guarantee.

    ``constraints``: (u, v) means the G-vertex bound to u must precede the one
    bound to v in the chosen total vertex order — compiled as the oriented
    edge table.  ``complete``: every occurrence keeps exactly one embedding
    (no post-hoc dedup needed).  ``needs_injectivity``: some vertex pair is
    neither adjacent nor ordered by the constraint closure, so join rows may
    collapse pattern vertices and must be filtered."""

    constraints: Tuple[Tuple[int, int], ...]
    complete: bool
    needs_injectivity: bool


def _min_max_survivors(
    n: int,
    autos: Sequence[Tuple[int, ...]],
    constraints: Sequence[Tuple[int, int]],
) -> Tuple[int, int]:
    """Over all linear orders on V(P): min/max #automorphisms mapping the
    order onto one satisfying ``constraints``.  min ≥ 1 ⇔ sound;
    min = max = 1 ⇔ complete."""
    lo, hi = len(autos), 0
    rank = [0] * n
    for order in itertools.permutations(range(n)):
        for r, v in enumerate(order):
            rank[v] = r
        cnt = 0
        for s in autos:
            if all(rank[s[u]] < rank[s[v]] for u, v in constraints):
                cnt += 1
        if cnt < lo:
            lo = cnt
        if cnt > hi:
            hi = cnt
    return lo, hi


def _pairs_separated(
    pattern: Pattern, constraints: Sequence[Tuple[int, int]]
) -> bool:
    """True iff every vertex pair is adjacent or strictly ordered by the
    transitive closure of the constraints (⇒ join rows are injective)."""
    n = pattern.n_vertices
    lt = [[False] * n for _ in range(n)]
    for u, v in constraints:
        lt[u][v] = True
    for w in range(n):          # transitive closure (n ≤ 8)
        for u in range(n):
            if lt[u][w]:
                for v in range(n):
                    if lt[w][v]:
                        lt[u][v] = True
    eset = set(pattern.edges)
    for u in range(n):
        for v in range(u + 1, n):
            if (u, v) not in eset and not (lt[u][v] or lt[v][u]):
                return False
    return True


def plan_orientation(pattern: Pattern) -> OrientationPlan:
    """Greedily orient pattern edges while the constraint set stays sound.

    Cliques short-circuit to the total orientation along vertex ids (sound
    and complete by construction: any occurrence's vertices admit exactly one
    order-respecting assignment, and injectivity is implied).  Otherwise each
    edge is tried in both directions and kept oriented when the brute-force
    soundness check passes; patterns whose |V|!·|Aut| search exceeds the
    budget keep the (always sound) empty orientation and rely on dedup."""
    n = pattern.n_vertices
    if pattern.is_clique():
        return OrientationPlan(
            constraints=pattern.edges, complete=True, needs_injectivity=False
        )
    autos = automorphisms(pattern)
    constraints: List[Tuple[int, int]] = []
    cost = math.factorial(n) * len(autos) * 2 * max(1, len(pattern.edges))
    if cost <= _ORIENTATION_BUDGET:
        for u, v in pattern.edges:
            for cand in ((u, v), (v, u)):
                lo, _ = _min_max_survivors(n, autos, constraints + [cand])
                if lo >= 1:
                    constraints.append(cand)
                    break
        lo, hi = _min_max_survivors(n, autos, constraints)
        complete = lo == hi == 1
    else:
        complete = len(autos) == 1
    return OrientationPlan(
        constraints=tuple(constraints),
        complete=complete,
        needs_injectivity=not _pairs_separated(pattern, constraints),
    )


# -- post-hoc canonicalization ----------------------------------------------


def canonical_rows(
    rows: np.ndarray, autos: Sequence[Tuple[int, ...]]
) -> np.ndarray:
    """Map each assignment row to its lexicographically smallest automorphic
    image: row r (r[i] = value of pattern vertex i) has images r[σ] for
    σ ∈ Aut(P); two rows are the same occurrence iff their images coincide.
    Vectorized lex-min over the |Aut| candidates; dedup is the caller's
    ``np.unique(..., axis=0)``."""
    rows = np.asarray(rows, dtype=np.int64)
    if rows.shape[0] == 0 or len(autos) <= 1:
        return rows
    best = rows[:, list(autos[0])].copy()
    k = rows.shape[1]
    for sigma in autos[1:]:
        cand = rows[:, list(sigma)]
        lt = np.zeros(rows.shape[0], dtype=bool)
        decided = np.zeros(rows.shape[0], dtype=bool)
        for c in range(k):
            l = ~decided & (cand[:, c] < best[:, c])
            g = ~decided & (cand[:, c] > best[:, c])
            lt |= l
            decided |= l | g
        best[lt] = cand[lt]
    return best
