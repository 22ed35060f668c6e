"""Hypergraphs of join queries + fractional edge covers/packings (paper Sec. 2).

All queries here are *constant-size* (data complexity), so the LPs are tiny and are
solved exactly on the launcher host:

  - ``fractional_edge_cover``   -> (rho, weights)    [min  sum w_e  s.t. vertex weight >= 1]
  - ``fractional_edge_packing`` -> (tau, weights)    [max  sum w_e  s.t. vertex weight <= 1]
  - ``zero_one_packing``        -> Lemma 2.1(2): an optimal packing whose *vertex* weights
    are all 0 or 1, and the zero-weight set Z satisfies rho - tau = |Z|.

For binary graphs the LP polytopes have half-integral vertices whose half-weight support
is a disjoint union of odd cycles; the simplex method therefore returns solutions with
0/1 vertex weights, which we verify (and re-solve with a perturbed objective if a
degenerate non-vertex optimum sneaks through).

Edges of arbitrary arity (the general-join route) are supported: the LP vertices
are then rational but not necessarily half-integral, so the solutions are
recovered as small-denominator fractions (checked for feasibility + optimality)
instead of the binary half-integral rounding.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

import numpy as np
from scipy.optimize import linprog

Vertex = str
Edge = FrozenSet[Vertex]


def _as_edge(e) -> Edge:
    e = frozenset(e)
    if len(e) < 1:
        raise ValueError("edges need at least one vertex")
    return e


@dataclass(frozen=True)
class Hypergraph:
    """A hypergraph with edges of any arity ≥ 1; every vertex incident to >= 1 edge.

    The paper's Theorem 6.2 machinery only consumes unary/binary graphs
    (``is_binary``); k-ary edges arise from general join queries and feed the
    GYO/join-tree and HyperCube-shares route."""

    vertices: Tuple[Vertex, ...]
    edges: Tuple[Edge, ...]

    @staticmethod
    def from_edges(edges: Sequence) -> "Hypergraph":
        es = tuple(sorted({_as_edge(e) for e in edges}, key=lambda e: sorted(e)))
        vs = tuple(sorted({v for e in es for v in e}))
        return Hypergraph(vertices=vs, edges=es)

    def __post_init__(self):
        covered = {v for e in self.edges for v in e}
        missing = set(self.vertices) - covered
        if missing:
            raise ValueError(f"vertices with no incident edge: {missing}")

    @property
    def is_binary(self) -> bool:
        return all(len(e) == 2 for e in self.edges)

    def incident(self, v: Vertex) -> List[Edge]:
        return [e for e in self.edges if v in e]

    def adjacent(self, v: Vertex) -> Set[Vertex]:
        return {u for e in self.edges for u in e if v in e} - {v}

    def induced(self, subset: Sequence[Vertex]) -> "Hypergraph":
        """Subgraph induced by ``subset`` (paper Sec. 2): edges e∩U, dropping empties."""
        u = set(subset)
        es = {frozenset(e & u) for e in self.edges if e & u}
        vs = tuple(sorted(v for v in self.vertices if v in u))
        return Hypergraph(vertices=vs, edges=tuple(sorted(es, key=lambda e: sorted(e))))

    def remove_vertices(self, removed: Sequence[Vertex]) -> "Hypergraph":
        """G_\\U of the quasi-packing definition: strip U from every edge."""
        u = set(removed)
        es = {frozenset(e - u) for e in self.edges if e - u}
        vs = tuple(sorted({v for e in es for v in e}))
        return Hypergraph(vertices=vs, edges=tuple(sorted(es, key=lambda e: sorted(e))))


# ---------------------------------------------------------------------------
# LP solvers
# ---------------------------------------------------------------------------


def _vertex_weights(g: Hypergraph, w: Dict[Edge, Fraction]) -> Dict[Vertex, Fraction]:
    out = {v: Fraction(0) for v in g.vertices}
    for e, we in w.items():
        for v in e:
            out[v] += we
    return out


def _round_half(x: float) -> Fraction:
    return Fraction(round(x * 2), 2)


_GENERAL_DENOMS = (1, 2, 3, 4, 5, 6, 8, 12, 24, 60, 120)


def _recover_rational(g: Hypergraph, edges, x, obj: float, cover: bool):
    """Round a float LP solution to exact Fractions, checked for feasibility and
    optimality.  Binary graphs have half-integral vertices (the Lemma 2.1 fact
    the taxonomy relies on); general (k-ary-edge) graphs get a small-denominator
    search — basic solutions of constant-size LPs have small rational entries."""
    denoms = (2,) if g.is_binary else _GENERAL_DENOMS
    for d in denoms:
        w = {e: Fraction(round(v * d), d) for e, v in zip(edges, x)}
        total = sum(w.values())
        if abs(float(total) - obj) > 1e-6:
            continue
        vw = _vertex_weights(g, w)
        if all((vw[v] >= 1 if cover else vw[v] <= 1) for v in g.vertices):
            return total, w
    return None


def _solve_lp(g: Hypergraph, *, cover: bool, rng_seed: int = 0):
    """Shared LP: cover (minimize, >=1) or packing (maximize, <=1). Returns Fractions."""
    edges = list(g.edges)
    nv, ne = len(g.vertices), len(edges)
    vidx = {v: i for i, v in enumerate(g.vertices)}
    A = np.zeros((nv, ne))
    for j, e in enumerate(edges):
        for v in e:
            A[vidx[v], j] = 1.0
    # linprog minimizes c @ x with A_ub x <= b_ub.
    for attempt in range(3):
        c = np.ones(ne)
        if attempt > 0:  # nudge the objective to force a unique vertex optimum
            rng = np.random.default_rng(rng_seed + attempt)
            c = c + rng.uniform(0, 1e-7, size=ne)
        if cover:
            res = linprog(c, A_ub=-A, b_ub=-np.ones(nv), bounds=(0, 1), method="highs-ds")
        else:
            res = linprog(-c, A_ub=A, b_ub=np.ones(nv), bounds=(0, 1), method="highs-ds")
        if not res.success:
            raise RuntimeError(f"LP failed on {g}: {res.message}")
        obj = float(sum(res.x))
        recovered = _recover_rational(g, edges, res.x, obj, cover)
        if recovered is not None:
            return recovered
    raise RuntimeError(f"could not recover a rational LP optimum for {g}")


def fractional_edge_cover(g: Hypergraph) -> Tuple[Fraction, Dict[Edge, Fraction]]:
    """rho(G) and an optimal half-integral fractional edge cover."""
    return _solve_lp(g, cover=True)


def fractional_edge_packing(g: Hypergraph) -> Tuple[Fraction, Dict[Edge, Fraction]]:
    """tau(G) and an optimal half-integral fractional edge packing."""
    return _solve_lp(g, cover=False)


def rho(g) -> Fraction:
    """ρ: the fractional edge cover number (exact, as a Fraction).

    Accepts either a :class:`Hypergraph` or any object exposing a
    ``.hypergraph`` attribute (a :class:`repro.core.query.JoinQuery`,
    duck-typed to avoid a circular import) — so ρ call sites stop
    hand-building ``fractional_edge_cover(query.hypergraph)[0]``."""
    if not isinstance(g, Hypergraph):
        hg = getattr(g, "hypergraph", None)
        if not isinstance(hg, Hypergraph):
            raise TypeError(
                f"rho() wants a Hypergraph or an object with a .hypergraph "
                f"attribute, got {type(g).__name__}"
            )
        g = hg
    return fractional_edge_cover(g)[0]


def tau(g: Hypergraph) -> Fraction:
    return fractional_edge_packing(g)[0]


def zero_one_packing(
    g: Hypergraph,
) -> Tuple[Fraction, Dict[Edge, Fraction], Set[Vertex]]:
    """Lemma 2.1 bullet 2: an optimal fractional edge packing W whose vertex weights are
    all 0/1; returns (tau, W, Z) with Z = zero-weight vertices and rho - tau = |Z|.

    Simplex returns a vertex of the fractional matching polytope; for (multi)graphs those
    are half-integral with half-edges forming vertex-disjoint odd cycles, hence vertex
    weights 0/1. We assert this (with perturbation retries inside _solve_lp).
    """
    for seed in range(5):
        t, w = _solve_lp(g, cover=False, rng_seed=seed * 17)
        vw = _vertex_weights(g, w)
        if all(x in (Fraction(0), Fraction(1)) for x in vw.values()):
            z = {v for v, x in vw.items() if x == 0}
            return t, w, z
    raise RuntimeError(f"no 0/1-vertex-weight optimal packing found for {g}")


def quasi_packing_number(g: Hypergraph) -> Fraction:
    """psi(G) = max over U ⊆ V of tau(G_\\U) (paper Sec. 2). Exponential in |V| — fine,
    queries are constant-size. Used only for analysis/benchmarks."""
    best = Fraction(0)
    for r in range(len(g.vertices) + 1):
        for u in itertools.combinations(g.vertices, r):
            sub = g.remove_vertices(u)
            if not sub.edges:
                continue
            best = max(best, tau(sub))
    return best


def agm_bound(g: Hypergraph, sizes: Dict[Edge, int], w: Dict[Edge, Fraction]) -> float:
    """AGM bound (Lemma 2.2): prod_e |R_e|^{W(e)} for a fractional edge cover W."""
    out = 1.0
    for e, we in w.items():
        if we > 0:
            out *= float(sizes[e]) ** float(we)
    return out
