"""Brute-force subgraph enumeration oracle (no join machinery shared).

Plain backtracking over adjacency sets: assign G-vertices to pattern vertices
in a connectivity-first order, prune by adjacency and injectivity, then
canonicalize through Aut(P) — the independent ground truth the engine
pipeline is tested against.  Test/bench-sized graphs only.
"""

from __future__ import annotations

from typing import List, Set, Tuple

import numpy as np

from .graphs import Graph
from .patterns import Pattern, automorphisms, canonical_rows


def brute_force_occurrences(graph: Graph, pattern: Pattern) -> np.ndarray:
    """(count, k) canonical, sorted occurrence rows — same format as
    :func:`repro_torch.graph.enumerate.postprocess_rows`."""
    n, k = graph.n_vertices, pattern.n_vertices
    adj: List[Set[int]] = [set() for _ in range(n)]
    for u, v in graph.edges.tolist():
        adj[u].add(v)
        adj[v].add(u)

    nbrs: List[Set[int]] = [set() for _ in range(k)]
    for u, v in pattern.edges:
        nbrs[u].add(v)
        nbrs[v].add(u)
    # connectivity-first vertex order: maximize anchored neighbors so the
    # candidate set is an adjacency intersection, not the whole vertex set
    order: List[int] = []
    remaining = set(range(k))
    while remaining:
        placed = set(order)
        best = max(
            remaining, key=lambda v: (len(nbrs[v] & placed), len(nbrs[v]), -v)
        )
        order.append(best)
        remaining.discard(best)
    depth_of = {v: d for d, v in enumerate(order)}

    found: Set[Tuple[int, ...]] = set()
    assign = [0] * k
    used: Set[int] = set()

    def rec(d: int) -> None:
        if d == k:
            found.add(tuple(assign))
            return
        v = order[d]
        anchored = [u for u in nbrs[v] if depth_of[u] < d]
        if anchored:
            cands = set(adj[assign[anchored[0]]])
            for u in anchored[1:]:
                cands &= adj[assign[u]]
        else:
            cands = set(range(n))
        for g in cands:
            if g in used:
                continue
            assign[v] = g
            used.add(g)
            rec(d + 1)
            used.discard(g)

    rec(0)
    if not found:
        return np.zeros((0, k), np.int64)
    rows = np.array(sorted(found), dtype=np.int64)
    canon = canonical_rows(rows, automorphisms(pattern))
    return np.unique(canon, axis=0)
