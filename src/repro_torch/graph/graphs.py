"""Data graphs for subgraph enumeration: loaders and seeded generators.

A :class:`Graph` is a simple undirected graph held as a normalized edge
array: shape (m, 2) int64, u < v per row, rows unique, self-loops dropped —
exactly the physical table the pattern compiler copies per pattern edge.
Generators (Erdős–Rényi, Zipf/power-law) are `np.random.Generator`-seeded so
tests, benchmarks, and examples share reproducible inputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np


@dataclass(frozen=True)
class Graph:
    """Simple undirected graph: ``edges`` (m, 2) int64, u < v, unique rows."""

    n_vertices: int
    edges: np.ndarray

    @staticmethod
    def from_edges(
        edges: np.ndarray, n_vertices: Optional[int] = None
    ) -> "Graph":
        """Normalize an arbitrary edge-list array: canonical u < v endpoint
        order, duplicate edges and self-loops dropped."""
        arr = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if arr.size and arr.min() < 0:
            raise ValueError("vertex ids must be non-negative")
        arr = arr[arr[:, 0] != arr[:, 1]]                       # self-loops
        lo = np.minimum(arr[:, 0], arr[:, 1])
        hi = np.maximum(arr[:, 0], arr[:, 1])
        arr = np.unique(np.stack([lo, hi], axis=1), axis=0)
        if n_vertices is None:
            n_vertices = int(arr.max()) + 1 if arr.size else 0
        elif arr.size and int(arr.max()) >= n_vertices:
            raise ValueError("edge endpoint exceeds n_vertices")
        return Graph(n_vertices=int(n_vertices), edges=arr)

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    def degrees(self) -> np.ndarray:
        """(n_vertices,) undirected degree per vertex."""
        deg = np.zeros(self.n_vertices, dtype=np.int64)
        if self.edges.size:
            np.add.at(deg, self.edges[:, 0], 1)
            np.add.at(deg, self.edges[:, 1], 1)
        return deg

    def symmetrized(self) -> np.ndarray:
        """(2m, 2) both orientations of every edge (the unoriented table)."""
        if not self.edges.size:
            return self.edges.reshape(0, 2)
        return np.concatenate([self.edges, self.edges[:, ::-1]], axis=0)


def load_edge_list(path: Union[str, "os.PathLike"]) -> Graph:  # noqa: F821
    """Whitespace-separated ``u v`` text file (``#`` comments) → Graph."""
    arr = np.loadtxt(path, dtype=np.int64, comments="#", ndmin=2)
    return Graph.from_edges(arr)


def erdos_renyi(
    rng: np.random.Generator, n_vertices: int, n_edges: int
) -> Graph:
    """G(n, m)-style: ``n_edges`` distinct uniform edges (best effort — dense
    requests near the complete graph may return slightly fewer)."""
    if n_vertices < 2:
        return Graph(n_vertices=n_vertices, edges=np.zeros((0, 2), np.int64))
    collected = np.zeros((0, 2), np.int64)
    for _ in range(64):
        need = n_edges - collected.shape[0]
        if need <= 0:
            break
        u = rng.integers(0, n_vertices, size=2 * need)
        v = rng.integers(0, n_vertices, size=2 * need)
        batch = np.stack([u, v], axis=1)
        collected = Graph.from_edges(
            np.concatenate([collected, batch]), n_vertices
        ).edges
    return _trim(rng, collected, n_edges, n_vertices)


def _trim(
    rng: np.random.Generator, edges: np.ndarray, n_edges: int, n_vertices: int
) -> Graph:
    """Keep a uniform subset of ``n_edges`` rows (np.unique sorted them, so a
    prefix slice would bias toward low vertex ids)."""
    if edges.shape[0] > n_edges:
        keep = rng.permutation(edges.shape[0])[:n_edges]
        edges = edges[np.sort(keep)]
    return Graph(n_vertices=n_vertices, edges=edges)


def zipf_graph(
    rng: np.random.Generator,
    n_vertices: int,
    n_edges: int,
    skew: float = 1.0,
) -> Graph:
    """Power-law graph: both endpoints drawn ∝ rank^{-skew} (skew = 0 →
    uniform).  Heavy hubs are what make the join taxonomy fan out into
    cross-edge / isolated stages, exactly like ``zipf_relation`` does for
    synthetic relations."""
    if n_vertices < 2:
        return Graph(n_vertices=n_vertices, edges=np.zeros((0, 2), np.int64))
    ranks = np.arange(1, n_vertices + 1, dtype=np.float64)
    probs = ranks ** (-max(0.0, skew))
    probs /= probs.sum()
    collected = np.zeros((0, 2), np.int64)
    for _ in range(64):
        need = n_edges - collected.shape[0]
        if need <= 0:
            break
        u = rng.choice(n_vertices, size=2 * need, p=probs)
        v = rng.choice(n_vertices, size=2 * need, p=probs)
        batch = np.stack([u, v], axis=1)
        collected = Graph.from_edges(
            np.concatenate([collected, batch]), n_vertices
        ).edges
    return _trim(rng, collected, n_edges, n_vertices)


def vertex_order_rank(graph: Graph, mode: str = "degree") -> np.ndarray:
    """Strict total order on G's vertices as a rank array (rank[v] = position).

    ``"id"``: by vertex id.  ``"degree"``: by (degree, id) — the classic
    triangle-counting orientation; every oriented out-neighborhood is
    O(√m)-ish on real graphs, which shrinks the oriented join's intermediate
    sizes.  Any strict total order is sound for symmetry breaking; the mode
    only affects performance."""
    n = graph.n_vertices
    if mode == "id":
        return np.arange(n, dtype=np.int64)
    if mode == "degree":
        order = np.lexsort((np.arange(n), graph.degrees()))
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.arange(n)
        return rank
    raise ValueError(f"unknown vertex order {mode!r} (want 'id' or 'degree')")
