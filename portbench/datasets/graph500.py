"""Graph500 Kronecker graphs for triangle enumeration (numpy only).

The draws follow the Graph500 specification's generator (initiator A, B, C;
``edgefactor`` x 2^scale edges; one bit per level for each endpoint, then the
spec's vertex permutation and edge shuffle) from the configuration's fixed
``draw_seed``.  Self-loops and repeated edges are dropped and each edge is
kept once, from the lower to the higher (degree, id) rank, so each triangle
appears once as R(A,B) S(B,C) T(A,C).

Each query of a mix joins the graph under a vertex labelling of its own.
Where the hubs land in the program's hash routing sets its per-machine
capacities, and with them the time and memory of a query (at scale 17 one
labelling in two took ~15% longer and a third more card memory, and a run of
one labelling repeated its time on the same labelling), so the labellings
come from a fixed stream (``LABELS_DRAW_SEED``): every run joins the same set
of labelled tables, and ``--seed`` draws the order in which the mix submits
them.  (Drawing the labellings, or the Kronecker edges, from the seed changed
the work itself: two seeds in seven drew a graph that took up to half as long
again a query.)
"""

from __future__ import annotations

import numpy as np

#: the fixed stream the mix's vertex labellings are drawn from
LABELS_DRAW_SEED = 1


def kronecker_edges(rng: np.random.Generator, scale: int, edgefactor: int,
                    initiator) -> np.ndarray:
    """(edgefactor * 2^scale, 2) int64 endpoint draws, as the Graph500
    specification's reference generator makes them."""
    a, b, c = initiator
    n, m = 1 << scale, edgefactor << scale
    ab = a + b
    c_norm, a_norm = c / (1 - ab), a / ab
    ij = np.zeros((2, m), np.int64)
    for level in range(scale):
        ii = rng.random(m) > ab
        jj = rng.random(m) > (c_norm * ii + a_norm * ~ii)
        ij[0] += ii.astype(np.int64) << level
        ij[1] += jj.astype(np.int64) << level
    ij = rng.permutation(n)[ij]
    return ij[:, rng.permutation(m)].T


def normalize(edges: np.ndarray) -> np.ndarray:
    """Undirected simple graph: self-loops dropped, each edge once as u < v."""
    e = edges[edges[:, 0] != edges[:, 1]]
    lo, hi = np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])
    return np.unique(np.stack([lo, hi], axis=1), axis=0)


def orient_by_degree(edges: np.ndarray, n_vertices: int) -> np.ndarray:
    """Each edge kept once, from the lower to the higher (degree, id) rank, so
    every triangle matches R(A,B) S(B,C) T(A,C) exactly once."""
    deg = np.bincount(edges.reshape(-1), minlength=n_vertices)
    rank = np.empty(n_vertices, np.int64)
    rank[np.lexsort((np.arange(n_vertices), deg))] = np.arange(n_vertices)
    swap = rank[edges[:, 0]] > rank[edges[:, 1]]
    lo = np.where(swap, edges[:, 1], edges[:, 0])
    hi = np.where(swap, edges[:, 0], edges[:, 1])
    return np.stack([lo, hi], axis=1)


def make(config: dict, rng: np.random.Generator) -> dict:
    """The configuration's oriented edge table (the same for every seed)."""
    n = 1 << config["scale"]
    drawn = kronecker_edges(np.random.default_rng(config["draw_seed"]), config["scale"],
                            config["edgefactor"], config["initiator"])
    return {"edges": orient_by_degree(normalize(drawn), n), "vertices": n}


def draw_variants(family: str, rng: np.random.Generator, count: int) -> list:
    """The mix's ``count`` vertex labellings, each from its own stream: the
    same set for every seed, drawn from ``LABELS_DRAW_SEED``, in an order drawn
    from ``rng``."""
    if family != "triangle":
        raise ValueError(f"graph500 has no query family {family!r}")
    seeds = np.random.default_rng(LABELS_DRAW_SEED).integers(0, 2**63, count)
    return [{"labels": int(seeds[i])} for i in rng.permutation(count)]


def query(family: str, data: dict, params: dict) -> list:
    """The query as (scheme, rows, table) triples under the variant's
    labelling; the three relations of the triangle bind one physical table."""
    if family != "triangle":
        raise ValueError(f"graph500 has no query family {family!r}")
    labels = np.random.default_rng(params["labels"]).permutation(data["vertices"])
    e = labels[data["edges"]]
    return [(("A", "B"), e, "E"), (("B", "C"), e, "E"), (("A", "C"), e, "E")]
