"""4-clique listing over a Graph500 Kronecker graph (numpy only).

The graph is ``graph500.py``'s: the Graph500 specification's draws from the
configuration's fixed ``draw_seed``, self-loops and repeated edges dropped,
each edge kept once from the lower to the higher (degree, id) rank.  Over
that one oriented table the 4-clique query is the self-join

    R(A,B) S(B,C) T(A,C) U(C,D) V(A,D) W(B,D),

which lists each 4-clique once, as its vertices in rank order A < B < C < D
(k-clique listing over a degree ordering, Danisch, Balalau and Sozio, WWW
2018).  As in ``graph500.py``, the mix's vertex labellings are one fixed set
drawn from ``LABELS_DRAW_SEED``, and ``--seed`` draws the order in which the
mix submits them.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np


def _graph500():
    """``graph500.py`` beside this file, by path (the benchmark loads its
    dataset files by path, not as a package)."""
    path = Path(__file__).with_name("graph500.py")
    spec = importlib.util.spec_from_file_location("portbench_graph500_for_cliques", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


graph500 = _graph500()

#: the relations of the 4-clique query, in the order they are submitted
CLIQUE4 = (("A", "B"), ("B", "C"), ("A", "C"), ("C", "D"), ("A", "D"), ("B", "D"))


def make(config: dict, rng: np.random.Generator) -> dict:
    """The configuration's oriented edge table (the same for every seed)."""
    return graph500.make(config, rng)


def draw_variants(family: str, rng: np.random.Generator, count: int) -> list:
    """The mix's ``count`` vertex labellings: the same set for every seed,
    drawn from ``graph500.LABELS_DRAW_SEED``, in an order drawn from ``rng``."""
    if family != "clique4":
        raise ValueError(f"graph500_cliques has no query family {family!r}")
    seeds = np.random.default_rng(graph500.LABELS_DRAW_SEED).integers(0, 2**63, count)
    return [{"labels": int(seeds[i])} for i in rng.permutation(count)]


def query(family: str, data: dict, params: dict) -> list:
    """The query as (scheme, rows, table) triples under the variant's
    labelling; the six relations bind one physical table."""
    if family != "clique4":
        raise ValueError(f"graph500_cliques has no query family {family!r}")
    labels = np.random.default_rng(params["labels"]).permutation(data["vertices"])
    e = labels[data["edges"]]
    return [(scheme, e, "E") for scheme in CLIQUE4]
