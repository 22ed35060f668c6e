"""Subgraph enumeration subsystem: pattern DSL, graph generators, the
pattern → JoinQuery compiler, and the end-to-end enumeration pipeline
(paper Sec. 1.4 — the headline corollary workload)."""

from .compile import CompiledPattern, compile_pattern
from .enumerate import EnumerationResult, enumerate_subgraphs, postprocess_rows
from .graphs import (
    Graph,
    erdos_renyi,
    load_edge_list,
    vertex_order_rank,
    zipf_graph,
)
from .patterns import (
    OrientationPlan,
    Pattern,
    automorphisms,
    canonical_rows,
    clique,
    cycle,
    from_edge_list,
    path,
    plan_orientation,
    star,
    triangle,
)
from .reference import brute_force_occurrences

__all__ = [
    "CompiledPattern",
    "EnumerationResult",
    "Graph",
    "OrientationPlan",
    "Pattern",
    "automorphisms",
    "brute_force_occurrences",
    "canonical_rows",
    "clique",
    "compile_pattern",
    "cycle",
    "enumerate_subgraphs",
    "erdos_renyi",
    "from_edge_list",
    "load_edge_list",
    "path",
    "plan_orientation",
    "postprocess_rows",
    "star",
    "triangle",
    "vertex_order_rank",
    "zipf_graph",
]
