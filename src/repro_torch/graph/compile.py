"""Pattern → JoinQuery compiler (the Sec. 1.4 reduction, made physical).

Every pattern vertex v becomes attribute ``V{v}``; every pattern edge becomes
a binary relation over its endpoints' attributes.  All relations are logical
copies of at most TWO physical tables, shared via ``Relation.table`` so the
engine's shared-input Scatter places each once:

  * ``oriented``  — G's edges with endpoints in ascending vertex-order rank
                    (|E| rows), bound by pattern edges carrying an
                    orientation constraint u → v (as scheme (V_u, V_v):
                    scheme order encodes the direction, so the reversed
                    constraint needs no second table);
  * ``symmetric`` — both orientations (2|E| rows), bound by unoriented
                    pattern edges.

The same ndarray object backs every copy — `compile_pattern` bypasses
``Relation.make``'s dedup (the tables are unique by construction) precisely
so backends can recognize the sharing by identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..core.query import JoinQuery, Relation
from .graphs import Graph, vertex_order_rank
from .patterns import OrientationPlan, Pattern, plan_orientation


def attr_name(v: int) -> str:
    return f"V{v}"


@dataclass(frozen=True)
class CompiledPattern:
    """A pattern bound to a graph: the join query + what postprocessing owes.

    ``attrs[v]`` is pattern vertex v's attribute; because patterns have ≤ 10
    vertices the sorted attset of the query equals ``attrs`` — join rows come
    back with column v holding the G-vertex bound to pattern vertex v."""

    pattern: Pattern
    graph: Graph
    orientation: OrientationPlan
    query: JoinQuery
    attrs: Tuple[str, ...]
    order_rank: np.ndarray        # rank[g_vertex] behind the oriented table

    @property
    def needs_dedup(self) -> bool:
        return not self.orientation.complete


def compile_pattern(
    graph: Graph, pattern: Pattern, orientation: str = "degree"
) -> CompiledPattern:
    """Bind ``pattern`` to ``graph``'s edge set as a simple binary JoinQuery.

    ``orientation`` picks the total vertex order behind the oriented table
    (``"degree"`` default, ``"id"``) — any strict order is correct; see
    :func:`repro_torch.graph.graphs.vertex_order_rank`."""
    if len(pattern.edges) == 0:
        raise ValueError("pattern has no edges")
    plan = plan_orientation(pattern)
    rank = vertex_order_rank(graph, orientation)
    e = graph.edges
    if e.size:
        swap = rank[e[:, 0]] > rank[e[:, 1]]
        lo = np.where(swap, e[:, 1], e[:, 0])
        hi = np.where(swap, e[:, 0], e[:, 1])
        oriented = np.unique(np.stack([lo, hi], axis=1), axis=0)
        sym = np.unique(
            np.concatenate([oriented, oriented[:, ::-1]], axis=0), axis=0
        )
    else:
        oriented = np.zeros((0, 2), np.int64)
        sym = np.zeros((0, 2), np.int64)

    directed = {(min(u, v), max(u, v)): (u, v) for u, v in plan.constraints}
    rels = []
    for u, v in pattern.edges:
        c = directed.get((u, v))
        if c is None:
            rels.append(
                Relation(
                    scheme=(attr_name(u), attr_name(v)),
                    data=sym,
                    table=f"graph-sym:{orientation}",
                )
            )
        else:
            a, b = c
            rels.append(
                Relation(
                    scheme=(attr_name(a), attr_name(b)),
                    data=oriented,
                    table=f"graph-oriented:{orientation}",
                )
            )
    query = JoinQuery.make(rels)
    attrs = tuple(attr_name(v) for v in range(pattern.n_vertices))
    assert query.attset == attrs, "V-attribute order must equal vertex order"
    return CompiledPattern(
        pattern=pattern,
        graph=graph,
        orientation=plan,
        query=query,
        attrs=attrs,
        order_rank=rank,
    )
