# Planner-side machinery of the MPC join (a copy of the reference package's
# core, numpy and scipy only): hypergraph LPs (Sec. 2), the heavy/light
# taxonomy (Sec. 4), semi-join reduction (Sec. 5.2), isolated cartesian
# product accounting (Sec. 5.3-5.5), the machine allocation (Sec. 6), and the
# relations + oracle join.
from .hypergraph import (
    Hypergraph,
    fractional_edge_cover,
    fractional_edge_packing,
    quasi_packing_number,
    rho,
    tau,
    zero_one_packing,
)
from .query import (
    JoinQuery,
    Relation,
    pattern_edges,
    query_from_arrays,
    random_query,
    reference_join,
)
from .taxonomy import HeavyStats, compute_stats, configurations, plan_for_h
from .planner import heavy_parameter
