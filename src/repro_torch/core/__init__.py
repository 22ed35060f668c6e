# Planner-side machinery of the MPC join (a copy of the reference package's
# core, numpy and scipy only): hypergraph LPs, the heavy/light taxonomy, the
# machine allocation, and the relations + oracle join.
from .query import JoinQuery, Relation, query_from_arrays, reference_join
from .taxonomy import HeavyStats, compute_stats
from .planner import heavy_parameter
