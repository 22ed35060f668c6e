"""The port's compiler ≡ the JAX package's: same stages, ops, emit and keys.

``repro_torch`` carries its own copy of the planner side (hypergraph LPs,
taxonomy, program compiler).  On the parity queries of the executor tests,
plus a shared-table triangle and a heavy-free chain, both compilers must
produce the same (H, η) stages with the same plans and configurations, the
same op sequence (fused or not), the same H = attset emit rows, and the same
plan-cache, histogram and coalescing signatures.
"""

import numpy as np
import pytest
import torch

from repro.core.query import (
    JoinQuery,
    Relation,
    disconnected_query,
    hub_star_query,
    random_query,
)
from repro.core.taxonomy import compute_stats
from repro.mpc import program as jprog
from repro_torch.core import query as tquery
from repro_torch.core import taxonomy as ttax
from repro_torch.mpc import program as tprog

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)


def shared_triangle():
    rng = np.random.default_rng(5)
    e = np.unique(rng.integers(0, 40, (300, 2)), axis=0)
    e = e[e[:, 0] < e[:, 1]]
    return JoinQuery.make([Relation(scheme=s, data=e, table="E")
                           for s in (("A", "B"), ("B", "C"), ("A", "C"))])


def chain():
    rng = np.random.default_rng(1)
    n = 60
    return JoinQuery.make([
        Relation.make(("A", "B"), np.stack([np.arange(n), rng.permutation(n)], axis=1)),
        Relation.make(("B", "C"), np.stack([np.arange(n), rng.permutation(n)], axis=1)),
    ])


QUERIES = {
    "triangle-zipf": (lambda: random_query(np.random.default_rng(2), "clique", 3,
                                           tuples_per_rel=200, dom_size=30, skew=2.0), 16),
    "four-cycle": (lambda: random_query(np.random.default_rng(7), "cycle", 4,
                                        tuples_per_rel=120, dom_size=10, skew=2.5), 24),
    "hub-star": (lambda: hub_star_query(n=48, hub_n=24, dom_size=25), 10),
    "disconnected": (lambda: disconnected_query(90, dom_size=12, skew=1.8), 8),
    "star": (lambda: random_query(np.random.default_rng(4), "star", 4,
                                  tuples_per_rel=150, dom_size=12, skew=1.5), 3),
    "shared-triangle": (shared_triangle, 4),
    "chain": (chain, 4),
}


def to_torch_query(q):
    return tquery.query_from_arrays([(r.scheme, r.data, r.table) for r in q.relations])


def compile_both(name, p=8, fused=False):
    make, lam = QUERIES[name]
    q = make()
    tq = to_torch_query(q)
    js, ts = compute_stats(q, lam), ttax.compute_stats(tq, lam)
    jp, tp = jprog.compile_plan(q, js, p), tprog.compile_plan(tq, ts, p)
    if fused:
        jp, tp = jprog.fuse_semijoin_pass(jp), tprog.fuse_semijoin_pass(tp)
    return (q, js, jp), (tq, ts, tp)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", list(QUERIES))
def test_compile_plan_matches_reference(name, fused):
    (q, js, jp), (tq, ts, tp) = compile_both(name, fused=fused)
    for rel, trel in zip(q.relations, tq.relations):
        assert rel.scheme == trel.scheme and rel.table == trel.table
        np.testing.assert_array_equal(rel.data, trel.data)
    assert (tp.p, tp.lam, tp.rho_val, tp.fused) == (jp.p, jp.lam, jp.rho_val, jp.fused)
    assert tp.op_sequence() == jp.op_sequence()
    assert tp.round_names == jp.round_names
    assert len(tp.stages) == len(jp.stages)
    for ts_, js_ in zip(tp.stages, jp.stages):
        assert ts_.hkey == js_.hkey and ts_.ekey == js_.ekey
        assert repr(ts_.plan) == repr(js_.plan)
        assert repr(ts_.cfg) == repr(js_.cfg)
    assert tp.emit_counts == jp.emit_counts
    assert [m for m, _ in tp.emit] == [m for m, _ in jp.emit]
    for (_, tr), (_, jr) in zip(tp.emit, jp.emit):
        np.testing.assert_array_equal(tr, jr)
    assert tprog.histogram_signature(ts) == jprog.histogram_signature(js)
    assert tprog.plan_cache_key(tq, ts, 8, fuse_semijoin=fused) == jprog.plan_cache_key(
        q, js, 8, fuse_semijoin=fused)
    assert repr(tprog.coalesce_signature(tp)) == repr(jprog.coalesce_signature(jp))


def test_compile_plan_p64_matches_reference():
    (_, _, jp), (_, _, tp) = compile_both("triangle-zipf", p=64)
    assert [(s.hkey, s.ekey, repr(s.plan)) for s in tp.stages] == [
        (s.hkey, s.ekey, repr(s.plan)) for s in jp.stages]


def test_general_arity_raises_not_implemented():
    """A query with a 3-ary relation compiles through the general route to
    the reference's GeneralPlan and op stream (it raised before the route
    was ported)."""
    rel3 = np.array([[0, 1, 2], [1, 2, 3]])
    rel2 = np.array([[2, 5], [3, 6]])
    q = tquery.query_from_arrays([(("A", "B", "C"), rel3, None), (("C", "D"), rel2, None)])
    jq = JoinQuery.make([Relation.make(("A", "B", "C"), rel3), Relation.make(("C", "D"), rel2)])
    tp = tprog.compile_plan(q, ttax.compute_stats(q, 2), 4)
    jp = jprog.compile_plan(jq, compute_stats(jq, 2), 4)
    assert tp.general is not None and tp.general.kind == "yannakakis"
    assert repr(tp.general) == repr(jp.general)
    assert tp.op_sequence() == jp.op_sequence() == [
        "Scatter", "TreeSemiJoin[up]", "TreeSemiJoin[down]", "ShareRoute", "CellJoin"]
    assert [repr(st.signature) for st in tp.stages] == [repr(st.signature) for st in jp.stages]
