"""The port's metered MPC simulator (``repro_torch.mpc``: ``MPCSimulator``,
``SimulatorExecutor``, ``distributed_stats``, ``mpc_join``, the routing of
``cartesian``/``hypercube``, ``JoinSession(backend="simulator")`` and
``enumerate_subgraphs(backend="simulator")``) ≡ the JAX package's, on the CPU.

Twins of tests/test_engine.py, test_engine_edgecases.py,
test_engine_fusion.py, test_engine_property.py, test_mpc_primitives.py,
test_jointree.py and test_em_model.py, plus the simulator/dataplane cases of
test_executor_parity.py.  Both packages get the same data (each package's
own generator at the same numpy seed, or the same arrays), and every check
is exact: rows byte-identical, equal count and per-H counts, equal
``merged_round_loads()`` dicts (integer word counts), equal ``load`` and
``bound``.  The port's simulator is also held row for row against the
port's own ``device="cpu"`` data plane.
"""

import itertools
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import graph as jg
from repro.core import em_model as j_em
from repro.core import jointree as j_jt
from repro.core import query as jq
from repro.core.taxonomy import compute_stats as j_compute_stats
from repro.mpc import cartesian as j_cart
from repro.mpc import hypercube as j_hc
from repro.mpc.engine import mpc_join as j_mpc_join
from repro.mpc.executors import SimulatorExecutor as JSimExecutor
from repro.mpc.program import compile_plan as j_compile_plan
from repro.mpc.service import JoinSession as JaxSession
from repro.mpc.simulator import HashFamily as JHashFamily
from repro.mpc.simulator import MPCSimulator as JSimulator
from repro.mpc.simulator import scatter_input as j_scatter_input
from repro.mpc.statistics import distributed_stats as j_distributed_stats
from repro_torch import graph as tg
from repro_torch.core import em_model as t_em
from repro_torch.core import jointree as t_jt
from repro_torch.core import query as tq
from repro_torch.core.taxonomy import compute_stats as t_compute_stats
from repro_torch.mpc import (
    DataplaneExecutor,
    HashFamily,
    JoinSession,
    MPCJoinResult,
    MPCSimulator,
    SimulatorExecutor,
    mpc_join,
)
from repro_torch.mpc import cartesian as t_cart
from repro_torch.mpc import hypercube as t_hc
from repro_torch.mpc.program import compile_plan, fuse_semijoin_pass
from repro_torch.mpc.simulator import scatter_input
from repro_torch.mpc.statistics import distributed_stats

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)

EMPTY = np.zeros((0, 2), np.int64)


def twin(build):
    """``build(query_module)`` once per package: the same data, each
    package's own query type (asserted equal relation by relation)."""
    qj, qt = build(jq), build(tq)
    assert len(qj.relations) == len(qt.relations)
    for a, b in zip(qj.relations, qt.relations):
        assert a.scheme == b.scheme and a.table == b.table
        assert a.data.tobytes() == b.data.tobytes()
    return qj, qt


def assert_same_run(got, want, rows=True):
    """The port's metered run ≡ the reference's: exact, byte for byte."""
    assert isinstance(got, MPCJoinResult)
    assert (got.p, got.lam, got.m, got.count) == (want.p, want.lam, want.m, want.count)
    assert got.rho == want.rho
    assert got.per_h_counts == want.per_h_counts
    assert got.sim.merged_round_loads() == want.sim.merged_round_loads()
    assert got.sim.load_report() == want.sim.load_report()
    assert got.load == want.load and got.bound == want.bound
    assert got.load_ratio == want.load_ratio
    if rows:
        assert got.rows.dtype == want.rows.dtype == np.int64
        assert got.rows.shape == want.rows.shape
        assert got.rows.tobytes() == want.rows.tobytes()


def assert_same_stats(got, want):
    assert got.m == want.m and got.lam == want.lam
    assert set(got.heavy) == set(want.heavy)
    for a in want.heavy:
        assert np.array_equal(got.heavy[a], want.heavy[a])
    assert got.cond == want.cond
    assert got.pair == want.pair
    assert got.light_cnt == want.light_cnt


def rows_key(rows):
    return sorted(map(tuple, rows.tolist()))


# ---------------------------------------------------------------------------
# HashFamily + the simulator's ledger
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", [
    "sj", ("hc", frozenset({"X0", "X1"})), ((("X0",), (3,)), "sj", "X1"),
    (("X0", "X1"), (7, np.int64(2)), "hc"), ("gsj", "up", 0),
])
def test_hash_family_equals_reference(key):
    """Routing keys hash through ``repr((seed, key))``: equal reprs in both
    packages are what makes every placement and round load equal."""
    vals = np.random.default_rng(0).integers(-50, 1 << 40, size=500)
    for seed, mod in [(0, 7), (3, 64), (11, 1)]:
        got = HashFamily(seed).hash(key, vals, mod)
        want = JHashFamily(seed).hash(key, vals, mod)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_simulator_ledger_equals_reference():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 100, size=(300, 2))
    sims = [MPCSimulator(8, seed=2), JSimulator(8, seed=2)]
    for sim, scatter in zip(sims, (scatter_input, j_scatter_input)):
        scatter(sim, ("in", 0), data, seed=5)
        sim.begin_round("r1")
        for mid in range(sim.p):
            rows = sim.local(mid, ("in", 0))
            sim.send(int(rows[0, 0]) if len(rows) else mid, ("a",), rows)
        sim.end_round()
        sim.begin_round("r1")
        sim.broadcast(("b",), data[:3])
        sim.end_round()
    a, b = sims
    assert a.merged_round_loads() == b.merged_round_loads()
    assert a.load_report() == b.load_report()
    assert (a.total_load, a.max_round_load, a.parallel_total_load) == (
        b.total_load, b.max_round_load, b.parallel_total_load)
    for mid in range(8):
        assert a.local(mid, ("a",)).tobytes() == b.local(mid, ("a",)).tobytes()
    with pytest.raises(RuntimeError):
        a.send(0, ("x",), data)


# ---------------------------------------------------------------------------
# test_engine.py twins: Theorem 6.2 on the simulator
# ---------------------------------------------------------------------------

ENGINE_CASES = {
    "line3-uniform": (lambda Q: Q.random_query(np.random.default_rng(0), "line", 3,
                                               tuples_per_rel=200, dom_size=40), 8, None),
    "triangle-uniform": (lambda Q: Q.random_query(np.random.default_rng(1), "clique", 3,
                                                  tuples_per_rel=150, dom_size=25), 8, None),
    "triangle-skewed": (lambda Q: Q.random_query(np.random.default_rng(2), "clique", 3,
                                                 tuples_per_rel=300, dom_size=30, skew=2.0),
                        8, 16),
    "cycle4-skewed": (lambda Q: Q.random_query(np.random.default_rng(3), "cycle", 4,
                                               tuples_per_rel=200, dom_size=20, skew=1.0),
                      16, 3),
    "star-skewed": (lambda Q: Q.random_query(np.random.default_rng(4), "star", 4,
                                             tuples_per_rel=150, dom_size=12, skew=1.5), 8, 3),
    "line5": (lambda Q: Q.random_query(np.random.default_rng(5), "line", 5,
                                       tuples_per_rel=120, dom_size=15, skew=0.8), 8, 3),
    "hub-cross-product": (lambda Q: Q.JoinQuery.make([
        Q.Relation.make(("H", "A"), np.stack([np.zeros(120, np.int64), np.arange(120)], 1)),
        Q.Relation.make(("H", "B"), np.stack([np.zeros(120, np.int64),
                                              np.arange(120) + 1000], 1)),
    ]), 8, 4),
    "empty-result": (lambda Q: Q.JoinQuery.make([
        Q.Relation.make(("A", "B"), np.array([[1, 2], [3, 4]])),
        Q.Relation.make(("B", "C"), np.array([[9, 9]])),
    ]), 4, None),
}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_mpc_join_matches_reference(name):
    build, p, lam = ENGINE_CASES[name]
    qj, qt = twin(build)
    got = mpc_join(qt, p=p, lam=lam)
    want = j_mpc_join(qj, p=p, lam=lam)
    assert_same_run(got, want)
    oracle = tq.reference_join(qt)
    assert got.count == len(oracle) == got.rows.shape[0]     # exactly once
    assert set(map(tuple, got.rows.tolist())) == oracle.rows_as_set()
    if name == "triangle-skewed":
        assert any(len(h) > 0 and c > 0 for h, c in got.per_h_counts.items())
    if name == "hub-cross-product":
        assert got.count == 120 * 120


def test_count_only_run_and_load_report():
    build = lambda Q: Q.random_query(np.random.default_rng(8), "clique", 3,  # noqa: E731
                                     tuples_per_rel=400, dom_size=25, skew=1.0)
    qj, qt = twin(build)
    got = mpc_join(qt, p=8, materialize=False)
    want = j_mpc_join(qj, p=8, materialize=False)
    assert got.rows is None and want.rows is None
    assert_same_run(got, want, rows=False)
    assert got.load > 0
    names = [n for n, _ in got.sim.load_report()]
    assert "step1" in names and "step3-route" in names
    assert got.count == len(tq.reference_join(qt))


def test_op_without_a_simulator_rule_names_the_general_route_item():
    """Every op of both routes has a simulator rule (the general route's
    TreeSemiJoin, ShareRoute and CellJoin too); an op the simulator does not
    know still raises NotImplementedError, as the reference's does."""
    from dataclasses import replace

    q = tq.random_query(np.random.default_rng(8), "clique", 3, tuples_per_rel=60,
                        dom_size=12, skew=0.0)
    prog = compile_plan(q, t_compute_stats(q, 4), 4)
    bad = replace(prog, ops=prog.ops + (object(),))
    with pytest.raises(NotImplementedError, match="unknown op"):
        SimulatorExecutor(p=4).run(bad)
    jq_ = jq.random_query(np.random.default_rng(8), "clique", 3, tuples_per_rel=60,
                          dom_size=12, skew=0.0)
    jprog_ = j_compile_plan(jq_, j_compute_stats(jq_, 4), 4)
    with pytest.raises(NotImplementedError, match="unknown op"):
        JSimExecutor(p=4).run(replace(jprog_, ops=jprog_.ops + (object(),)))


def test_distributed_stats_match_reference_and_oracle():
    build = lambda Q: Q.random_query(np.random.default_rng(7), "clique", 3,  # noqa: E731
                                     tuples_per_rel=250, dom_size=20, skew=1.3)
    qj, qt = twin(build)
    sim, jsim = MPCSimulator(8, seed=0), JSimulator(8, seed=0)
    for rel_t, rel_j in zip(qt.relations, qj.relations):
        scatter_input(sim, ("in", rel_t.edge), rel_t.data, seed=17)
        j_scatter_input(jsim, ("in", rel_j.edge), rel_j.data, seed=17)
    got = distributed_stats(sim, qt, 5)
    assert_same_stats(got, j_distributed_stats(jsim, qj, 5))
    assert_same_stats(got, t_compute_stats(qt, 5))
    assert sim.merged_round_loads() == jsim.merged_round_loads()
    assert set(sim.merged_round_loads()) == {"stats-candidates", "stats-counts",
                                             "stats-extended"}


# ---------------------------------------------------------------------------
# test_engine_edgecases.py twins
# ---------------------------------------------------------------------------


def _two_copy_query(Q, shared):
    rng = np.random.default_rng(5)
    planted = np.stack([np.full(30, 99), np.arange(30)], axis=1)
    tab = np.unique(np.concatenate([planted, rng.integers(0, 40, (120, 2))]), axis=0)
    table = "edges" if shared else None
    return Q.JoinQuery.make([Q.Relation(scheme=("A", "B"), data=tab, table=table),
                             Q.Relation(scheme=("B", "C"), data=tab, table=table)])


def _empty_leaf_star(Q):
    q = Q.hub_star_query(n=30, hub_n=20, dom_size=20)
    rels = list(q.relations)
    rels[2] = Q.Relation.make(rels[2].scheme, EMPTY)
    return Q.JoinQuery.make(rels)


EDGE_CASES = {
    "all-empty": (lambda Q: Q.JoinQuery.make([Q.Relation.make(("A", "B"), EMPTY),
                                              Q.Relation.make(("B", "C"), EMPTY)]), 4, 4),
    "empty-with-heavy-partner": (lambda Q: Q.JoinQuery.make([
        Q.Relation.make(("A", "B"), EMPTY),
        Q.Relation.make(("B", "C"), np.stack([np.full(50, 7), np.arange(50)], axis=1)),
    ]), 4, 4),
    "empty-isolated-piece": (_empty_leaf_star, 4, 6),
    "singleton": (lambda Q: Q.JoinQuery.make([
        Q.Relation.make(("A", "B"), np.array([[1, 2]], np.int64)),
        Q.Relation.make(("B", "C"), np.array([[2, 3]], np.int64)),
    ]), 8, 2),
    "selfjoin-shared": (lambda Q: _two_copy_query(Q, True), 6, 8),
    "selfjoin-unshared": (lambda Q: _two_copy_query(Q, False), 6, 8),
}


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_edge_cases_match_reference_on_both_executors(name):
    """Compiled once per package, run on both simulators and on the port's
    CPU data plane: equal to the reference's simulator (rows in order) and
    to the port's data plane (row multiset, per-H counts)."""
    build, p, lam = EDGE_CASES[name]
    qj, qt = twin(build)
    prog = compile_plan(qt, t_compute_stats(qt, lam), p)
    jprog = j_compile_plan(qj, j_compute_stats(qj, lam), p)
    got = SimulatorExecutor(p=p).run(prog)
    assert_same_run(got, JSimExecutor(p=p).run(jprog))
    dp = DataplaneExecutor(p, device="cpu").run(prog)
    assert dp.count == got.count == len(tq.reference_join(qt))
    assert dp.per_h_counts == got.per_h_counts
    assert rows_key(dp.rows) == rows_key(got.rows)
    assert got.rows.shape == (got.count, len(qt.attset))
    if name == "empty-isolated-piece":
        iso = {st.hkey for st in prog.stages if st.plan.isolated}
        assert iso and not iso & set(got.per_h_counts)      # geo.skip: no entry
    if name == "singleton":
        assert got.rows.tolist() == [[1, 2, 3]]
    # and through the one-shot entry point (distributed statistics)
    assert_same_run(mpc_join(qt, p=p, lam=lam), j_mpc_join(qj, p=p, lam=lam))


@pytest.mark.parametrize("shared", [True, False])
def test_selfjoin_distributed_stats_match_reference(shared):
    qj, qt = twin(lambda Q: _two_copy_query(Q, shared))
    sim, jsim = MPCSimulator(p=6, seed=0), JSimulator(p=6, seed=0)
    SimulatorExecutor(sim, seed=0).place_inputs(qt)
    JSimExecutor(jsim, seed=0).place_inputs(qj)
    got = distributed_stats(sim, qt, 8)
    assert_same_stats(got, j_distributed_stats(jsim, qj, 8))
    assert_same_stats(got, t_compute_stats(qt, 8))
    assert got.m == 2 * len(qt.relations[0])
    for mid in range(6):
        for rel in qt.relations:
            assert sim.local(mid, ("in", rel.edge)).tobytes() == \
                jsim.local(mid, ("in", rel.edge)).tobytes()


def test_shared_scatter_is_invisible_to_rows_and_load():
    out = {}
    for shared in (True, False):
        qt = _two_copy_query(tq, shared)
        res = mpc_join(qt, p=6, lam=8)
        out[shared] = (res.count, res.per_h_counts, res.rows.tobytes(),
                       res.sim.parallel_total_load)
    assert out[True] == out[False]


# ---------------------------------------------------------------------------
# test_engine_fusion.py twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,k,skew", [("clique", 3, 2.0), ("cycle", 4, 1.0),
                                         ("line", 4, 0.0)])
def test_fused_semijoin_matches_reference(kind, k, skew):
    qj, qt = twin(lambda Q: Q.random_query(np.random.default_rng(k), kind, k,
                                           tuples_per_rel=150, dom_size=20, skew=skew))
    for fuse in (False, True):
        got = mpc_join(qt, p=8, lam=8, fuse_semijoin=fuse)
        assert_same_run(got, j_mpc_join(qj, p=8, lam=8, fuse_semijoin=fuse))
        assert got.count == len(tq.reference_join(qt))


def test_fused_semijoin_saves_the_bx_round():
    qj, qt = twin(lambda Q: Q.random_query(np.random.default_rng(1), "clique", 3,
                                           tuples_per_rel=800, dom_size=800, skew=0.0))
    a = mpc_join(qt, p=8, materialize=False, fuse_semijoin=False)
    b = mpc_join(qt, p=8, materialize=False, fuse_semijoin=True)
    assert_same_run(b, j_mpc_join(qj, p=8, materialize=False, fuse_semijoin=True), rows=False)
    assert a.count == b.count
    assert a.sim.merged_round_loads().get("step2-bx", 0) > 0
    assert b.sim.merged_round_loads().get("step2-bx", 0) == 0
    assert b.load < a.load


# ---------------------------------------------------------------------------
# test_engine_property.py twin (hypothesis)
# ---------------------------------------------------------------------------


def _build_query(Q, seed, kind, n_attrs, n_tuples, dom, skew):
    rng = np.random.default_rng(seed)
    rels = []
    for e in Q.pattern_edges(kind, n_attrs):
        cols = []
        for _ in range(2):
            if skew > 0:
                ranks = np.arange(1, dom + 1, dtype=np.float64) ** (-skew)
                ranks /= ranks.sum()
                cols.append(rng.choice(dom, size=n_tuples, p=ranks))
            else:
                cols.append(rng.integers(0, dom, size=n_tuples))
        rels.append(Q.Relation.make(e, np.stack(cols, axis=1)))
    return Q.JoinQuery.make(rels)


@settings(max_examples=15, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    kind=st.sampled_from(["line", "cycle", "clique", "star"]),
    n_attrs=st.integers(3, 4),
    n_tuples=st.integers(20, 120),
    dom=st.integers(3, 25),
    skew=st.sampled_from([0.0, 1.0, 2.5]),
    p=st.sampled_from([4, 8]),
    lam=st.sampled_from([2, 4, 8]),
)
def test_mpc_join_matches_reference_on_random_queries(seed, kind, n_attrs, n_tuples, dom,
                                                      skew, p, lam):
    qj, qt = twin(lambda Q: _build_query(Q, seed, kind, n_attrs, n_tuples, dom, skew))
    got = mpc_join(qt, p=p, lam=lam, seed=seed % 7)
    assert_same_run(got, j_mpc_join(qj, p=p, lam=lam, seed=seed % 7))
    oracle = tq.reference_join(qt)
    assert got.count == len(oracle) == got.rows.shape[0]
    assert set(map(tuple, got.rows.tolist())) == oracle.rows_as_set()


# ---------------------------------------------------------------------------
# test_mpc_primitives.py twins: Lemma 3.1 and Lemma 3.3 on the simulator
# ---------------------------------------------------------------------------


def test_cartesian_product_matches_reference():
    sizes = [37, 23, 11]
    rels = [
        (Q, [Q.Relation.make((f"X{i}",), (np.arange(s) + 100 * i).reshape(-1, 1))
             for i, s in enumerate(sizes)])
        for Q in (tq, jq)
    ]
    sim, count, rows = t_cart.cartesian_product_mpc(rels[0][1], p=16, seed=3, materialize=True)
    jsim, jcount, jrows = j_cart.cartesian_product_mpc(rels[1][1], p=16, seed=3,
                                                       materialize=True)
    assert count == jcount == math.prod(sizes)
    assert rows.tobytes() == jrows.tobytes()
    assert len(set(map(tuple, rows.tolist()))) == count     # exactly-once assembly
    assert sim.merged_round_loads() == jsim.merged_round_loads()


def test_cartesian_load_within_bound():
    sizes = [512, 256, 64]
    rels = [tq.Relation.make((f"X{i}",), (np.arange(s) + 1000 * i).reshape(-1, 1))
            for i, s in enumerate(sizes)]
    jrels = [jq.Relation.make(r.scheme, r.data) for r in rels]
    sim, count, _ = t_cart.cartesian_product_mpc(rels, p=64)
    jsim, _, _ = j_cart.cartesian_product_mpc(jrels, p=64)
    assert count == math.prod(sizes)
    assert sim.max_round_load == jsim.max_round_load
    assert sim.max_round_load <= 8 * max(t_cart.CartesianGrid(sizes, 64).theoretical_load(), 1.0)


def test_hypercube_join_matches_reference():
    qj, qt = twin(lambda Q: Q.random_query(np.random.default_rng(0), "clique", 3,
                                           tuples_per_rel=200, dom_size=50))
    shares = t_hc.uniform_lp_shares(qt.hypergraph, 27)
    assert shares == j_hc.uniform_lp_shares(qj.hypergraph, 27)
    sim, count, result = t_hc.skewfree_hypercube_join(qt, shares, p=27, seed=2)
    jsim, jcount, jresult = j_hc.skewfree_hypercube_join(qj, shares, p=27, seed=2)
    assert count == jcount == len(tq.reference_join(qt))
    assert result.data.tobytes() == jresult.data.tobytes()
    assert sim.merged_round_loads() == jsim.merged_round_loads()


def test_hypercube_load_degrades_under_skew():
    """The paper's motivation: the one-round HyperCube meets m/p^{1/ρ} on
    skew-free data and loses it on a hub of the same size."""
    rng = np.random.default_rng(1)
    p = 27
    q = tq.random_query(rng, "clique", 3, tuples_per_rel=2000, dom_size=2000, skew=0.0)
    shares = t_hc.uniform_lp_shares(q.hypergraph, p)
    sim, _, _ = t_hc.skewfree_hypercube_join(q, shares, p=p, materialize=False)
    ratio_uniform = sim.max_round_load / (q.m / p ** (2.0 / 3.0))
    assert ratio_uniform <= 12
    n = 2000
    hub = np.stack([np.zeros(n, np.int64), np.arange(n)], axis=1)
    bc = np.stack([rng.integers(0, n, n), rng.integers(0, n, n)], axis=1)
    q_skew = tq.JoinQuery.make([tq.Relation.make(("X0", "X1"), hub),
                                tq.Relation.make(("X1", "X2"), bc),
                                tq.Relation.make(("X0", "X2"), hub)])
    sim2, _, _ = t_hc.skewfree_hypercube_join(q_skew, shares, p=p, materialize=False)
    assert sim2.max_round_load / (q_skew.m / p ** (2.0 / 3.0)) > 1.5 * ratio_uniform


# ---------------------------------------------------------------------------
# test_jointree.py + test_em_model.py twins
# ---------------------------------------------------------------------------


def test_jointree_matches_reference_exhaustive_4v():
    """Every ≤4-edge hypergraph on 4 vertices: GYO, acyclicity, the join
    tree and the running-intersection check equal the reference's."""
    verts = [f"X{i}" for i in range(4)]
    edges = [frozenset(c) for r in range(1, 5) for c in itertools.combinations(verts, r)]
    seen = {True: 0, False: 0}
    for k in range(1, 5):
        for schemes in itertools.combinations(edges, k):
            schemes = list(schemes)
            acyclic = t_jt.is_acyclic(schemes)
            assert acyclic == j_jt.is_acyclic(schemes) == t_jt.brute_force_acyclic(schemes)
            assert t_jt.gyo_reduction(schemes) == j_jt.gyo_reduction(schemes)
            tree, jtree = t_jt.build_join_tree(schemes), j_jt.build_join_tree(schemes)
            assert (tree is None) == (jtree is None) == (not acyclic)
            if tree is not None:
                assert (tree.n_nodes, tree.root, tree.edges) == (
                    jtree.n_nodes, jtree.root, jtree.edges)
                assert t_jt.running_intersection_ok(schemes, tree)
            seen[acyclic] += 1
    assert seen[True] > 500 and seen[False] > 50


def test_running_intersection_rejects_corrupted_tree():
    schemes = [frozenset(s) for s in
               [("A", "B", "C"), ("A", "A1"), ("A1", "A2"), ("B", "B1"), ("C", "C1")]]
    tree = t_jt.build_join_tree(schemes)
    assert tree is not None and t_jt.running_intersection_ok(schemes, tree)
    assert tree.path(2, 4) == j_jt.build_join_tree(schemes).path(2, 4)
    bad = t_jt.JoinTree(n_nodes=tree.n_nodes, root=tree.root,
                        edges=tuple((c, 3 if c == 2 else p, sh) for c, p, sh in tree.edges))
    assert not t_jt.running_intersection_ok(schemes, bad)


def test_em_cost_matches_reference():
    qj, qt = twin(lambda Q: Q.random_query(np.random.default_rng(0), "clique", 3,
                                           tuples_per_rel=600, dom_size=600, skew=0.0))
    ratios = []
    for mem in (1500, 3000):
        p = t_em.simulated_p(qt.m, mem)
        assert p == j_em.simulated_p(qj.m, mem)
        got = t_em.em_cost_from_run(qt, mpc_join(qt, p=p, materialize=False), mem, 64)
        want = j_em.em_cost_from_run(qj, j_mpc_join(qj, p=p, materialize=False), mem, 64)
        assert vars(got) == vars(want)
        assert got.io_blocks > 0
        ratios.append(got.ratio)
    assert max(ratios) / min(ratios) < 8.0 and all(r < 200 for r in ratios)


# ---------------------------------------------------------------------------
# test_executor_parity.py: the port's simulator ≡ the port's CPU data plane
# ---------------------------------------------------------------------------

PARITY_CASES = {
    "triangle-zipf": (lambda Q: Q.random_query(np.random.default_rng(2), "clique", 3,
                                               tuples_per_rel=200, dom_size=30, skew=2.0),
                      16, False),
    "four-cycle": (lambda Q: Q.random_query(np.random.default_rng(7), "cycle", 4,
                                            tuples_per_rel=120, dom_size=10, skew=2.5),
                   24, False),
    "hub-star": (lambda Q: Q.hub_star_query(n=48, hub_n=24, dom_size=25), 10, False),
    "disconnected": (lambda Q: Q.disconnected_query(90, dom_size=12, skew=1.8), 8, False),
    "fused-star": (lambda Q: Q.random_query(np.random.default_rng(4), "star", 4,
                                            tuples_per_rel=150, dom_size=12, skew=1.5),
                   3, True),
}


@pytest.mark.parametrize("name", list(PARITY_CASES))
def test_simulator_matches_cpu_dataplane_and_reference(name):
    build, lam, fused = PARITY_CASES[name]
    qj, qt = twin(build)
    prog = compile_plan(qt, t_compute_stats(qt, lam), 8)
    jprog = j_compile_plan(qj, j_compute_stats(qj, lam), 8)
    if fused:
        prog = fuse_semijoin_pass(prog)
        from repro.mpc.program import fuse_semijoin_pass as j_fuse

        jprog = j_fuse(jprog)
    sim = SimulatorExecutor(p=8).run(prog)
    assert_same_run(sim, JSimExecutor(p=8).run(jprog))
    assert sim.count == len(tq.reference_join(qt))
    for batch in (True, False):
        dp = DataplaneExecutor(8, device="cpu", batch_stages=batch).run(prog)
        assert dp.count == sim.count
        assert dp.per_h_counts == sim.per_h_counts
        assert rows_key(dp.rows) == rows_key(sim.rows)


# ---------------------------------------------------------------------------
# JoinSession(backend="simulator") ≡ the reference's simulator session
# ---------------------------------------------------------------------------


def _session_queries(Q):
    return [Q.random_query(np.random.default_rng(s), kind, k, tuples_per_rel=150,
                           dom_size=20, skew=1.5)
            for s, (kind, k) in enumerate([("clique", 3), ("cycle", 4), ("clique", 3)])]


def test_simulator_session_matches_reference_cold_and_warm():
    qs_t, qs_j = _session_queries(tq), _session_queries(jq)
    s = JoinSession(p=8, backend="simulator", seed=1, verify=False)
    ref = JaxSession(p=8, backend="simulator", seed=1, verify=False)
    assert s.executor is None and s.backend == "simulator"
    for qt, qj in zip(qs_t + qs_t, qs_j + qs_j):
        got, want = s.submit(qt, lam=6), ref.submit(qj, lam=6)
        assert got.plan_cache_hit == want.plan_cache_hit
        assert got.plan_key == want.plan_key
        assert_same_run(got.result, want.result)
        assert got.retries == 0 and got.caps_hits == 0
    assert (s.stats.plan_hits, s.stats.plan_misses) == (ref.stats.plan_hits,
                                                        ref.stats.plan_misses)
    assert s.stats.plan_hits >= 3 and s.stats.submits == 6
    # the metered statistics rounds are in every submit's ledger
    assert "stats-counts" in got.result.sim.merged_round_loads()
    s.close()
    ref.close()


def test_simulator_session_batch_coalesced_and_async_match_reference():
    """submit_batch installs the first query's scatter placement into later
    ones; coalesced and async submits run serially on the simulator — all
    byte-identical to one reference submit per query."""
    g_j = jg.zipf_graph(np.random.default_rng(4), 70, 300, skew=1.2)
    g_t = tg.zipf_graph(np.random.default_rng(4), 70, 300, skew=1.2)
    qs_t = [tg.compile_pattern(g_t, tg.cycle(k)).query for k in (3, 4)]
    qs_j = [jg.compile_pattern(g_j, jg.cycle(k)).query for k in (3, 4)]
    ref = JaxSession(p=8, backend="simulator", verify=False)
    want = [ref.submit(q, lam=8).result for q in qs_j]
    with JoinSession(p=8, backend="simulator", verify=False) as s:
        batch = s.submit_batch(qs_t, lam=8)
        co = s.submit_coalesced(qs_t, lam=8)
        futs = [s.submit_async(q, lam=8) for q in qs_t]
        asy = [f.result(timeout=120) for f in futs]
        for i in range(len(qs_t)):
            for r in (batch[i], co[i], asy[i]):
                assert_same_run(r.result, want[i])
                assert not r.coalesced
        assert all(r.e2e_us > 0 for r in asy)
        assert s.stats.async_submits == len(qs_t)
    ref.close()


# ---------------------------------------------------------------------------
# enumerate_subgraphs(backend="simulator") ≡ the reference's at equal p
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,p", [("triangle", 8), ("cycle4", 16), ("clique4", 8)])
def test_enumerate_subgraphs_simulator_matches_reference(name, p):
    g_j = jg.zipf_graph(np.random.default_rng(21), 80, 360, skew=1.2)
    g_t = tg.zipf_graph(np.random.default_rng(21), 80, 360, skew=1.2)
    assert g_t.edges.tobytes() == g_j.edges.tobytes()
    pat = {"triangle": (tg.triangle, jg.triangle), "cycle4": (lambda: tg.cycle(4),
                                                              lambda: jg.cycle(4)),
           "clique4": (lambda: tg.clique(4), lambda: jg.clique(4))}[name]
    got = tg.enumerate_subgraphs(g_t, pat[0](), p=p, backend="simulator", seed=3)
    want = jg.enumerate_subgraphs(g_j, pat[1](), p=p, backend="simulator", seed=3)
    assert got.backend == "simulator"
    assert got.occurrences.dtype == want.occurrences.dtype == np.int64
    assert got.occurrences.tobytes() == want.occurrences.tobytes()
    assert (got.count, got.embeddings) == (want.count, want.embeddings)
    assert_same_run(got.engine, want.engine)
    assert got.occurrences.tobytes() == tg.brute_force_occurrences(g_t, pat[0]()).tobytes()
    # the session door runs the same metered join
    with JoinSession(p=p, backend="simulator", seed=3, verify=False) as s:
        via = s.submit_pattern(pat[0](), g_t)
    assert via.occurrences.tobytes() == got.occurrences.tobytes()
    assert_same_run(via.engine, got.engine)
