"""The port's subgraph enumeration (``repro_torch.graph``) ≡ the JAX
package's (``repro.graph``), on the CPU.

Twins of tests/test_subgraph.py.  Both packages get the same patterns and
the same graphs (drawn from the same numpy seeds by each package's own
generator), and every check is exact:

* the pattern DSL, automorphisms, orientation plans, canonical rows, graph
  normalization, vertex orders and the compiled shared-table query equal the
  reference's;
* ``brute_force_occurrences`` equals the reference oracle;
* ``enumerate_subgraphs(backend="dataplane")`` and ``JoinSession.submit_pattern``
  at p=8 on the CPU return occurrences byte-equal to the reference's run on
  the JAX DataplaneExecutor (and to the oracle), with equal count and
  embeddings.  The simulator backend's parity is in
  tests/test_torch_simulator.py.
"""

import functools

import numpy as np
import pytest
import torch

from repro import graph as jg
from repro.core.taxonomy import compute_stats as j_compute_stats
from repro.mpc.executors import DataplaneExecutor as JaxExecutor
from repro.mpc.program import histogram_signature as j_histogram_signature
from repro.mpc.service import JoinSession as JaxSession
from repro_torch import graph as tg
from repro_torch.core.taxonomy import compute_stats as t_compute_stats
from repro_torch.mpc import DataplaneExecutor, JoinSession
from repro_torch.mpc.program import histogram_signature as t_histogram_signature

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)

PATTERN_NAMES = ["triangle", "cycle4", "clique4"]


def make_pattern(pkg, name):
    return {"triangle": lambda: pkg.triangle(), "cycle4": lambda: pkg.cycle(4),
            "clique4": lambda: pkg.clique(4), "path4": lambda: pkg.path(4),
            "star3": lambda: pkg.star(3)}[name]()


def same_pattern(a, b):
    return (a.name, a.n_vertices, a.edges) == (b.name, b.n_vertices, b.edges)


def make_graph(pkg, kind, n, m, seed, skew=1.2):
    rng = np.random.default_rng(seed)
    if kind == "er":
        return pkg.erdos_renyi(rng, n, m)
    return pkg.zipf_graph(rng, n, m, skew=skew)


def graphs(kind, n, m, seed, skew=1.2):
    """The same graph from each package's generator (asserted equal)."""
    g_j, g_t = make_graph(jg, kind, n, m, seed, skew), make_graph(tg, kind, n, m, seed, skew)
    assert g_t.n_vertices == g_j.n_vertices
    assert g_t.edges.tobytes() == g_j.edges.tobytes()
    return g_j, g_t


def assert_same_enumeration(got, want):
    assert got.occurrences.dtype == want.occurrences.dtype == np.int64
    assert got.occurrences.shape == want.occurrences.shape
    assert got.occurrences.tobytes() == want.occurrences.tobytes()
    assert got.count == want.count
    assert got.embeddings == want.embeddings


# ---------------------------------------------------------------------------
# Pattern DSL + automorphisms
# ---------------------------------------------------------------------------


def test_builtin_patterns():
    for name in ("triangle", "cycle4", "clique4", "path4", "star3"):
        assert same_pattern(make_pattern(tg, name), make_pattern(jg, name))
    assert len(tg.clique(5).edges) == len(jg.clique(5).edges) == 10
    edges = [(5, 7), (7, 9), (5, 9), (5, 2)]
    paw_t = tg.from_edge_list(edges, name="paw")
    assert same_pattern(paw_t, jg.from_edge_list(edges, name="paw"))
    assert paw_t.n_vertices == 4 and len(paw_t.edges) == 4


@pytest.mark.parametrize("args", [("loop", 2, [(0, 0)]), ("dup", 2, [(0, 1), (1, 0)]),
                                  ("island", 3, [(0, 1)]),
                                  ("big", 9, [(i, i + 1) for i in range(8)])])
def test_pattern_validation(args):
    with pytest.raises(ValueError):
        jg.Pattern.make(*args)
    with pytest.raises(ValueError):
        tg.Pattern.make(*args)


def test_automorphism_counts():
    for name, n in [("triangle", 6), ("cycle4", 8), ("clique4", 24), ("path4", 2),
                    ("star3", 6)]:
        got = tg.automorphisms(make_pattern(tg, name))
        assert len(got) == n
        assert sorted(map(tuple, got)) == sorted(map(tuple, jg.automorphisms(make_pattern(jg, name))))


# ---------------------------------------------------------------------------
# Orientation plans
# ---------------------------------------------------------------------------


def same_plan(name):
    a = tg.plan_orientation(make_pattern(tg, name))
    b = jg.plan_orientation(make_pattern(jg, name))
    assert (a.constraints, a.complete, a.needs_injectivity) == (
        b.constraints, b.complete, b.needs_injectivity)
    return a


def test_orientation_clique_total_and_complete():
    for k in (3, 4, 5):
        plan = tg.plan_orientation(tg.clique(k))
        ref = jg.plan_orientation(jg.clique(k))
        assert plan.constraints == ref.constraints == tg.clique(k).edges
        assert plan.complete and not plan.needs_injectivity


def test_orientation_cycle4_partial():
    plan = same_plan("cycle4")
    assert plan.constraints and not plan.complete and plan.needs_injectivity


def test_orientation_path4_middle_edge_complete():
    plan = same_plan("path4")
    assert plan.constraints == ((1, 2),) and plan.complete and plan.needs_injectivity


def test_orientation_star_unorientable():
    plan = same_plan("star3")
    assert plan.constraints == () and not plan.complete


def test_canonical_rows_lexmin():
    rows = np.array([[3, 1, 2], [1, 2, 3], [9, 9, 9]], dtype=np.int64)
    got = tg.canonical_rows(rows, tg.automorphisms(tg.triangle()))
    want = jg.canonical_rows(rows, jg.automorphisms(jg.triangle()))
    assert got.tolist() == [[1, 2, 3], [1, 2, 3], [9, 9, 9]]
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# Graphs + compile (shared physical tables)
# ---------------------------------------------------------------------------


def test_graph_normalization():
    raw = [[1, 0], [0, 1], [2, 2], [3, 1]]
    g, ref = tg.Graph.from_edges(raw), jg.Graph.from_edges(raw)
    assert g.edges.tolist() == ref.edges.tolist() == [[0, 1], [1, 3]]
    assert g.degrees().tolist() == ref.degrees().tolist() == [1, 2, 0, 1]


def test_vertex_order_rank_is_total():
    g_j, g_t = graphs("zipf", 50, 120, seed=0, skew=1.0)
    for mode in ("id", "degree"):
        rank = tg.vertex_order_rank(g_t, mode)
        assert sorted(rank.tolist()) == list(range(g_t.n_vertices))
        assert rank.tobytes() == jg.vertex_order_rank(g_j, mode).tobytes()


def test_compile_shares_one_physical_table():
    g_j, g_t = graphs("er", 40, 100, seed=1)
    c = tg.compile_pattern(g_t, tg.clique(4))
    ref = jg.compile_pattern(g_j, jg.clique(4))
    assert len({id(r.data) for r in c.query.relations}) == 1
    assert len({r.table for r in c.query.relations}) == 1
    assert c.query.m == 6 * g_t.n_edges
    for r, w in zip(c.query.relations, ref.query.relations):
        assert (r.scheme, r.table) == (w.scheme, w.table)
        assert r.data.tobytes() == w.data.tobytes()
    c2 = tg.compile_pattern(g_t, tg.cycle(4))
    assert len({id(r.data) for r in c2.query.relations}) <= 2


def test_shared_table_histogram_matches_reference():
    # the port has no simulator scatter; its counterpart of the shared-input
    # placement is the histogram over the shared table, computed once per
    # (table, column) and equal to the reference's
    g_j, g_t = graphs("er", 40, 100, seed=2)
    for name in PATTERN_NAMES:
        qt = tg.compile_pattern(g_t, make_pattern(tg, name)).query
        qj = jg.compile_pattern(g_j, make_pattern(jg, name)).query
        assert t_histogram_signature(t_compute_stats(qt, 8)) == j_histogram_signature(
            j_compute_stats(qj, 8))


# ---------------------------------------------------------------------------
# Counts vs the brute-force oracle and the reference's dataplane run
# ---------------------------------------------------------------------------

SIZES = [(40, 120), (70, 260), (110, 480)]


@pytest.mark.parametrize("kind", ["er", "zipf"])
@pytest.mark.parametrize("size", range(len(SIZES)))
@pytest.mark.parametrize("name", PATTERN_NAMES)
def test_brute_force_matches_reference_oracle(kind, size, name):
    n, m = SIZES[size]
    g_j, g_t = graphs(kind, n, m, seed=100 + size)
    got = tg.brute_force_occurrences(g_t, make_pattern(tg, name))
    want = jg.brute_force_occurrences(g_j, make_pattern(jg, name))
    assert got.tobytes() == want.tobytes() and got.shape == want.shape
    assert len(np.unique(got, axis=0)) == len(got)


@functools.lru_cache(maxsize=None)
def reference_dataplane(kind, name):
    g_j, _ = graphs(kind, *SIZES[1], seed=101)
    return jg.enumerate_subgraphs(g_j, make_pattern(jg, name), p=8, backend="dataplane",
                                  lam=8, executor=JaxExecutor())


@pytest.mark.parametrize("kind", ["er", "zipf"])
@pytest.mark.parametrize("name", PATTERN_NAMES)
@pytest.mark.parametrize("batch", [True, False])
def test_dataplane_counts_match_reference(kind, name, batch):
    _, g_t = graphs(kind, *SIZES[1], seed=101)
    pat = make_pattern(tg, name)
    got = tg.enumerate_subgraphs(g_t, pat, p=8, backend="dataplane", lam=8,
                                 executor=DataplaneExecutor(8, device="cpu", batch_stages=batch))
    assert_same_enumeration(got, reference_dataplane(kind, name))
    assert got.occurrences.tobytes() == tg.brute_force_occurrences(g_t, pat).tobytes()


def test_dataplane_agrees_with_reference_on_load_bearing_case():
    g_j, g_t = graphs("zipf", 150, 700, seed=11, skew=2.0)
    got = tg.enumerate_subgraphs(g_t, tg.triangle(), p=8, lam=24, device="cpu")
    want = jg.enumerate_subgraphs(g_j, jg.triangle(), p=8, backend="dataplane", lam=24)
    assert_same_enumeration(got, want)
    assert got.occurrences.tobytes() == tg.brute_force_occurrences(g_t, tg.triangle()).tobytes()
    # the hub must be heavy so the run exercises cross/CP stages
    assert t_compute_stats(got.compiled.query, 24).n_heavy() > 0


def test_empty_and_tiny_graphs():
    cases = [(np.zeros((0, 2), np.int64), 5, 0), ([[0, 1]], None, 0),
             ([[0, 1], [1, 2], [0, 2]], None, 1)]
    for edges, nv, want in cases:
        g_t = tg.Graph.from_edges(edges, n_vertices=nv)
        g_j = jg.Graph.from_edges(edges, n_vertices=nv)
        got = tg.enumerate_subgraphs(g_t, tg.triangle(), p=4, device="cpu")
        ref = jg.enumerate_subgraphs(g_j, jg.triangle(), p=4, backend="simulator")
        assert got.count == ref.count == want
        assert got.occurrences.shape == ref.occurrences.shape
        assert got.occurrences.tobytes() == ref.occurrences.tobytes()
    assert got.occurrences.tolist() == [[0, 1, 2]]


def test_id_and_degree_orientation_agree():
    g_j, g_t = graphs("zipf", 60, 240, seed=13, skew=1.0)
    a = tg.enumerate_subgraphs(g_t, tg.cycle(4), p=8, orientation="id", lam=8, device="cpu")
    b = tg.enumerate_subgraphs(g_t, tg.cycle(4), p=8, orientation="degree", lam=8,
                               device="cpu")
    assert a.occurrences.tobytes() == b.occurrences.tobytes()
    ref = jg.enumerate_subgraphs(g_j, jg.cycle(4), p=8, backend="simulator",
                                 orientation="id", lam=8)
    assert a.occurrences.tobytes() == ref.occurrences.tobytes()


def test_submit_pattern_matches_reference_session():
    """The session door: the port's ``submit_pattern`` at p=8 ≡ the JAX
    session's, cold and warm (the warm repeat hits the plan cache)."""
    g_j, g_t = graphs("zipf", 110, 480, seed=102)
    session = JoinSession(p=8, device="cpu")
    ref = JaxSession(p=8, backend="dataplane")
    assert session.backend == "dataplane"
    for name in ("triangle", "cycle4"):
        want = ref.submit_pattern(make_pattern(jg, name), g_j, lam=8)
        cold = session.submit_pattern(make_pattern(tg, name), g_t, lam=8)
        warm = session.submit_pattern(make_pattern(tg, name), g_t, lam=8)
        assert_same_enumeration(cold, want)
        assert_same_enumeration(warm, want)
        assert warm.engine.retries == 0
    assert session.stats.plan_hits == 2 and session.stats.plan_misses == 2


def test_simulator_backend_raises_instead_of_falling_back():
    """``backend="simulator"`` runs the metered simulator — never a silent
    fallback to the data plane — and an unknown backend raises."""
    g = tg.Graph.from_edges([[0, 1], [1, 2], [0, 2]])
    got = tg.enumerate_subgraphs(g, tg.triangle(), p=4, backend="simulator")
    assert got.backend == "simulator" and got.occurrences.tolist() == [[0, 1, 2]]
    assert got.engine.sim.p == 4 and got.engine.load > 0
    session = JoinSession(p=4, device="cpu", backend="simulator")
    assert session.executor is None
    with pytest.raises(ValueError):
        tg.enumerate_subgraphs(g, tg.triangle(), p=4, backend="nonsense")
    with pytest.raises(ValueError):
        JoinSession(p=4, device="cpu", backend="nonsense")
