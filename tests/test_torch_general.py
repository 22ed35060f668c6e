"""The port's general (arbitrary-arity) route ≡ the JAX package's, on the CPU:
the compiler and the metered simulator.

Twin of tests/test_arity_differential.py's compiler and simulator half.
Both packages build the same query from the same numpy seed (each with its
own generator; the arrays are asserted equal), compile it, and every check
is exact:

* the compiled ``GeneralPlan`` (kind, root, tree edges, join order, shares),
  the op sequence, the stage signature and the plan-cache / coalescing keys
  are equal;
* the ``SimulatorExecutor`` rows are byte-identical, the count and per-H
  counts ``{("*",): n}`` equal, and ``merged_round_loads()`` equal, over the
  8 × 26 seeded battery shapes, the four families × skew {0, 0.9}, the
  forced-general triangle and the five edge cases;
* the rows equal the ``reference_join`` oracle as a sorted multiset.

The data plane half is in tests/test_torch_general_dataplane.py (row
order against the JAX DataplaneExecutor), test_torch_general_service.py
(warm repeats, coalescing, injected faults, the session) and
test_torch_general_mesh8.py (eight host devices).
"""

import numpy as np
import pytest
import torch

from repro.core import query as jq
from repro.core.taxonomy import compute_stats as j_compute_stats
from repro.mpc import program as jprog
from repro.mpc.executors import SimulatorExecutor as JSimExecutor
from repro_torch.core import query as tq
from repro_torch.core.taxonomy import compute_stats as t_compute_stats
from repro_torch.mpc import program as tprog
from repro_torch.mpc.executors import SimulatorExecutor as TSimExecutor

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)

P = 8
LAM = 4


def rows_key(rows):
    return sorted(map(tuple, np.asarray(rows).tolist()))


def assert_same_query(qt, qj):
    """The two packages' generators gave the same relations."""
    assert qt.force_general == qj.force_general
    assert len(qt.relations) == len(qj.relations)
    for rt, rj in zip(qt.relations, qj.relations):
        assert rt.scheme == rj.scheme and rt.table == rj.table
        np.testing.assert_array_equal(rt.data, rj.data)


def family(kind, **kw):
    qt, qj = tq.general_query(kind, **kw), jq.general_query(kind, **kw)
    assert_same_query(qt, qj)
    return qt, qj


def random_twin(rngs, **kw):
    """The same draws from each package's generator (two rngs at one seed)."""
    rt, rj = rngs
    qt, qj = tq.random_general_query(rt, **kw), jq.random_general_query(rj, **kw)
    assert_same_query(qt, qj)
    return qt, qj


def explicit(rels, force_general=False):
    """The same (scheme, data, table) triples as a query of each package."""
    qt = tq.JoinQuery.make([tq.Relation.make(s, d, table=t) for s, d, t in rels],
                           force_general=force_general)
    qj = jq.JoinQuery.make([jq.Relation.make(s, d, table=t) for s, d, t in rels],
                           force_general=force_general)
    assert_same_query(qt, qj)
    return qt, qj


def compile_twin(qt, qj, p=P, lam=LAM):
    """Compile in both packages (REPRO_VERIFY=1: both statically verified)
    and hold the plans equal."""
    ts, js = t_compute_stats(qt, lam), j_compute_stats(qj, lam)
    tp, jp = tprog.compile_plan(qt, ts, p), jprog.compile_plan(qj, js, p)
    assert tp.op_sequence() == jp.op_sequence()
    assert tp.round_names == jp.round_names
    assert repr(tp.general) == repr(jp.general)
    assert [repr(st.signature) for st in tp.stages] == [repr(st.signature) for st in jp.stages]
    assert [(st.hkey, st.ekey) for st in tp.stages] == [(st.hkey, st.ekey) for st in jp.stages]
    assert tprog.plan_cache_key(qt, ts, p) == jprog.plan_cache_key(qj, js, p)
    assert repr(tprog.coalesce_signature(tp)) == repr(jprog.coalesce_signature(jp))
    return tp, jp


def assert_sim_parity(qt, qj, p=P):
    """Simulator rows, counts and per-round loads equal the reference's; rows
    equal the oracle as a multiset."""
    tp, jp = compile_twin(qt, qj, p=p)
    got, want = TSimExecutor(p=p).run(tp), JSimExecutor(p=p).run(jp)
    assert got.rows.dtype == want.rows.dtype
    assert got.rows.shape == want.rows.shape
    assert got.rows.tobytes() == want.rows.tobytes()
    assert got.count == want.count
    assert got.per_h_counts == want.per_h_counts
    assert got.sim.merged_round_loads() == want.sim.merged_round_loads()
    oracle = tq.reference_join(qt)
    assert got.count == len(oracle)
    assert rows_key(got.rows) == rows_key(oracle.data)
    if qt.is_general:
        assert got.per_h_counts == {("*",): len(oracle)}
    return tp, got


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,want_kind", [
    ("star3", "yannakakis"), ("snowflake", "yannakakis"), ("path4", "yannakakis"),
    ("triangle", "hypercube"),
])
@pytest.mark.parametrize("p", [8, 64])
def test_general_plan_equals_reference(kind, want_kind, p):
    qt, qj = family(kind, n=60, dom_size=6, skew=0.5, seed=9)
    tp, jp = compile_twin(qt, qj, p=p)
    gen = tp.general
    assert gen.kind == want_kind
    assert (gen.kind, gen.tree_root, gen.tree_edges, gen.join_order, gen.shares) == (
        jp.general.kind, jp.general.tree_root, jp.general.tree_edges,
        jp.general.join_order, jp.general.shares)
    assert len(tp.stages) == 1 and tp.stages[0].hkey == ("*",)
    assert tp.emit == [] and tp.emit_counts == {}
    # a binary query forced down the general route keys apart from its
    # Theorem 6.2 plan
    if kind == "triangle":
        plain = tq.JoinQuery.make(list(qt.relations))
        assert not plain.is_general
        assert tprog.plan_cache_key(plain, t_compute_stats(plain, LAM), p) != \
            tprog.plan_cache_key(qt, t_compute_stats(qt, LAM), p)


def test_general_programs_coalesce_like_the_reference():
    pairs = [family("star3", n=80, dom_size=7, skew=0.6, seed=11),
             family("star3", n=50, dom_size=5, skew=0.0, seed=23),
             family("path4", n=50, dom_size=5, skew=0.0, seed=23),
             family("triangle", n=50, dom_size=5, skew=0.0, seed=23)]
    progs = [compile_twin(qt, qj) for qt, qj in pairs]
    for (ta, ja) in progs:
        for (tb, jb) in progs:
            assert tprog.programs_coalescible(ta, tb) == jprog.programs_coalescible(ja, jb)
    assert tprog.programs_coalescible(progs[0][0], progs[1][0])
    assert not tprog.programs_coalescible(progs[0][0], progs[3][0])


def test_rebind_keeps_the_general_plan():
    qt, qj = family("star3", n=60, dom_size=6, skew=0.5, seed=9)
    tp, _ = compile_twin(qt, qj)
    qt2, _ = family("star3", n=60, dom_size=6, skew=0.5, seed=10)
    bound = tp.rebind(qt2)
    assert bound.general is tp.general and bound.query is qt2 and bound.ops == tp.ops


# ---------------------------------------------------------------------------
# the ≥200-case seeded battery (simulator)
# ---------------------------------------------------------------------------

#: (n_rels, max_arity, n_attrs, tuples, dom, skew, share_tables) — the shapes
#: of tests/test_arity_differential.py
_BATTERY_SHAPES = [
    (2, 3, 4, 20, 6, 0.0, False),
    (3, 3, 5, 24, 8, 0.0, False),
    (3, 4, 5, 24, 6, 0.9, False),
    (4, 4, 6, 20, 5, 0.0, True),
    (4, 3, 5, 16, 4, 1.2, True),
    (5, 4, 6, 12, 4, 0.0, False),
    (1, 4, 4, 24, 6, 0.0, False),
    (3, 2, 4, 24, 6, 0.6, True),
]

_CASES_PER_SHAPE = 26   # 8 shapes × 26 = 208 cases


@pytest.mark.parametrize("shape_i", range(len(_BATTERY_SHAPES)))
def test_simulator_differential_battery(shape_i):
    n_rels, max_ar, n_attrs, tuples, dom, skew, share = _BATTERY_SHAPES[shape_i]
    rngs = (np.random.default_rng(1000 + shape_i), np.random.default_rng(1000 + shape_i))
    general = 0
    for _ in range(_CASES_PER_SHAPE):
        qt, qj = random_twin(
            rngs, n_rels=n_rels, max_arity=max_ar, n_attrs=n_attrs,
            tuples_per_rel=tuples, dom_size=dom, skew=skew,
            share_tables=share, allow_empty=True,
        )
        assert_sim_parity(qt, qj)
        general += qt.is_general
    # the all-binary shape (max arity 2) takes the Theorem 6.2 route; every
    # other shape exercises the general one
    assert general > 0 or max_ar == 2


# ---------------------------------------------------------------------------
# canonical families × skew, the forced-general triangle, the edge cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["star3", "snowflake", "path4", "triangle"])
@pytest.mark.parametrize("skew", [0.0, 0.9])
def test_families_simulator(kind, skew):
    qt, qj = family(kind, n=60, dom_size=6, skew=skew, seed=17)
    tp, got = assert_sim_parity(qt, qj)
    names = [n for n, _ in got.sim.load_report()]
    assert "hc-route" in names
    assert ("yan-up" in names) == (tp.general.kind == "yannakakis")


def test_binary_triangle_forced_general_simulator():
    qt, qj = family("triangle", n=120, dom_size=9, skew=0.7, seed=5)
    assert qt.force_general and qt.is_general
    tp, _ = assert_sim_parity(qt, qj)
    assert tp.general.kind == "hypercube"


EDGE_CASES = {
    "empty-relation": lambda: explicit([
        (("A", "B", "C"), np.array([[1, 2, 3], [2, 3, 4]]), None),
        (("C", "D"), np.zeros((0, 2), dtype=np.int64), None)]),
    "singleton-and-unary": lambda: explicit([
        (("A", "B"), np.array([[1, 2]]), None),
        (("B",), np.array([[2], [3]]), None)]),
    "single-relation": lambda: explicit([
        (("A", "B", "C"), np.array([[1, 2, 3], [4, 5, 6], [1, 1, 1]]), None)]),
    "disconnected": lambda: explicit([
        (("A", "B"), np.array([[1, 2], [3, 4]]), None),
        (("C", "D", "E"), np.array([[5, 6, 7], [8, 9, 10], [5, 5, 5]]), None)]),
    "shared-table": lambda: explicit([
        (("A", "B", "C"), np.random.default_rng(3).integers(0, 6, size=(30, 3)), "t3"),
        (("B", "C", "D"), np.random.default_rng(3).integers(0, 6, size=(30, 3)), "t3")]),
}

EDGE_COUNTS = {"empty-relation": 0, "singleton-and-unary": 1, "single-relation": 3,
               "disconnected": 6}


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_edge_cases_simulator(name):
    qt, qj = EDGE_CASES[name]()
    _, got = assert_sim_parity(qt, qj)
    if name in EDGE_COUNTS:
        assert got.count == EDGE_COUNTS[name]
    if name == "empty-relation":
        assert got.per_h_counts == {("*",): 0}


def test_unknown_op_still_raises_on_the_simulator():
    from dataclasses import replace

    qt, _ = family("star3", n=40, dom_size=5, skew=0.0, seed=3)
    prog = tprog.compile_plan(qt, t_compute_stats(qt, LAM), 4)
    with pytest.raises(NotImplementedError, match="unknown op"):
        TSimExecutor(p=4).run(replace(prog, ops=prog.ops + (object(),)))


# ---------------------------------------------------------------------------
# hypothesis layer (as in the reference; the seeded battery is the floor)
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st

    _HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - optional extra
    _HAVE_HYPOTHESIS = False


if _HAVE_HYPOTHESIS:

    @settings(max_examples=25, deadline=None)
    @given(
        seed=st.integers(0, 2**31 - 1),
        n_rels=st.integers(1, 5),
        skew=st.sampled_from([0.0, 0.8]),
        share=st.booleans(),
    )
    def test_hypothesis_simulator_differential(seed, n_rels, skew, share):
        rngs = (np.random.default_rng(seed), np.random.default_rng(seed))
        qt, qj = random_twin(
            rngs, n_rels=n_rels, max_arity=4, n_attrs=5, tuples_per_rel=20,
            dom_size=6, skew=skew, share_tables=share, allow_empty=True,
        )
        assert_sim_parity(qt, qj)

else:  # pragma: no cover - optional extra

    @pytest.mark.skip(reason="property test needs the optional hypothesis extra")
    def test_hypothesis_simulator_differential():
        pass
