"""Edge cases of the port's join path ≡ the JAX package's, on the CPU.

Twins of tests/test_engine_edgecases.py and of the key-compression and
overflow-retry cases of tests/test_executor_parity.py: empty relations, an
empty isolated piece (the ``geo.skip`` stage), singletons, ids shifted by
5·10^7 (the ranked-key fallback), negative ids, a shared-table self-join,
count-only runs, estimate-sized buffers with overflow retries, and ids past
int32.  Every case compiles the same data in both packages and checks:

* p=8 — count, per-H counts and the row multiset equal the JAX package's
  SimulatorExecutor and the reference join;
* row order — the same plan on one machine equals the JAX DataplaneExecutor
  on a one-device mesh byte for byte, with equal retries and retry log.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.query import JoinQuery, Relation, hub_star_query, random_query, reference_join
from repro.core.taxonomy import compute_stats
from repro.mpc.executors import DataplaneExecutor, SimulatorExecutor
from repro.mpc.program import compile_plan
from repro_torch.core import query as tquery
from repro_torch.core import taxonomy as ttax
from repro_torch.mpc import DataplaneExecutor as TorchExecutor
from repro_torch.mpc import program as tprog

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)

EMPTY = np.zeros((0, 2), np.int64)


def rows_key(rows):
    return sorted(map(tuple, rows.tolist()))


def to_port(q):
    return tquery.query_from_arrays([(r.scheme, r.data, r.table) for r in q.relations])


def compile_both(q, lam, p):
    tq = to_port(q)
    return compile_plan(q, compute_stats(q, lam), p), tprog.compile_plan(
        tq, ttax.compute_stats(tq, lam), p)


def assert_same_order(got, want):
    assert got.count == want.count
    assert got.per_h_counts == want.per_h_counts
    assert got.retries == want.retries
    assert got.retry_log == want.retry_log
    if want.rows is None:
        assert got.rows is None
        return
    assert got.rows.dtype == want.rows.dtype == np.int64
    assert got.rows.shape == want.rows.shape
    assert got.rows.tobytes() == want.rows.tobytes()


def run_both(q, lam, p=8, materialize=True, exact_caps=True):
    """Port vs reference at p machines (against the simulator and the
    oracle) and on one machine (row order against the reference dataplane)."""
    jp, tp = compile_both(q, lam, p)
    sim = SimulatorExecutor(p=p).run(jp)
    got = TorchExecutor(p, device="cpu", exact_caps=exact_caps).run(tp, materialize=materialize)
    oracle = reference_join(q)
    assert got.count == sim.count == len(oracle)
    assert got.per_h_counts == sim.per_h_counts
    if materialize:
        assert rows_key(got.rows) == rows_key(sim.rows) == rows_key(oracle.data)
    else:
        assert got.rows is None
    mesh = jax.make_mesh((1,), ("join",))
    want1 = DataplaneExecutor(mesh=mesh, exact_caps=exact_caps).run(jp, materialize=materialize)
    got1 = TorchExecutor(1, device="cpu", exact_caps=exact_caps).run(tp, materialize=materialize)
    assert_same_order(got1, want1)
    return jp, got, got1


def triangle(shift=0):
    q = random_query(np.random.default_rng(2), "clique", 3, tuples_per_rel=200, dom_size=30,
                     skew=2.0)
    return JoinQuery.make([Relation.make(r.scheme, r.data + shift) for r in q.relations])


def two_copy_query():
    """Two logical copies of one physical table (a self-join), with a
    planted heavy hub."""
    rng = np.random.default_rng(5)
    planted = np.stack([np.full(30, 99), np.arange(30)], axis=1)
    tab = np.unique(np.concatenate([planted, rng.integers(0, 40, (120, 2))]), axis=0)
    return JoinQuery.make([Relation(scheme=("A", "B"), data=tab, table="edges"),
                           Relation(scheme=("B", "C"), data=tab, table="edges")])


def test_all_relations_empty():
    q = JoinQuery.make([Relation.make(("A", "B"), EMPTY), Relation.make(("B", "C"), EMPTY)])
    _, got, got1 = run_both(q, lam=4, p=4)
    assert got.count == 0 and got.rows.shape == (0, 3) and got1.rows.shape == (0, 3)


def test_one_empty_relation_with_heavy_partner():
    b = np.stack([np.full(50, 7), np.arange(50)], axis=1)   # heavy value 7
    q = JoinQuery.make([Relation.make(("A", "B"), EMPTY), Relation.make(("B", "C"), b)])
    program, got, _ = run_both(q, lam=4, p=4)
    assert got.count == 0 and len(program.stages) >= 1


def test_empty_isolated_piece_skips_cp_stage():
    q = hub_star_query(n=30, hub_n=20, dom_size=20)
    rels = list(q.relations)
    rels[2] = Relation.make(rels[2].scheme, EMPTY)
    q = JoinQuery.make(rels)
    program, got, got1 = run_both(q, lam=6, p=4)
    iso = {st.hkey for st in program.stages if st.plan.isolated}
    assert iso, "the hub configuration must compile an isolated stage"
    for hkey in iso:
        assert hkey not in got.per_h_counts and hkey not in got1.per_h_counts


def test_singleton_relations():
    q = JoinQuery.make([Relation.make(("A", "B"), np.array([[1, 2]], np.int64)),
                        Relation.make(("B", "C"), np.array([[2, 3]], np.int64))])
    _, got, _ = run_both(q, lam=2, p=8)
    assert got.rows.tolist() == [[1, 2, 3]]


@pytest.mark.parametrize("shift", [50_000_000, -20], ids=["shifted-5e7", "negative-ids"])
def test_shifted_and_negative_ids(shift):
    """Ids shifted by 5·10^7 keep every value int32-safe but put the packed
    composite key past 2^31 (the ranked fallback); negative ids rule packing
    out altogether.  Both must still equal the reference."""
    _, got, _ = run_both(triangle(shift), lam=16, p=8)
    assert got.count == len(reference_join(triangle()))


def test_shared_table_self_join():
    q = two_copy_query()
    tq = to_port(q)
    assert tq.relations[0].data is tq.relations[1].data, "one physical table"
    _, got, _ = run_both(q, lam=8, p=6)
    assert got.count > 0


def test_count_only_runs():
    _, got, got1 = run_both(triangle(), lam=16, p=8, materialize=False)
    assert got.rows is None and got1.rows is None and got.count > 0


@pytest.mark.parametrize("case", ["few-valued", "high-fanout"])
def test_estimate_caps_overflow_retries(case):
    """``exact_caps=False``: estimate-sized buffers overflow and retry; the
    retries and the retry log equal the reference's."""
    rng = np.random.default_rng(9)
    if case == "few-valued":
        a = np.stack([rng.integers(0, 400, 600), rng.integers(0, 4, 600)], axis=1)
        b = np.stack([rng.integers(0, 4, 600), rng.integers(0, 400, 600)], axis=1)
    else:
        a = np.stack([np.repeat(np.arange(100), 2), np.tile(np.arange(2), 100)], axis=1)
        b = np.stack([np.tile(np.arange(2), 100), 1000 + np.repeat(np.arange(100), 2)], axis=1)
    q = JoinQuery.make([Relation.make(("A", "B"), a), Relation.make(("B", "C"), b)])
    _, got, got1 = run_both(q, lam=2, p=8, exact_caps=False)
    assert got1.retries >= 1, "the estimates must have been exceeded"


def test_ids_past_int32_raise_the_same_error():
    big = np.array([[1, 2**33], [2, 5]], np.int64)
    q = JoinQuery.make([Relation.make(("A", "B"), big),
                        Relation.make(("B", "C"), np.array([[2**33, 7], [5, 1]], np.int64))])
    jp, tp = compile_both(q, lam=2, p=4)
    mesh = jax.make_mesh((1,), ("join",))
    with pytest.raises(ValueError) as want:
        DataplaneExecutor(mesh=mesh).run(jp)
    with pytest.raises(ValueError) as got:
        TorchExecutor(4, device="cpu").run(tp)
    assert str(got.value) == str(want.value)
