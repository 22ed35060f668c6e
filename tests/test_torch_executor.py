"""The port's DataplaneExecutor ≡ the JAX package's, on the CPU.

The cases are those of tests/test_executor_parity.py: a Zipf triangle with
isolated-attribute stages, a 4-cycle with a 2-D cartesian grid, a hub star
with a light-edge-free stage, a disconnected light subquery, and a fused
semijoin program.  Both packages compile the same data (the port through
its own compiler) and every check runs under both schedules:

* at p=8, count, per-H counts and the sorted row multiset equal the JAX
  package's SimulatorExecutor and the reference join;
* at p=1, rows in order (int64 bytes), retries and retry log equal the JAX
  DataplaneExecutor on a one-device mesh — the port's p is the machine
  count, the reference's its mesh size, so parity of order needs equal p.

Row order at p=8, against eight host devices, is in
tests/test_torch_executor_mesh8.py.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.query import (
    JoinQuery,
    Relation,
    disconnected_query,
    hub_star_query,
    random_query,
    reference_join,
)
from repro.core.taxonomy import compute_stats
from repro.mpc.executors import DataplaneExecutor, SimulatorExecutor
from repro.mpc.program import compile_plan, fuse_semijoin_pass
from repro_torch.core import query as tquery
from repro_torch.core import taxonomy as ttax
from repro_torch.mpc import DataplaneExecutor as TorchExecutor
from repro_torch.mpc import program as tprog

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)

CASES = {
    "triangle-zipf": (lambda: random_query(np.random.default_rng(2), "clique", 3,
                                           tuples_per_rel=200, dom_size=30, skew=2.0), 16, False),
    "four-cycle": (lambda: random_query(np.random.default_rng(7), "cycle", 4,
                                        tuples_per_rel=120, dom_size=10, skew=2.5), 24, False),
    "hub-star": (lambda: hub_star_query(n=48, hub_n=24, dom_size=25), 10, False),
    "disconnected": (lambda: disconnected_query(90, dom_size=12, skew=1.8), 8, False),
    "fused-star": (lambda: random_query(np.random.default_rng(4), "star", 4,
                                        tuples_per_rel=150, dom_size=12, skew=1.5), 3, True),
}


def rows_key(rows):
    return sorted(map(tuple, rows.tolist()))


def compile_both(q, lam, p, fused):
    tq = tquery.query_from_arrays([(r.scheme, r.data, r.table) for r in q.relations])
    jp = compile_plan(q, compute_stats(q, lam), p)
    tp = tprog.compile_plan(tq, ttax.compute_stats(tq, lam), p)
    if fused:
        jp, tp = fuse_semijoin_pass(jp), tprog.fuse_semijoin_pass(tp)
    return jp, tp


def assert_same_order(got, want):
    assert got.p == want.p
    assert got.rows.dtype == want.rows.dtype == np.int64
    assert got.rows.shape == want.rows.shape
    assert got.rows.tobytes() == want.rows.tobytes()
    assert got.count == want.count
    assert got.per_h_counts == want.per_h_counts
    assert got.retries == want.retries
    assert got.retry_log == want.retry_log


@pytest.mark.parametrize("batch", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_p8_matches_simulator_and_oracle(name, batch):
    make, lam, fused = CASES[name]
    q = make()
    jp, tp = compile_both(q, lam, 8, fused)
    sim = SimulatorExecutor(p=8).run(jp)
    got = TorchExecutor(8, device="cpu", batch_stages=batch).run(tp)
    oracle = reference_join(q)
    assert got.count == sim.count == len(oracle)
    assert got.per_h_counts == sim.per_h_counts
    assert rows_key(got.rows) == rows_key(sim.rows) == rows_key(oracle.data)
    assert got.rows.dtype == np.int64


@pytest.mark.parametrize("batch", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_p1_row_order_matches_reference_dataplane(name, batch):
    make, lam, fused = CASES[name]
    jp, tp = compile_both(make(), lam, 1, fused)
    mesh = jax.make_mesh((1,), ("join",))
    want = DataplaneExecutor(mesh=mesh, batch_stages=batch).run(jp)
    got = TorchExecutor(1, device="cpu", batch_stages=batch).run(tp)
    assert_same_order(got, want)


def test_output_overflow_retry_matches_reference():
    """Estimate-sized buffers (exact_caps=False) on a high-fanout join: the
    output estimate overflows, the retry grows only the output channel, and
    rows, retries and retry log still equal the reference's."""
    a = np.stack([np.repeat(np.arange(100), 2), np.tile(np.arange(2), 100)], axis=1)
    b = np.stack([np.tile(np.arange(2), 100), 1000 + np.repeat(np.arange(100), 2)], axis=1)
    q = JoinQuery.make([Relation.make(("A", "B"), a), Relation.make(("B", "C"), b)])
    jp, tp = compile_both(q, 2, 8, False)
    mesh = jax.make_mesh((1,), ("join",))
    want = DataplaneExecutor(mesh=mesh, exact_caps=False).run(jp)
    got = TorchExecutor(1, device="cpu", exact_caps=False).run(tp)
    assert got.count == 20_000 and got.retries >= 1
    assert all(kind == "out" for _, _, kind in got.retry_log)
    assert_same_order(got, want)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchExecutor(8)
