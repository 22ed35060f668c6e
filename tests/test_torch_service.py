"""The port's JoinSession on the CPU's plain path.

* a warm repeat of a query hits the plan cache and the learned capacities,
  retries nothing, and returns rows byte-identical to the cold submit;
* a plan-cache hit rebinds the cached program onto new data with the same
  key and answers for the new data;
* batch submission shares the histogram pass and answers like single
  submits; failures surface as the typed service errors;
* without CUDA, the default device raises instead of running on the CPU.
"""

import numpy as np
import pytest
import torch

from repro.core.query import JoinQuery, Relation, random_query, reference_join
from repro_torch.core.query import query_from_arrays
from repro_torch.mpc import JoinSession
from repro_torch.mpc.faults import DeadlineExceededError, JoinServiceError

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)


def rows_key(rows):
    return sorted(map(tuple, rows.tolist()))


def to_torch_query(q):
    return query_from_arrays([(r.scheme, r.data, r.table) for r in q.relations])


def skew_triangle():
    return random_query(np.random.default_rng(2), "clique", 3, tuples_per_rel=200,
                        dom_size=30, skew=2.0)


def perm_query(seed: int, n: int = 60) -> JoinQuery:
    """(A,B) ⋈ (B,C) over permutation graphs: no heavy values, so two seeds
    give different data behind one plan cache key."""
    rng = np.random.default_rng(seed)
    ab = np.stack([np.arange(n), rng.permutation(n)], axis=1)
    bc = np.stack([np.arange(n), rng.permutation(n)], axis=1)
    return JoinQuery.make([Relation.make(("A", "B"), ab), Relation.make(("B", "C"), bc)])


def test_warm_repeat_is_byte_identical_with_zero_retries():
    q = skew_triangle()
    session = JoinSession(p=8, device="cpu")
    cold = session.submit(to_torch_query(q), lam=16)
    warm = session.submit(to_torch_query(q), lam=16)
    assert not cold.plan_cache_hit and warm.plan_cache_hit
    assert warm.compile_us == 0.0
    assert warm.retries == 0 and warm.caps_hits > 0 and warm.caps_misses == 0
    assert warm.rows.dtype == np.int64
    assert warm.rows.tobytes() == cold.rows.tobytes()
    assert cold.count == len(reference_join(q))
    assert rows_key(cold.rows) == rows_key(reference_join(q).data)
    assert "plan/compile" in cold.spans_us and "plan/compile" not in warm.spans_us
    assert session.stats.submits == 2 and session.stats.plan_hits == 1


def test_plan_cache_hit_rebinds_onto_new_data():
    session = JoinSession(p=8, device="cpu")
    q0, q1 = perm_query(0), perm_query(1)
    r0 = session.submit(to_torch_query(q0), lam=4)
    r1 = session.submit(to_torch_query(q1), lam=4)
    assert r1.plan_cache_hit and r1.plan_key == r0.plan_key
    assert rows_key(r0.rows) == rows_key(reference_join(q0).data)
    assert rows_key(r1.rows) == rows_key(reference_join(q1).data)
    assert rows_key(r0.rows) != rows_key(r1.rows)
    assert len(session.cached_plan_keys) == 1


def test_submit_batch_matches_single_submits():
    queries = [skew_triangle(), perm_query(3)]
    batch = JoinSession(p=8, device="cpu").submit_batch(
        [to_torch_query(q) for q in queries], lam=8)
    single = JoinSession(p=8, device="cpu")
    for q, got in zip(queries, batch):
        want = single.submit(to_torch_query(q), lam=8)
        assert got.rows.tobytes() == want.rows.tobytes()
        assert got.count == len(reference_join(q))


def test_failures_are_typed_and_quarantine_the_plan():
    session = JoinSession(p=8, device="cpu")
    with pytest.raises(DeadlineExceededError) as err:
        session.submit(to_torch_query(perm_query(0)), lam=4, deadline_s=-1.0)
    assert isinstance(err.value, JoinServiceError) and err.value.query is not None
    assert session.stats.failed == 1 and session.stats.deadline_exceeded == 1
    assert session.stats.quarantined_plans == 1 and not session.cached_plan_keys
    ok = session.submit(to_torch_query(perm_query(0)), lam=4)
    assert not ok.plan_cache_hit and ok.count == len(reference_join(perm_query(0)))


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        JoinSession(p=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        JoinSession(p=4, device="cuda")
    assert JoinSession(p=4, device="cpu").executor.device.type == "cpu"
