"""The port's coalescing service on the CPU: ``submit_coalesced`` and the
async queue ≡ serial ``submit``, and ≡ the JAX package's session.

Twins of tests/test_service_async.py.  Within the port, coalesced and
asynchronous results are byte-identical to serial submits of the same
session configuration (rows, row order, count, per-H counts).  Against the
JAX package's ``JoinSession`` at the same p=8 and λ, the row multiset, the
count and the per-H counts are equal (the reference runs its p=8 plan on a
one-device mesh, so its row order is not the port's; row order at equal p
is held in tests/test_torch_executor.py and test_torch_executor_mesh8.py).
"""

import functools
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core.query import JoinQuery, Relation, random_query
from repro.mpc.service import JoinSession as JaxSession
from repro_torch.core.query import query_from_arrays
from repro_torch.core.taxonomy import compute_stats
from repro_torch.mpc import (
    AdmissionError,
    DataplaneExecutor,
    JoinSession,
    coalesce_signature,
    programs_coalescible,
)
from repro_torch.mpc.program import compile_plan
from repro.core.taxonomy import compute_stats as j_compute_stats
from repro.mpc.program import compile_plan as j_compile_plan
from repro.mpc.program import programs_coalescible as j_programs_coalescible

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)

LAM = 4


def rows_key(rows):
    return sorted(map(tuple, np.asarray(rows).tolist()))


def skew_triangle():
    return random_query(np.random.default_rng(2), "clique", 3, tuples_per_rel=120,
                        dom_size=24, skew=2.0)


def perm_query(seed: int, n: int = 60) -> JoinQuery:
    """(A,B) ⋈ (B,C) over permutation graphs: no heavy values, so two seeds
    produce different data behind an identical plan cache key."""
    rng = np.random.default_rng(seed)
    ab = np.stack([np.arange(n), rng.permutation(n)], axis=1)
    bc = np.stack([np.arange(n), rng.permutation(n)], axis=1)
    return JoinQuery.make([Relation.make(("A", "B"), ab), Relation.make(("B", "C"), bc)])


def path_query(seed: int) -> JoinQuery:
    return random_query(np.random.default_rng(seed), "line", 3, tuples_per_rel=90,
                        dom_size=18, skew=1.2)


#: the named JAX-package queries the tests draw from
QUERIES = {
    "tri": skew_triangle,
    **{f"perm{s}": functools.partial(perm_query, s)
       for s in (3, 4, 10, 11, 12, 13, 21, 30, 31, 40, 41, 50, 51, 60, 61, 70)},
    "path5": functools.partial(path_query, 5),
}


@functools.lru_cache(maxsize=None)
def port_query(name):
    """One port query object per name (dedup keys on the bound arrays)."""
    q = QUERIES[name]()
    return query_from_arrays([(r.scheme, r.data, r.table) for r in q.relations])


@functools.lru_cache(maxsize=None)
def jax_result(name):
    """The JAX package's session answer for one named query, at p=8."""
    return JaxSession(p=8, backend="dataplane").submit(QUERIES[name](), lam=LAM)


def serial_reference(names):
    """Isolated serial submits in one fresh port session — the ground truth."""
    s = JoinSession(p=8, device="cpu")
    return [s.submit(port_query(n), lam=LAM) for n in names]


def assert_matches_jax(result, name):
    want = jax_result(name)
    assert result.count == want.count
    assert dict(result.per_h_counts) == dict(want.per_h_counts)
    assert rows_key(result.rows) == rows_key(want.rows)


def assert_same_bytes(got, want):
    assert got.count == want.count
    assert dict(got.per_h_counts) == dict(want.per_h_counts)
    assert got.rows.dtype == want.rows.dtype == np.int64
    assert got.rows.tobytes() == want.rows.tobytes()


# ---------------------------------------------------------------------------
# Byte identity: coalesced == serial
# ---------------------------------------------------------------------------


def test_coalesced_mixed_shapes_byte_identical_to_serial():
    names = ["tri", "perm3", "path5", "perm4"]
    serial = serial_reference(names)
    session = JoinSession(p=8, device="cpu")
    for _ in range(2):  # cold pass, then warm pass
        out = session.submit_coalesced([port_query(n) for n in names], lam=LAM)
        for r, s, n in zip(out, serial, names):
            assert_same_bytes(r, s)
            assert_matches_jax(r, n)
    assert session.stats.coalesced_batches == 2
    assert session.stats.max_coalesced_batch == len(names)


def test_stacked_distinct_data_byte_identical():
    # same plan key, different tables: dedup cannot apply, so these run the
    # stage-stacking path (one fused pass serves all four queries)
    names = ["perm10", "perm11", "perm12", "perm13"]
    serial = serial_reference(names)
    session = JoinSession(p=8, device="cpu")
    out = session.submit_coalesced([port_query(n) for n in names], lam=LAM)
    assert session.stats.deduped == 0
    for r, s, n in zip(out, serial, names):
        assert_same_bytes(r, s)
        assert_matches_jax(r, n)
        assert r.coalesced and r.batch_size == len(names)


def test_identical_submissions_share_one_execution():
    q = port_query("perm21")
    session = JoinSession(p=8, device="cpu")
    out = session.submit_coalesced([q, q, q, q], lam=LAM)
    assert session.stats.deduped == 3
    assert [r.deduplicated for r in out] == [False, True, True, True]
    for r in out:
        assert_matches_jax(r, "perm21")
        assert r.coalesced
    assert out[1].result is out[0].result


# ---------------------------------------------------------------------------
# Async queue: futures, admission control, drainer lifecycle
# ---------------------------------------------------------------------------


def test_submit_async_futures_match_serial():
    names = ["perm30", "tri", "perm31", "perm30"]
    serial = serial_reference(names)
    session = JoinSession(p=8, device="cpu")
    try:
        futs = [session.submit_async(port_query(n), lam=LAM) for n in names]
        out = [f.result(timeout=120) for f in futs]
        for r, s, n in zip(out, serial, names):
            assert_same_bytes(r, s)
            assert_matches_jax(r, n)
            assert r.e2e_us > 0.0 and r.e2e_us >= r.queue_us
        assert session.stats.async_submits == len(names)
        assert len(session.stats.e2e_us) == len(names)
    finally:
        session.close()
    with pytest.raises(RuntimeError):
        session.submit_async(port_query(names[0]), lam=LAM)


def test_admission_control_bounded_queue():
    session = JoinSession(p=8, device="cpu", max_queue=1, async_autostart=False)
    q = port_query("perm40")
    fut = session.submit_async(q, lam=LAM, block=False)
    with pytest.raises(AdmissionError):
        session.submit_async(q, lam=LAM, block=False)
    assert session.stats.rejected == 1
    assert session.stats.async_submits == 1
    # close() on a drainer-less session drains inline: the admitted request
    # still resolves (backpressure rejects, it never drops admitted work)
    session.close()
    assert_matches_jax(fut.result(timeout=0), "perm40")


def test_drainer_survives_a_failing_request():
    session = JoinSession(p=8, device="cpu", async_autostart=False)
    # lam=0 fails in plan preparation — a per-request failure that must
    # resolve its own future exceptionally without poisoning the batch
    f_bad = session.submit_async(port_query("perm41"), lam=0)
    f_good = session.submit_async(port_query("perm41"), lam=LAM)
    session.close()  # inline drain: one batch with both requests
    with pytest.raises(BaseException):
        f_bad.result(timeout=0)
    assert_matches_jax(f_good.result(timeout=0), "perm41")


def test_concurrent_clients_resolve_every_future_with_serial_bytes():
    """Stress: 8 client threads (more than the cores), a shortened switch
    interval, 6 requests each through one drainer; every future resolves
    within its timeout with the serial rows."""
    names = ["perm50", "perm51", "tri"]
    serial = dict(zip(names, serial_reference(names)))
    session = JoinSession(p=8, device="cpu")
    outs, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def client(c):
        try:
            futs = [(i, session.submit_async(port_query(names[(c + i) % 3]), lam=LAM))
                    for i in range(6)]
            for i, f in futs:
                outs[(c, i)] = f.result(timeout=120)
        except BaseException as e:      # surfaced by the assertion below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        session.close()
    assert not errors
    assert len(outs) == 48
    for (c, i), r in outs.items():
        assert_same_bytes(r, serial[names[(c + i) % 3]])
    assert session.stats.async_submits == 48 and len(session.stats.e2e_us) == 48


# ---------------------------------------------------------------------------
# Interleaved multi-query submission: plan LRU + learned caps
# ---------------------------------------------------------------------------


def test_interleaved_datasets_with_eviction_mid_stream():
    names = ["perm50", "perm51", "tri"]
    ref = dict(zip(names, serial_reference(names)))
    session = JoinSession(p=8, device="cpu", plan_cache_size=1)
    stream = ["perm50", "perm51", "tri", "perm50", "perm51", "tri", "perm51", "perm50"]
    for n in stream:
        assert_same_bytes(session.submit(port_query(n), lam=LAM), ref[n])
    assert session.stats.plan_evictions > 0
    batch = ["perm50", "perm51", "perm50", "tri", "perm51"]
    out = session.submit_coalesced([port_query(n) for n in batch], lam=LAM)
    for r, n in zip(out, batch):
        assert_same_bytes(r, ref[n])
        assert_matches_jax(r, n)
    # learned caps are executor-lifetime: eviction churn costs no retries
    assert session.stats.retries == 0


# ---------------------------------------------------------------------------
# Cache provenance: learned-caps counters split from the plan LRU
# ---------------------------------------------------------------------------


def test_caps_counters_are_distinct_from_plan_counters():
    session = JoinSession(p=8, device="cpu")
    q = port_query("tri")
    cold = session.submit(q, lam=LAM)
    warm = session.submit(q, lam=LAM)
    assert cold.caps_misses > 0 and cold.caps_hits == 0
    assert warm.caps_hits > 0 and warm.caps_misses == 0
    assert session.stats.caps_misses == cold.caps_misses
    assert session.stats.caps_hits == warm.caps_hits
    assert (session.stats.plan_hits, session.stats.plan_misses) == (1, 1)
    session.clear_plans()
    before = (session.stats.caps_hits, session.stats.caps_misses)
    session.submit(q, lam=LAM)  # plan miss, caps all hit
    assert session.stats.plan_misses == 2
    assert session.stats.caps_misses == before[1]
    assert session.stats.caps_hits > before[0]


# ---------------------------------------------------------------------------
# Coalescibility predicate + executor-level validation
# ---------------------------------------------------------------------------


def test_coalesce_signature_groups_same_shape_programs():
    progs, ref = {}, {}
    for n in ("perm60", "perm61", "tri"):
        q = port_query(n)
        progs[n] = compile_plan(q, compute_stats(q, LAM), 8)
        jq = QUERIES[n]()
        ref[n] = j_compile_plan(jq, j_compute_stats(jq, LAM), 8)
    assert coalesce_signature(progs["perm60"]) == coalesce_signature(progs["perm61"])
    for a, b in [("perm60", "perm61"), ("perm60", "tri")]:
        assert programs_coalescible(progs[a], progs[b]) == j_programs_coalescible(ref[a], ref[b])
    assert programs_coalescible(progs["perm60"], progs["perm61"])
    assert not programs_coalescible(progs["perm60"], progs["tri"])


def test_run_many_rejects_mismatched_op_sequences():
    q = port_query("tri")
    st = compute_stats(q, LAM)
    plain = compile_plan(q, st, 8)
    fused = compile_plan(q, st, 8, fuse_semijoin=True)
    assert plain.ops != fused.ops
    with pytest.raises(ValueError, match="coalescible"):
        DataplaneExecutor(8, device="cpu").run_many([plain, fused])


# ---------------------------------------------------------------------------
# SLO + latency percentiles
# ---------------------------------------------------------------------------


def test_slo_counters_and_percentiles():
    session = JoinSession(p=8, device="cpu", slo_target_us=1e12)
    q = port_query("perm70")
    session.submit(q, lam=LAM)
    session.submit(q, lam=LAM)
    assert session.stats.slo_ok == 2 and session.stats.slo_violations == 0
    session.slo_target_us = 0.0  # nothing is that fast
    session.submit(q, lam=LAM)
    assert session.stats.slo_violations == 1
    p50 = session.stats.percentile(50, window="warm")
    p99 = session.stats.percentile(99, window="warm")
    assert 0.0 < p50 <= p99
    assert session.stats.percentile(50, window="e2e") == 0.0  # no async yet
    with pytest.raises(ValueError):
        session.stats.percentile(50, window="nope")
