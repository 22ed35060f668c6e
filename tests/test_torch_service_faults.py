"""Chaos suite of the port: fault injection and the hardened JoinSession on
the CPU.

Twins of tests/test_service_faults.py, holding the port to the same bar:

* typed failures — every failed request surfaces a ``JoinServiceError``
  naming its query, with the root cause (executor frames included) on
  ``__cause__``;
* no hung futures — under any seeded FaultPlan every admitted request
  resolves exactly once, including requests in flight when the drainer dies;
* isolation — a poisoned query in a coalesced batch fails alone and its
  batchmates return the bytes of a fault-free serial run;
* recovery — caches touched by a failed attempt are quarantined, so once
  the plan drains the session converges back to retries = 0.

FaultPlan decisions are pure functions of (seed, site, event, rule): the
port's plan makes the same decisions as the JAX package's for the same
seed, which the first test checks.  Answers are also held against the JAX
package's session (row multiset, count, per-H counts at p=8).
"""

import functools
import time
import traceback
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro.core.query import JoinQuery, Relation, random_query
from repro.mpc import FaultPlan as JaxFaultPlan
from repro.mpc import FaultRule as JaxFaultRule
from repro.mpc.faults import InjectedDispatchError as JaxInjectedDispatchError
from repro.mpc.service import JoinSession as JaxSession
from repro_torch.core.query import query_from_arrays
from repro_torch.core.taxonomy import compute_stats
from repro_torch.mpc import (
    DataplaneExecutor,
    DeadlineExceededError,
    DegradedSessionError,
    FaultPlan,
    FaultRule,
    InjectedDispatchError,
    JoinServiceError,
    JoinSession,
    QueryFailedError,
    RetryExhaustedError,
    RunConfig,
)
from repro_torch.mpc.faults import describe_query
from repro_torch.mpc.program import compile_plan
from repro_torch.mpc.service import _Request

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)

LAM = 4


def rows_key(rows):
    return sorted(map(tuple, np.asarray(rows).tolist()))


def perm_query(seed: int, n: int = 60) -> JoinQuery:
    """(A,B) ⋈ (B,C) permutation graphs: distinct data, one plan key."""
    rng = np.random.default_rng(seed)
    ab = np.stack([np.arange(n), rng.permutation(n)], axis=1)
    bc = np.stack([np.arange(n), rng.permutation(n)], axis=1)
    return JoinQuery.make([Relation.make(("A", "B"), ab), Relation.make(("B", "C"), bc)])


def skew_triangle():
    return random_query(np.random.default_rng(2), "clique", 3, tuples_per_rel=120,
                        dom_size=24, skew=2.0)


def jax_query(name):
    return skew_triangle() if name == "tri" else perm_query(int(name[4:]))


@functools.lru_cache(maxsize=None)
def port_query(name):
    q = jax_query(name)
    return query_from_arrays([(r.scheme, r.data, r.table) for r in q.relations])


@functools.lru_cache(maxsize=None)
def jax_result(name):
    """The JAX package's session answer for one named query, at p=8."""
    return JaxSession(p=8, backend="dataplane").submit(jax_query(name), lam=LAM)


def assert_matches_jax(result, name):
    want = jax_result(name)
    assert result.count == want.count
    assert dict(result.per_h_counts) == dict(want.per_h_counts)
    assert rows_key(result.rows) == rows_key(want.rows)


def serial_reference(names):
    s = JoinSession(p=8, device="cpu")
    return [s.submit(port_query(n), lam=LAM) for n in names]


def outcomes(futures, timeout=120.0):
    """Resolve every future (bounded wait — a hang IS the failure)."""
    outs = []
    for f in futures:
        try:
            outs.append(f.result(timeout=timeout))
        except BaseException as e:
            outs.append(e)
    return outs


# ---------------------------------------------------------------------------
# FaultPlan determinism and rule mechanics
# ---------------------------------------------------------------------------


def test_fault_plan_is_deterministic_and_rule_scoped():
    def run(plan_cls, rule_cls, err, seed):
        fp = plan_cls([rule_cls(site="dispatch", rate=0.3)], seed=seed)
        fired = []
        for _ in range(200):
            try:
                fp.at_dispatch("output")
                fired.append(0)
            except err:
                fired.append(1)
        return fired

    a, b = (run(FaultPlan, FaultRule, InjectedDispatchError, 7) for _ in range(2))
    assert a == b, "same seed ⇒ identical injection schedule"
    assert a == run(JaxFaultPlan, JaxFaultRule, JaxInjectedDispatchError, 7), \
        "the port's plan decides as the reference's does"
    assert 20 < sum(a) < 110
    assert run(FaultPlan, FaultRule, InjectedDispatchError, 8) != a

    fp = FaultPlan([FaultRule(site="dispatch", rate=1.0, count=2, after=3,
                              rounds=("step1",))], seed=0)
    hits = 0
    for rnd in ["step1"] * 10 + ["output"] * 10:
        try:
            fp.at_dispatch(rnd)
        except InjectedDispatchError:
            hits += 1
    assert hits == 2, "after=3 skips 3 step1 events, count=2 then drains"
    assert fp.drained() and fp.injected["dispatch"] == 2
    assert all(rnd == "step1" for _, rnd, _, _ in fp.log)

    with pytest.raises(ValueError):
        FaultRule(site="nonsense")
    with pytest.raises(ValueError):
        FaultRule(site="dispatch", rate=1.5)


def test_overflow_rules_only_force_carried_channels():
    fp = FaultPlan.persistent_overflow(channels=("slot", "out"))
    assert fp.overflow("step1") == ("out", "slot")
    assert FaultPlan.none().overflow("step1") == ()
    assert FaultPlan.none().drained()


# ---------------------------------------------------------------------------
# Typed errors + traceback preservation
# ---------------------------------------------------------------------------


def test_dispatch_fault_surfaces_as_query_failed_with_executor_frames():
    q = port_query("perm2")
    session = JoinSession(p=8, device="cpu",
                          fault_plan=FaultPlan.dispatch_failures(1.0, count=1))
    with pytest.raises(QueryFailedError) as ei:
        session.submit(q, lam=LAM)
    err = ei.value
    assert err.query is q and describe_query(q) in str(err)
    assert isinstance(err.__cause__, InjectedDispatchError)
    chain = "".join(traceback.format_exception(type(err), err, err.__traceback__))
    assert "_run_buckets" in chain
    assert "InjectedDispatchError" in chain
    assert session.stats.failed == 1
    assert session.stats.quarantined_plans == 1
    r = session.submit(q, lam=LAM)
    assert_matches_jax(r, "perm2")
    assert r.retries == 0


def test_compile_fault_fires_on_a_first_build_only():
    """The port's compile site: the first build of a (round, key, caps)
    bucket.  A warm repeat builds nothing new, so the same rule no longer
    fires once every bucket of the query has been built."""
    q = port_query("perm3")
    session = JoinSession(p=8, device="cpu")
    session.submit(q, lam=LAM)
    session.fault_plan = FaultPlan([FaultRule(site="compile", rate=1.0)])
    r = session.submit(q, lam=LAM)
    assert session.fault_plan.injected["compile"] == 0
    assert_matches_jax(r, "perm3")
    fresh = JoinSession(p=8, device="cpu",
                        fault_plan=FaultPlan([FaultRule(site="compile", rate=1.0, count=1)]))
    with pytest.raises(QueryFailedError) as ei:
        fresh.submit(q, lam=LAM)
    assert "InjectedCompileError" in repr(ei.value.cause)
    assert_matches_jax(fresh.submit(q, lam=LAM), "perm3")


def test_all_faults_resolve_as_typed_join_service_errors():
    session = JoinSession(p=8, device="cpu")
    q = port_query("perm3")
    with pytest.raises(JoinServiceError) as ei:
        session.submit(q, lam=0)
    assert ei.value.query is q
    assert isinstance(ei.value, RuntimeError)


# ---------------------------------------------------------------------------
# max_retries exhaustion + learned-caps quarantine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_stages", [True, False])
def test_retry_exhaustion_raises_typed_and_quarantines(batch_stages):
    q = port_query("perm4")
    prog = compile_plan(q, compute_stats(q, LAM), 8)
    ex = DataplaneExecutor(8, device="cpu", max_retries=2, batch_stages=batch_stages)
    with pytest.raises(RetryExhaustedError) as ei:
        ex.run(prog.rebind(q), config=RunConfig(
            fault_plan=FaultPlan.persistent_overflow(channels=("slot",))))
    err = ei.value
    assert err.op_round is not None and err.attempts == 3
    assert any("slot" in entry[2] for entry in err.attempt_log)
    res = ex.run(prog.rebind(q))
    assert res.retries == 0
    assert_matches_jax(res, "perm4")


def test_retry_exhaustion_through_run_many_and_service():
    names = ["perm5", "perm6"]
    progs = [compile_plan(port_query(n), compute_stats(port_query(n), LAM), 8) for n in names]
    ex = DataplaneExecutor(8, device="cpu", max_retries=1)
    with pytest.raises(RetryExhaustedError):
        ex.run_many(progs, config=RunConfig(
            fault_plan=FaultPlan.persistent_overflow(channels=("slot",))))
    session = JoinSession(p=8, executor=DataplaneExecutor(8, device="cpu", max_retries=1))
    session.fault_plan = FaultPlan.persistent_overflow(channels=("slot",))
    with pytest.raises(QueryFailedError) as ei:
        session.submit(port_query(names[0]), lam=LAM)
    assert isinstance(ei.value.cause, RetryExhaustedError)
    assert ei.value.attempt_log, "retry entries travel on the wrapper"
    session.fault_plan = None
    r1 = session.submit(port_query(names[0]), lam=LAM)
    r2 = session.submit(port_query(names[0]), lam=LAM)
    assert r1.retries == 0 and r2.retries == 0
    assert r2.caps_misses == 0, "the warm repeat starts at learned caps"
    assert_matches_jax(r2, names[0])


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------


def test_expired_deadline_fails_before_any_dispatch():
    session = JoinSession(p=8, device="cpu")
    q = port_query("perm7")
    with pytest.raises(DeadlineExceededError) as ei:
        session.submit(q, lam=LAM, deadline_s=-0.001)
    assert ei.value.query is q
    assert session.stats.deadline_exceeded == 1
    assert session.stats.failed == 1
    assert_matches_jax(session.submit(q, lam=LAM), "perm7")


def test_deadline_trips_between_dispatches_mid_run():
    # the plan is cached by a first submit, so the budget cannot run out
    # before execution; the injected latency then guarantees it runs out
    # between two dispatches
    session = JoinSession(p=8, device="cpu")
    q = port_query("tri")
    session.submit(q, lam=LAM)
    session.fault_plan = FaultPlan([FaultRule(site="latency", rate=1.0, delay_s=0.05)],
                                   seed=5)
    with pytest.raises(DeadlineExceededError) as ei:
        session.submit(q, lam=LAM, deadline_s=0.03)
    err = ei.value
    assert err.query is q
    assert isinstance(err.__cause__, DeadlineExceededError)
    assert err.op_round is not None, "raised between dispatches, op round known"
    assert_matches_jax(session.submit(q, lam=LAM), "tri")


def test_async_deadline_counts_queue_time():
    session = JoinSession(p=8, device="cpu", async_autostart=False)
    fut = session.submit_async(port_query("perm8"), lam=LAM, deadline_s=0.02)
    time.sleep(0.1)         # budget burns away while queued, drainer asleep
    session.close()         # inline drain resolves the (now expired) request
    with pytest.raises(DeadlineExceededError):
        fut.result(timeout=0)


# ---------------------------------------------------------------------------
# Coalesced-group failure isolation
# ---------------------------------------------------------------------------


def test_poisoned_query_fails_alone_batchmates_byte_identical():
    names = ["perm10", "perm11", "perm12", "perm13"]
    serial = serial_reference(names)
    # injection 1 fails the fused 4-query run; injection 2 fails the first
    # member's serial fallback; the rule then drains, so members 2..4 finish
    session = JoinSession(p=8, device="cpu",
                          fault_plan=FaultPlan([FaultRule(site="dispatch", rate=1.0, count=2)]),
                          async_autostart=False)
    futs = [session.submit_async(port_query(n), lam=LAM) for n in names]
    session.close()     # one inline drain batch → one coalesced group
    outs = outcomes(futs, timeout=0)
    assert isinstance(outs[0], QueryFailedError)
    assert outs[0].query is port_query(names[0])
    for out, ref, n in zip(outs[1:], serial[1:], names[1:]):
        assert out.rows.tobytes() == ref.rows.tobytes(), "survivor byte-identity"
        assert out.coalesced is False, "fallback runs are serial passes"
        assert_matches_jax(out, n)
    assert session.stats.degraded_fallbacks == 1
    assert session.stats.failed == 1


# ---------------------------------------------------------------------------
# Drainer supervision: crash, degraded state, restart
# ---------------------------------------------------------------------------


def _wait_degraded(session, timeout=30.0):
    t0 = time.monotonic()
    while not session.degraded:
        if time.monotonic() - t0 > timeout:
            raise AssertionError("session never degraded")
        time.sleep(0.02)


def test_drainer_crash_resolves_every_future_and_degrades(tmp_path):
    names = ["perm20", "perm21", "perm22"]
    session = JoinSession(p=8, device="cpu",
                          fault_plan=FaultPlan([FaultRule(site="drainer", rate=1.0, count=1)]),
                          async_autostart=False, heartbeat_path=tmp_path / "hb")
    futs = [session.submit_async(port_query(n), lam=LAM) for n in names]
    session.start()     # the first drain batch crashes between dequeue and demux
    _wait_degraded(session)
    outs = outcomes(futs, timeout=30)
    assert all(isinstance(o, DegradedSessionError) for o in outs), \
        "zero hung futures: in-flight batch AND queued leftovers resolve"
    assert session.stats.drainer_crashes == 1
    assert session.stats.failed == len(names)
    assert (tmp_path / "hb").exists(), "heartbeat beaten before the crash"
    with pytest.raises(DegradedSessionError):
        session.submit_async(port_query(names[0]), lam=LAM)
    with pytest.raises(DegradedSessionError):
        session.start()
    session.restart()
    assert not session.degraded
    r = session.submit_async(port_query(names[0]), lam=LAM).result(timeout=120)
    assert_matches_jax(r, names[0])
    session.close()


def test_close_sweeps_queue_of_degraded_session():
    session = JoinSession(p=8, device="cpu",
                          fault_plan=FaultPlan([FaultRule(site="drainer", rate=1.0, count=1)]),
                          async_autostart=False)
    f1 = session.submit_async(port_query("perm23"), lam=LAM)
    session.start()
    _wait_degraded(session)
    # a request admitted just as the drainer dies must not hang forever
    straggler = _Request(query=port_query("perm24"), lam=LAM, future=Future(),
                         t_enqueue=time.perf_counter())
    session._queue.put(straggler)
    session.close()
    outs = outcomes([f1, straggler.future], timeout=5)
    assert all(isinstance(o, DegradedSessionError) for o in outs)


def test_resolve_is_exactly_once():
    req = _Request(query=None, future=Future())
    assert JoinSession._resolve(req, RuntimeError("first"))
    assert not JoinSession._resolve(req, RuntimeError("second")), "done futures stay won"
    assert not JoinSession._resolve(_Request(query=None), RuntimeError("x")), \
        "inline requests have no future to resolve"


# ---------------------------------------------------------------------------
# Seeded chaos sweep
# ---------------------------------------------------------------------------


def test_chaos_sweep_mixed_workload_recovers_to_steady_state():
    names = ["perm30", "perm31", "tri", "perm32"]
    ref = dict(zip(names, serial_reference(names)))
    fault_plan = FaultPlan([FaultRule(site="dispatch", rate=0.05, count=4)], seed=1234)
    session = JoinSession(p=8, device="cpu", fault_plan=fault_plan)
    try:
        waves, failed = 0, 0
        while not fault_plan.drained() and waves < 12:
            waves += 1
            futs = [(n, session.submit_async(port_query(n), lam=LAM)) for n in names]
            for n, f in futs:
                try:
                    r = f.result(timeout=180)   # bounded: a hang is a failure
                except BaseException as e:
                    failed += 1
                    assert isinstance(e, JoinServiceError), \
                        f"untyped failure {type(e).__name__}"
                    assert getattr(e, "query", None) is port_query(n) or \
                        describe_query(port_query(n)) in str(e), "failure must name its query"
                else:
                    assert r.rows.tobytes() == ref[n].rows.tobytes(), \
                        "survivor byte-identity under injected faults"
        assert fault_plan.drained(), "the seeded schedule must actually inject"
        assert fault_plan.injected["dispatch"] == 4
        assert session.stats.failed == failed
        assert failed <= fault_plan.total_injected
        assert session.stats.degraded_fallbacks <= fault_plan.injected["dispatch"]
        assert session.stats.deadline_exceeded == 0

        # recovery: one settling wave re-derives quarantined caches, then the
        # steady state is clean
        session.submit_coalesced([port_query(n) for n in names], lam=LAM)
        ret0 = session.stats.retries
        out = session.submit_coalesced([port_query(n) for n in names], lam=LAM)
        for r, n in zip(out, names):
            assert r.rows.tobytes() == ref[n].rows.tobytes()
            assert_matches_jax(r, n)
        assert session.stats.retries == ret0, "warm steady state: no retries"
    finally:
        session.close()


def test_latency_faults_are_invisible_to_results():
    q = port_query("perm33")
    serial = serial_reference(["perm33"])[0]
    session = JoinSession(p=8, device="cpu",
                          fault_plan=FaultPlan([FaultRule(site="latency", rate=0.5,
                                                          delay_s=0.005)], seed=5))
    r = session.submit(q, lam=LAM)
    assert r.rows.tobytes() == serial.rows.tobytes()
    assert session.stats.failed == 0
    assert session.fault_plan.injected["latency"] > 0


def test_error_escaping_a_drain_batch_resolves_typed_and_close_returns(monkeypatch):
    """A failure outside any one request's run (as a sticky card error would
    be) still resolves every request of the batch with a typed error naming
    its query, the drainer lives on, and close() returns."""
    session = JoinSession(p=8, device="cpu")
    real = session._execute_batch

    def broken(reqs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(session, "_execute_batch", broken)
    futs = [session.submit_async(port_query(n), lam=LAM) for n in ("perm40", "perm41")]
    outs = outcomes(futs, timeout=30)
    assert all(isinstance(o, QueryFailedError) for o in outs)
    assert [o.query for o in outs] == [port_query("perm40"), port_query("perm41")]
    assert "illegal memory access" in repr(outs[0].cause)
    assert not session.degraded
    monkeypatch.setattr(session, "_execute_batch", real)
    assert_matches_jax(session.submit_async(port_query("perm40"), lam=LAM).result(timeout=60),
                       "perm40")
    session.close()
    assert session._drainer is None or not session._drainer.is_alive()
