"""The port's general (arbitrary-arity) route through the scheduler and the
session ≡ the JAX package's, on the CPU.

Programs are compiled at p=8 in both packages; every check is exact:

* warm repeats retry nothing and return the same bytes, also against the JAX
  DataplaneExecutor on a one-device mesh;
* coalesced programs return each program's serial bytes, also when an
  injected overflow (the ``FaultPlan`` overflow site of ``_run_buckets``)
  re-salts one of them, and the re-salted rows move as the reference's do;
* the dispatch and first-build fault sites fire inside the general rounds;
* ``JoinSession`` serves general queries cold and warm (plan-cache hit,
  learned caps, ``verify=True``, coalesced and async submits, and
  ``backend="simulator"`` equal to the reference session's).

Row order at p=8 against the JAX executor on eight host devices is in
tests/test_torch_general_mesh8.py.
"""

import sys
from pathlib import Path

import pytest
import torch

from repro.mpc import program as jprog
from repro.mpc.executors import DataplaneExecutor as JDataplane
from repro.mpc.faults import FaultPlan as JFaultPlan
from repro.mpc.faults import FaultRule as JFaultRule
from repro.mpc.service import JoinSession as JaxSession
from repro_torch.core import query as tq
from repro_torch.mpc import DataplaneExecutor as TDataplane
from repro_torch.mpc import JoinSession, RunConfig
from repro_torch.mpc.faults import FaultPlan, FaultRule

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_general import family  # noqa: E402
from test_torch_general_dataplane import (  # noqa: E402
    P,
    assert_same_order,
    compile_both,
    mesh1,
    rows_key,
)

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# warm repeats, coalescing, injected retries
# ---------------------------------------------------------------------------


def test_warm_repeat_zero_retries_same_bytes():
    qt, qj = family("star3", n=80, dom_size=7, skew=0.6, seed=11)
    tp, jp = compile_both(qt, qj)
    ex = TDataplane(P, device="cpu", batch_stages=True)
    r1, r2 = ex.run(tp), ex.run(tp)
    assert r1.rows.tobytes() == r2.rows.tobytes()
    assert r2.retries == 0 and r2.caps_hits > 0 and r2.caps_misses == 0
    jex, tex = JDataplane(mesh=mesh1()), TDataplane(1, device="cpu")
    jex.run(jp), tex.run(tp)
    assert_same_order(tex.run(tp), jex.run(jp))


def test_coalesced_general_byte_identical_to_serial():
    qa, ja = family("star3", n=80, dom_size=7, skew=0.6, seed=11)
    qb, jb = family("star3", n=50, dom_size=5, skew=0.0, seed=23)
    (pa, jpa), (pb, jpb) = compile_both(qa, ja), compile_both(qb, jb)
    ex = TDataplane(P, device="cpu")
    sa, sb = ex.run(pa), ex.run(pb)
    (ca, cb), batch = TDataplane(P, device="cpu").run_many([pa, pb])
    assert ca.rows.tobytes() == sa.rows.tobytes()
    assert cb.rows.tobytes() == sb.rows.tobytes()
    assert batch.queries == 2
    (wa, wb), _ = JDataplane(mesh=mesh1()).run_many([jpa, jpb])
    (ga, gb), _ = TDataplane(1, device="cpu").run_many([pa, pb])
    assert_same_order(ga, wa)
    assert_same_order(gb, wb)


@pytest.mark.parametrize("round_name", ["yan-up", "yan-down", "hc-route", "output"])
def test_injected_overflow_retries_match_reference(round_name):
    """An injected slot overflow re-salts the tripped retry group: the rows
    move with the new salt exactly as the reference's do, and in a coalesced
    run the other query's rows stay at their serial bytes."""
    qa, ja = family("snowflake", n=80, dom_size=7, skew=0.6, seed=11)
    qb, jb = family("snowflake", n=50, dom_size=5, skew=0.0, seed=23)
    (pa, jpa), (pb, jpb) = compile_both(qa, ja), compile_both(qb, jb)

    def plan(F, R):
        return F([R(site="overflow", rate=1.0, count=1, rounds=(round_name,),
                    channels=("slot", "out"))], seed=3)

    jcfg = jprog.RunConfig(fault_plan=plan(JFaultPlan, JFaultRule))
    tcfg = RunConfig(fault_plan=plan(FaultPlan, FaultRule))
    want = JDataplane(mesh=mesh1()).run(jpa, config=jcfg)
    got = TDataplane(1, device="cpu").run(pa, config=tcfg)
    assert got.retries == 1 and got.retry_log[0][1] == round_name
    assert_same_order(got, want)

    tcfg = RunConfig(fault_plan=plan(FaultPlan, FaultRule))
    (ca, cb), _ = TDataplane(P, device="cpu").run_many([pa, pb], config=tcfg)
    sb = TDataplane(P, device="cpu").run(pb)
    assert ca.retries + cb.retries == 1
    clean = cb if ca.retries else ca
    assert clean.rows.tobytes() == (sb if ca.retries else TDataplane(
        P, device="cpu").run(pa)).rows.tobytes()
    assert rows_key(ca.rows) == rows_key(tq.reference_join(qa).data)


@pytest.mark.parametrize("site,error", [("dispatch", "InjectedDispatchError"),
                                        ("compile", "InjectedCompileError")])
@pytest.mark.parametrize("round_name", ["yan-down", "hc-route", "output"])
def test_injected_dispatch_and_compile_faults_fire_on_general_rounds(site, error, round_name):
    """The dispatch and first-build fault sites fire inside the general
    rounds; the failed run drops the learned caps it touched, and a clean
    rerun returns the clean bytes.  The dispatch site is held against the
    reference too; its compile site fires on a miss of JAX's process-wide
    executable cache, which earlier tests in the process may have filled,
    so the first-build site is checked on the port alone."""
    from repro.mpc import faults as jfaults
    from repro_torch.mpc import faults as tfaults

    qt, qj = family("path4", n=80, dom_size=7, skew=0.6, seed=11)
    tp, jp = compile_both(qt, qj)
    clean = TDataplane(1, device="cpu").run(tp)
    runs = [(FaultPlan, FaultRule, tfaults, TDataplane(1, device="cpu"), tp, RunConfig)]
    if site == "dispatch":
        runs.append((JFaultPlan, JFaultRule, jfaults, JDataplane(mesh=mesh1()), jp,
                     jprog.RunConfig))
    for F, R, faults, ex, prog, cfg in runs:
        plan = F([R(site=site, rate=1.0, count=1, rounds=(round_name,))], seed=5)
        with pytest.raises(getattr(faults, error)):
            ex.run(prog, config=cfg(fault_plan=plan))
        assert plan.injected[site] == 1
    got = TDataplane(1, device="cpu").run(tp)
    assert got.rows.tobytes() == clean.rows.tobytes()
    assert_same_order(got, JDataplane(mesh=mesh1()).run(jp))


# ---------------------------------------------------------------------------
# the session: cold/warm, verify, the simulator backend
# ---------------------------------------------------------------------------


def test_session_serves_general_queries_cold_and_warm():
    qt, _ = family("star3", n=240, dom_size=20, skew=0.8, seed=11)
    oracle = tq.reference_join(qt)
    session = JoinSession(p=P, device="cpu", verify=True)
    cold = session.submit(qt, lam=8)
    warm = session.submit(qt, lam=8)
    assert not cold.plan_cache_hit and warm.plan_cache_hit
    assert cold.verify_us > 0 and warm.verify_us > 0
    assert warm.compile_us == 0.0
    assert warm.retries == 0 and warm.caps_hits > 0 and warm.caps_misses == 0
    assert warm.rows.tobytes() == cold.rows.tobytes()
    assert cold.count == len(oracle) and cold.result.per_h_counts == {("*",): len(oracle)}
    assert rows_key(cold.rows) == rows_key(oracle.data)
    # a warm submit on fresh data of the same structure rebinds the plan
    q2, _ = family("star3", n=240, dom_size=20, skew=0.8, seed=12)
    other = session.submit(q2, lam=8)
    assert rows_key(other.rows) == rows_key(tq.reference_join(q2).data)
    # coalesced and async submits answer like single ones
    got = session.submit_coalesced([qt, q2], lam=8)
    assert [g.rows.tobytes() for g in got] == [cold.rows.tobytes(), other.rows.tobytes()]
    assert session.submit_async(qt, lam=8).result(timeout=120).rows.tobytes() == \
        cold.rows.tobytes()
    session.close()


@pytest.mark.parametrize("kind", ["star3", "snowflake", "path4", "triangle"])
def test_session_simulator_backend_equals_reference(kind):
    qt, qj = family(kind, n=120, dom_size=12, skew=0.8, seed=21)
    got = JoinSession(p=P, backend="simulator").submit(qt, lam=8)
    want = JaxSession(p=P, backend="simulator").submit(qj, lam=8)
    assert got.rows.tobytes() == want.rows.tobytes()
    assert got.count == want.count == len(tq.reference_join(qt))
    assert got.result.sim.merged_round_loads() == want.result.sim.merged_round_loads()
    card = JoinSession(p=P, device="cpu").submit(qt, lam=8)
    assert rows_key(card.rows) == rows_key(got.rows)


def test_general_query_on_the_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        JoinSession(p=P)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDataplane(P)
