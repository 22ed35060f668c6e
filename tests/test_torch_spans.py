"""The port's host spans and copy counters (``repro_torch.spans``) on the CPU.

* span paths nest per thread and their totals are inclusive; a counter lands
  under the innermost open span; nothing records outside an active trace;
* ``record_function`` runs only while a profiler records, and then each
  ``repro_torch.<path>`` event sits inside its request's
  ``repro_torch.request:<ids>`` event;
* a triangle query (the binary route) and an SSB-shaped star join (the
  general route) show every span their route takes, with the service's and
  the executor's timings read from the spans, and the statistics memo's
  counters;
* the copy counters equal a hand count at the boundary and repeat exactly on
  a warm resubmit;
* the removed ``phase_us`` and ``jit_cache_*`` fields are gone.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core.query import query_from_arrays
from repro_torch.dataplane.exchange import to_host, unblockify
from repro_torch.dataplane.join import to_dev
from repro_torch.mpc import JoinSession
from repro_torch.mpc.executors import BatchRunStats, DataplaneExecutor, DataplaneJoinResult

torch.set_num_threads(1)


def triangle_query(seed=1, n=400, v=60):
    """A shared-table triangle over a random oriented graph."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, v, size=(n, 2))
    e = np.unique(e[e[:, 0] < e[:, 1]], axis=0)
    return query_from_arrays([(("A", "B"), e, "E"), (("B", "C"), e, "E"), (("A", "C"), e, "E")])


def star_query(seed=2, n=500):
    """SSB's shape: a 4-ary fact table joined to three keyed dimensions."""
    rng = np.random.default_rng(seed)
    fact = np.stack([rng.integers(0, 30, n), rng.integers(0, 20, n),
                     rng.integers(0, 40, n), rng.integers(0, 10, n)], axis=1)
    dim = lambda k, m: np.stack([np.arange(k), np.arange(k) % m], axis=1)  # noqa: E731
    return query_from_arrays([(("c", "s", "p", "d"), fact, "F"), (("c", "cn"), dim(30, 5), "C"),
                              (("s", "sn"), dim(20, 4), "S"), (("p", "pb"), dim(40, 7), "P")])


ROUTES = {
    # query, submit kwargs, the ops' spans below execute/op.<Op>/
    "triangle": (triangle_query, {"lam": 16}, {
        "RouteResidual": ["carve", "stage"],
        "BroadcastSizes": ["stage"],
        "GridRoute": ["stage", "round.step3-route"],
        "LocalJoin": ["stage", "round.output", "assemble"],
    }),
    "star": (star_query, {}, {
        "TreeSemiJoin": ["stage", "round.yan-up", "round.yan-down"],
        "ShareRoute": ["stage", "round.hc-route"],
        "CellJoin": ["stage", "round.output", "assemble"],
    }),
}


def cold_warm(route):
    make, kw, ops = ROUTES[route]
    q = make()
    session = JoinSession(p=8, device="cpu", verify=True)
    cold, warm, again = (session.submit(q, **kw) for _ in range(3))
    return cold, warm, again, ops


# ---------------------------------------------------------------------------
# the span mechanism
# ---------------------------------------------------------------------------


def test_span_paths_nest_and_totals_are_inclusive():
    trace = spans.Trace(0)
    with spans.activate(trace):
        with spans.span("a") as a:
            with spans.span("b") as b1:
                time.sleep(0.002)
            with spans.span("b") as b2:
                with spans.span("c") as c:
                    assert c.path == "a/b/c"
            time.sleep(0.001)
    assert set(trace.spans_us) == {"a", "a/b", "a/b/c"}
    assert trace.spans_us["a"] == a.us
    assert trace.spans_us["a/b"] == b1.us + b2.us
    assert trace.spans_us["a/b/c"] == c.us
    assert a.us > b1.us + b2.us >= 2000 and b2.us >= c.us > 0


def test_counter_lands_under_the_innermost_span():
    trace = spans.Trace(0)
    with spans.activate(trace):
        spans.count("h2d_bytes", 3)
        with spans.span("a"):
            spans.count("h2d_bytes", 5)
            with spans.span("b"):
                spans.count("h2d_bytes", 7)
                spans.count("h2d_bytes", 1)
            spans.count("d2h_bytes", 2)
    assert trace.counters == {"h2d_bytes": 3, "a:h2d_bytes": 5, "a/b:h2d_bytes": 8,
                              "a:d2h_bytes": 2}


def test_outside_a_trace_spans_time_themselves_and_record_nothing():
    outer, inner = spans.Trace(0), spans.Trace(1)
    with spans.span("free") as s:
        spans.count("h2d_bytes", 9)
    assert s.us > 0
    with spans.activate(outer):
        with spans.span("x"):
            with spans.activate(inner):      # paths root afresh, then come back
                with spans.span("y"):
                    spans.count("n", 1)
            spans.count("n", 2)
    assert set(outer.spans_us) == {"x"} and outer.counters == {"x:n": 2}
    assert set(inner.spans_us) == {"y"} and inner.counters == {"y:n": 1}


def test_traces_are_per_thread():
    traces = [spans.Trace(i) for i in range(4)]

    def work(t):
        with spans.activate(t):
            for _ in range(200):
                with spans.span("w"):
                    spans.count("k", 1)

    threads = [threading.Thread(target=work, args=(t,)) for t in traces]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert all(t.counters == {"w:k": 200} and set(t.spans_us) == {"w"} for t in traces)


def test_no_record_function_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    with spans.activate(spans.Trace(0)), spans.span("a"), spans.span("b"):
        pass
    assert opened == []


def test_profiler_events_sit_inside_their_request():
    q = triangle_query()
    session = JoinSession(p=8, device="cpu")
    session.submit(q, lam=16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        session.submit(q, lam=16)
        session.submit_coalesced([q, triangle_query(seed=3)], lam=16)
    events = [(e.name[len(spans.PREFIX):], e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith(spans.PREFIX)]
    requests = [(n.split(":", 1)[1], s, t) for n, s, t in events if n.startswith("request:")]
    paths = [(n, s, t) for n, s, t in events if not n.startswith("request:")]
    # one request event around each prepare, one around each execution;
    # the coalesced pair's execution names both members
    assert sorted({ids for ids, _, _ in requests}) == ["1", "2", "2,3", "3"]
    assert {n for n, _, _ in paths} >= {"stats", "plan", "execute", "execute/fingerprint",
                                        "execute/op.RouteResidual/carve"}
    for n, s, t in paths:
        holders = [ids for ids, rs, rt in requests if rs <= s and t <= rt]
        assert holders, n
        if n.startswith("execute"):
            assert any(ids in ("1", "2,3") for ids in holders)


# ---------------------------------------------------------------------------
# the service and the executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routes_show_every_span_and_the_timings_read_them(route):
    cold, warm, _, ops = cold_warm(route)
    want = {"stats", "stats/digest", "plan", "plan/verify", "execute", "execute/fingerprint",
            "execute/assemble"}
    for op, below in ops.items():
        want.add(f"execute/op.{op}")
        for name in below:
            want.add(f"execute/op.{op}/{name}")
            if name.startswith("round."):
                want |= {f"execute/op.{op}/{name}/{x}" for x in ("dispatch", "launch", "readback")}
    assert want <= set(warm.spans_us), sorted(want - set(warm.spans_us))
    assert "plan/compile" in cold.spans_us and "plan/compile" not in warm.spans_us
    assert want <= set(cold.spans_us)
    for res in (cold, warm):
        sp = res.spans_us
        assert res.stats_us == sp["stats"] and res.execute_us == sp["execute"]
        assert res.verify_us == sp["plan/verify"]
        assert res.compile_us == sp.get("plan/compile", 0.0)
        # every op and every round lies inside execute
        assert sum(v for k, v in sp.items() if k.count("/") == 1
                   and k.startswith("execute/")) <= sp["execute"]
    # the statistics memo misses on the cold submit and serves the warm one
    assert (cold.counters["stats:memo_hits"], cold.counters["stats:memo_misses"]) == (0, 1)
    assert (warm.counters["stats:memo_hits"], warm.counters["stats:memo_misses"]) == (1, 0)
    counted = {k.rsplit("/", 1)[-1] for k in warm.counters}
    # both routes' output chains (LocalJoin, CellJoin) keep their rows on the
    # device and pull the answer's rows once, in their assembly
    assert counted >= {"launch:h2d_bytes", "readback:d2h_bytes", "assemble:d2h_row_bytes"}
    assert "readback:d2h_row_bytes" not in counted


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_round_us_is_the_round_spans_totals(route):
    cold, warm, _, _ = cold_warm(route)
    for res in (cold, warm):
        rounds = res.result.round_us
        assert rounds
        for name, us in rounds.items():
            leaf = "round." + name.replace("/", ".")
            got = [v for k, v in res.spans_us.items() if k.rsplit("/", 1)[-1] == leaf]
            assert len(got) == 1 and got[0] == pytest.approx(us, rel=1e-12), name
    assert any(k.endswith("/count") for k in cold.result.round_us)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_copy_counters_repeat_exactly_on_a_warm_resubmit(route):
    cold, warm, again, _ = cold_warm(route)
    assert warm.counters == again.counters
    for res in (cold, warm):
        total = lambda c: sum(v for k, v in res.counters.items() if k.endswith(":" + c))  # noqa
        assert total("h2d_bytes") > 0 and 0 < total("d2h_row_bytes") < total("d2h_bytes")


def test_copy_counters_equal_a_hand_count():
    trace = spans.Trace(0)
    host = np.arange(24, dtype=np.int32).reshape(2, 3, 4)
    rows = torch.arange(2 * 8 * 3, dtype=torch.int32).reshape(1, 2, 8, 3)
    counts = torch.tensor([[5, 2]], dtype=torch.int32)
    with spans.activate(trace):
        with spans.span("send"):
            to_dev(host, torch.device("cpu"))
            to_dev(host[:, :, 1], torch.device("cpu"))     # a strided view: its own bytes
            to_dev(torch.zeros(9), torch.device("cpu"))    # already a tensor: no copy counted
        with spans.span("pull"):
            finalize, _ = DataplaneExecutor._rows_counts_post((rows, counts, counts), 1)
            (got, got_counts), = finalize()
            to_host(np.zeros(4))                            # already host memory
        with spans.span("flat"):
            unblockify(rows[0], counts[0])
    assert trace.counters == {
        "send:h2d_bytes": 24 * 4 + 6 * 4,
        "pull:d2h_bytes": 2 * 8 * 3 * 4 + 2 * 4,
        "pull:d2h_row_bytes": (5 + 2) * 3 * 4,
        "flat:d2h_bytes": 2 * 8 * 3 * 4 + 2 * 4,
    }
    assert got.shape == (2, 8, 3) and got_counts.tolist() == [5, 2]


def test_phase_us_and_jit_cache_fields_are_gone():
    for cls in (DataplaneJoinResult, BatchRunStats):
        names = {f.name for f in dataclasses.fields(cls)}
        assert not names & {"phase_us", "jit_cache_hits", "jit_cache_misses"}
        assert "round_us" in names
