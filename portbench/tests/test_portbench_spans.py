"""The readers of the program's own spans and copy counters
(``program_spans.py``, ``metrics/executor.{fingerprint,residual,staging,
assemble}_ms``, ``metrics/dataplane.*``) on synthetic records, the exact
idle split, the added event collection, and a small CPU run of each cell."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import program_spans, trace
from portbench.run import load_module, submit_record
from portbench_cells import ROOT, SMALL

READERS = program_spans.READERS


def reader(name):
    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py").read


def submit(spans_us, counters):
    return {"total_us": 0.0, "execute_us": 0.0, "rounds_us": 0.0, "spans_us": spans_us,
            "counters": counters}


MIB = 2**20
RECORD = {"cold": [], "warm": [
    submit({"execute": 9000.0, "execute/fingerprint": 1000.0,
            "execute/op.RouteResidual": 4000.0, "execute/op.RouteResidual/carve": 3000.0,
            "execute/op.RouteResidual/stage": 500.0, "execute/op.LocalJoin/stage": 700.0,
            "execute/op.LocalJoin/round.output/readback": 300.0,
            "execute/op.LocalJoin/assemble": 200.0, "execute/assemble": 100.0},
           {"execute/op.LocalJoin/round.output/launch:h2d_bytes": 3 * MIB,
            "execute/op.LocalJoin/round.output/readback:d2h_bytes": 4 * MIB,
            "execute/op.LocalJoin/round.output/readback:d2h_row_bytes": MIB}),
    submit({"execute": 5000.0, "execute/fingerprint": 3000.0,
            "execute/op.TreeSemiJoin/stage": 800.0,
            "execute/op.TreeSemiJoin/round.yan-up/readback": 500.0,
            "execute/op.TreeSemiJoin/round.yan-up.count/readback": 200.0},
           {"execute/op.TreeSemiJoin/round.yan-up/launch:h2d_bytes": MIB,
            "execute/op.TreeSemiJoin/round.yan-up/readback:d2h_bytes": 3 * MIB,
            "execute/op.TreeSemiJoin/round.yan-up/readback:d2h_row_bytes": 2 * MIB,
            "execute/op.TreeSemiJoin/stage:d2h_bytes": MIB}),
]}


@pytest.mark.parametrize("name, want", [
    ("executor.fingerprint_ms", 2.0),        # (1000 + 3000) µs over 2 queries
    ("executor.residual_ms", 1.5),           # one carve of 3000 µs, per query
    ("executor.staging_ms", 1.0),            # 500 + 700 + 800
    ("executor.assemble_ms", 0.15),          # 200 + 100
    ("dataplane.readback_ms", 0.5),          # 300 + 500 + 200
    ("dataplane.h2d_mib", 2.0),              # (3 + 1) MiB
    ("dataplane.d2h_mib", 4.0),              # (4 + 3 + 1) MiB
    ("dataplane.d2h_useful_pct", 37.5),      # 3 of 8 MiB
])
def test_reader(name, want):
    assert reader(name)(RECORD) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_an_empty_record(name):
    empty = {"cold": [], "warm": [], "kernels": {}, "device": None}
    assert reader(name)(empty) is None
    # a program that keeps no spans (the parent of the spans) reads as nothing
    bare = {"cold": [], "warm": [submit({}, {})], "kernels": {}, "device": None}
    assert reader(name)(bare) is None


def test_submit_record_adds_the_program_records_where_there_are_some():
    res = SimpleNamespace(total_us=1.0, stats_us=0.0, compile_us=0.0, verify_us=0.0,
                          execute_us=1.0, result=SimpleNamespace(round_us={"a": 0.5}),
                          retries=0)
    assert program_spans.submit_record(res, submit_record) == {
        **submit_record(res), "spans_us": {}, "counters": {}}
    res.spans_us, res.counters = {"stats": 2.0}, {"execute:h2d_bytes": 8}
    rec = program_spans.submit_record(res, submit_record)
    assert rec["spans_us"] == {"stats": 2.0} and rec["counters"] == {"execute:h2d_bytes": 8}


# the events of test_portbench_metrics.test_reduce_events
DEVICE = [("mj_counts(int const*)", 10, 30), ("hp_pack(int const*)", 20, 40),
          ("Memcpy HtoD", 60, 70), ("mj_pairs(int const*)", 95, 120)]
SPANS = [("submit", 0, 100), ("execute", 6, 90), ("op.LocalJoin", 41, 55)]


def test_split_idle_gives_each_piece_of_a_gap_to_its_innermost_span():
    # idle [0,10) [40,60) [70,95): submit [0,6) [90,95); op.LocalJoin [41,55);
    # execute the rest, where the midpoint rule gives 10, 25 and 20
    assert dict(program_spans.split_idle(DEVICE, SPANS, (0, 100))) == {
        "submit": 11, "execute": 30, "op.LocalJoin": 14}
    assert dict(trace.reduce_events(DEVICE, SPANS, (0, 100))["idle_by_span"]) == {
        "submit": 10, "op.LocalJoin": 20, "execute": 25}
    assert dict(program_spans.split_idle([], [], (0, 50))) == {"window": 50}


def event(name, start, end, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def profiled(extra=()):
    events = [event("portbench.window", 0, 100)]
    events += [event("portbench." + n, s, e) for n, s, e in SPANS]
    events += [event(n, s, e, DeviceType.CUDA) for n, s, e in DEVICE]
    events += [event("aten::mul", 12, 13)]
    return SimpleNamespace(events=lambda: events + list(extra))


def test_profile_events_without_program_spans_reduce_as_today():
    base = trace.profile_events(profiled())
    got = program_spans.profile_events(profiled(), trace.profile_events)
    assert got == base
    assert trace.reduce_events(*got) == trace.reduce_events(*base)


def test_profile_events_add_the_program_spans_by_path():
    extra = [event("repro_torch.request:4", 5, 92),
             event("repro_torch.execute", 6, 91),
             event("repro_torch.execute/op.LocalJoin/stage", 42, 50),
             event("repro_torch.execute/op.LocalJoin/stage", 42, 50, DeviceType.CUDA, True)]
    device, spans, window = program_spans.profile_events(profiled(extra), trace.profile_events)
    assert device == DEVICE and window == (0, 100)
    assert spans == SPANS + [("execute", 6, 91), ("execute/op.LocalJoin/stage", 42, 50)]
    # the program's execute ends at 91: [90, 91) moves from submit to it
    assert dict(program_spans.split_idle(device, spans, window)) == {
        "submit": 10, "execute": 31, "op.LocalJoin": 6, "execute/op.LocalJoin/stage": 8}


def test_self_time_and_coarse_spans():
    assert program_spans.self_us({"execute": 10.0, "execute/op.X": 6.0,
                                  "execute/op.X/stage": 2.0, "execute/op.X/round.a": 3.0,
                                  "execute/op.X/round.a/launch": 1.0}) == {
        "execute": 4.0, "execute/op.X": 1.0, "execute/op.X/stage": 2.0,
        "execute/op.X/round.a": 2.0, "execute/op.X/round.a/launch": 1.0}
    assert [program_spans.coarse(n) for n in (
        "window", "submit", "execute", "op.CellJoin", "execute/op.CellJoin",
        "execute/op.CellJoin/stage", "stats", "execute/op.CellJoin/round.output")] == [
        True, True, True, True, True, False, False, False]


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_small_cpu_run_reads_every_metric_and_repeats_its_copies(cell):
    out = program_spans.traced_run(ROOT, cell, 2**31 + 13, 0.3, device="cpu",
                                   overrides=SMALL[cell])
    assert out["line"]["correct"]
    found = {k for k, v in out["metrics"].items() if v is not None}
    want = set(READERS) - ({"executor.residual_ms"} if cell.startswith("ssb") else set())
    assert found == want
    assert 0 < out["metrics"]["dataplane.d2h_useful_pct"] < 100
    assert out["copies_repeat"] and out["copies_by_query"]
    assert 0 < out["named_share_of_host"] <= 1
