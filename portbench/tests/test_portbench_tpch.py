"""The ``tpch-sf1.q5-mix`` cell: its tables at the sizes the configuration
states, every (region, year) variant of Q5 through the session at SF 0.01
against the plain reference and the host-mask count, the plan the cyclic
query takes, the two ShareRoute readers, and small CPU runs of the cell
(plain, traced with the program's counters, and with the nation closure
dropped from the answers)."""

import json

import numpy as np
import pytest
import torch

from portbench import compare, program_spans
from portbench.reference import natural_join
from portbench.run import load_module, run_cell
from portbench_cells import ROOT, SECONDS

CONFIG = json.loads((ROOT / "portbench/configs/tpch-sf1.json").read_text())
TPCH = load_module(ROOT / "portbench" / "datasets" / "tpch.py")
CELL = "tpch-sf1.q5-mix"
#: SF 0.01, the traffic's warm-up size
SMALL = {"customers": 1500, "orders": 15000, "suppliers": 100}
VARIANTS = [(r, y) for r in range(TPCH.REGIONS) for y in TPCH.YEARS]
READERS = ("shareroute.replication", "shareroute.live_cell_pct")


def reader(name):
    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py").read


@pytest.fixture(scope="module")
def small():
    """SF 0.01's tables and one p = 64 session, as the cell runs them."""
    from repro_torch.mpc import JoinSession

    session = JoinSession(p=64, device="cpu")
    yield TPCH.make({**CONFIG, **SMALL}, np.random.default_rng(0)), session
    session.close()


def test_the_configuration_states_its_tables():
    """SF1 from draw stream 0: the sizes ``expect`` states and each
    variant's rows by host masks (the same tables for every seed)."""
    data = TPCH.make(CONFIG, np.random.default_rng(2**31 + 5))
    again = TPCH.make(CONFIG, np.random.default_rng(7))
    assert all(np.array_equal(data[k], again[k]) for k in ("customer", "orders", "lineitem"))
    expect = CONFIG["expect"]
    assert len(data["customer"]) == expect["customers"] == CONFIG["customers"]
    assert len(data["orders"]) == expect["orders"] == CONFIG["orders"]
    assert len(data["supplier"]) == expect["suppliers"] == CONFIG["suppliers"]
    assert len(data["nation"]) == expect["nations"]
    assert len(data["lineitem"]) == expect["lineitems"]
    assert len(np.unique(data["orders"][:, 1])) == expect["customers_with_orders"]
    assert {str(y): int((data["o_year"] == y).sum()) for y in TPCH.YEARS} == \
        expect["orders_by_year"]
    pairs = data["lineitem"][:, 0] * (CONFIG["suppliers"] + 1) + data["lineitem"][:, 2]
    assert len(pairs) - len(np.unique(pairs)) == expect["lineitems_sharing_order_and_supplier"]
    rows = TPCH.answer_rows(data)
    assert {str(r): {str(y): rows[r, y] for y in TPCH.YEARS} for r in range(5)} == \
        expect["rows"]


def test_the_spec_rules_the_generator_keeps(small):
    data, _ = small
    # o_custkey never a multiple of 3; 1-7 lineitems an order, numbered 1..k
    assert not np.any(data["orders"][:, 1] % 3 == 0)
    lines = np.bincount(data["lineitem"][:, 0])[1:]
    assert lines.min() == 1 and lines.max() == 7
    first = np.flatnonzero(np.diff(data["lineitem"][:, 0], prepend=0))
    assert np.all(data["lineitem"][first, 1] == 1)
    assert len(np.unique(data["lineitem"][:, :2], axis=0)) == len(data["lineitem"])
    assert data["customer"][:, 1].max() < 25 and data["supplier"][:, 1].max() < 25


def test_the_nation_region_table_gives_five_nations_a_region():
    assert np.array_equal(np.bincount(TPCH.NATION_REGION), [5] * 5)
    # the spec's table: AFRICA, AMERICA, ASIA, EUROPE, MIDDLE EAST
    assert [sorted(np.flatnonzero(TPCH.NATION_REGION == r).tolist()) for r in range(5)] == [
        [0, 5, 14, 15, 16], [1, 2, 3, 17, 24], [8, 9, 12, 18, 21], [6, 7, 19, 22, 23],
        [4, 10, 11, 13, 20]]


@pytest.mark.parametrize("year", TPCH.YEARS)
def test_the_date_predicate_keeps_the_orders_of_one_year(small, year):
    data, _ = small
    spec = TPCH.query("q5", data, {"region": 0, "year": year})
    orders = spec[1][1]
    days = np.datetime64(CONFIG["first_date"]) + np.arange(CONFIG["order_days"])
    assert str(days[-1]) == "1998-08-02"
    assert len(orders) == int((data["o_year"] == year).sum()) > 0
    assert set(data["o_year"][orders[:, 0] - 1].tolist()) == {year}
    # a year's orders are one array for every variant of that year
    assert TPCH.query("q5", data, {"region": 3, "year": year})[1][1] is orders


def test_variants_are_every_region_once_with_seeded_years():
    for s in range(2**31, 2**31 + 8):
        v = TPCH.draw_variants("q5", np.random.default_rng(s), 5)
        assert sorted(x["region"] for x in v) == list(range(5))
        assert all(x["year"] in TPCH.YEARS for x in v)
        assert v == TPCH.draw_variants("q5", np.random.default_rng(s), 5)
    with pytest.raises(ValueError):
        TPCH.draw_variants("q41", np.random.default_rng(0), 5)


@pytest.mark.parametrize("region, year", VARIANTS)
def test_every_variant_through_the_session(small, region, year):
    """``JoinSession(p=64).submit`` against the plain reference as
    multisets, and its count against the host masks."""
    from repro_torch.core.query import query_from_arrays

    data, session = small
    spec = TPCH.query("q5", data, {"region": region, "year": year})
    res = session.submit(query_from_arrays(spec))
    attrs, want = natural_join.join([(s, r) for s, r, _ in spec], "cpu")
    assert attrs == ["C", "L", "N", "O", "R", "S"]
    assert compare.rows_gap(torch.from_numpy(res.result.rows), want) == 0
    assert res.count == want.shape[0] == TPCH.answer_rows(data)[region, year] > 0


def test_the_plan_is_the_cyclic_general_one(small):
    """Six relations of arity 1-3 with a cycle C-O-S-N-C: the hypercube
    program, no semijoin sweep, LP shares over N, O and R."""
    from repro_torch.core.query import query_from_arrays

    data, session = small
    res = session.submit(query_from_arrays(TPCH.query("q5", data, {"region": 2, "year": 1995})))
    prog = session._plans[res.plan_key]
    assert prog.general.kind == "hypercube" and prog.general.tree_edges == ()
    assert [type(op).__name__ for op in prog.ops] == ["Scatter", "ShareRoute", "CellJoin"]
    assert prog.general.shares_dict == {"C": 1, "L": 1, "N": 4, "O": 4, "R": 4, "S": 1}
    assert prog.general.join_order == (0, 1, 2, 3, 4, 5)
    ops = {k.split("/")[1] for k in res.spans_us if k.startswith("execute/op.")}
    assert ops == {"op.Scatter", "op.ShareRoute", "op.CellJoin"}


def test_two_lineitems_of_one_order_with_one_supplier_both_survive(small):
    """l_linenumber keeps lineitem's primary key: an order's two lines from
    one supplier are two rows of the answer, not one (O, S) pair."""
    from repro_torch.core.query import query_from_arrays

    _, session = small
    nation = np.stack([np.arange(25), TPCH.NATION_REGION], axis=1)
    spec = [(("C", "N"), np.array([[1, 6], [2, 8]]), None),
            (("O", "C"), np.array([[10, 1], [11, 2]]), None),
            (("O", "L", "S"), np.array([[10, 1, 5], [10, 2, 5], [10, 3, 7], [11, 1, 7]]), None),
            (("S", "N"), np.array([[5, 6], [7, 8]]), None),
            (("N", "R"), nation, None), (("R",), np.array([[3]]), None)]
    res = session.submit(query_from_arrays(spec))
    _, want = natural_join.join([(s, r) for s, r, _ in spec], "cpu")
    # C L N O R S: nation 6 lies in EUROPE (3), nation 8 in ASIA
    rows = sorted(map(tuple, res.result.rows.tolist()))
    assert rows == [(1, 1, 6, 10, 3, 5), (1, 2, 6, 10, 3, 5)]
    assert compare.rows_gap(torch.from_numpy(res.result.rows), want) == 0


def submit(counters):
    return {"total_us": 0.0, "execute_us": 0.0, "rounds_us": 0.0, "spans_us": {},
            "counters": counters}


RECORD = {"cold": [], "warm": [
    submit({"execute/op.ShareRoute:input_rows": 100, "execute/op.ShareRoute:routed_rows": 1600,
            "execute/op.ShareRoute:grid_cells": 64, "execute/op.ShareRoute:live_cells": 16}),
    submit({"execute/op.ShareRoute:input_rows": 200, "execute/op.ShareRoute:routed_rows": 1600,
            "execute/op.ShareRoute:grid_cells": 64, "execute/op.ShareRoute:live_cells": 8,
            "execute/op.CellJoin:level_rows_max": 5}),
]}


@pytest.mark.parametrize("name, want", [
    ("shareroute.replication", 12.0),        # (1600/100 + 1600/200) over 2 queries
    ("shareroute.live_cell_pct", 18.75),     # (16/64 + 8/64) / 2, in %
])
def test_reader(name, want):
    assert reader(name)(RECORD) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_where_the_program_counts_nothing(name):
    assert reader(name)({"cold": [], "warm": [], "kernels": {}, "device": None}) is None
    # a program whose route keeps no such counter (the parent of the counters)
    assert reader(name)({"cold": [], "warm": [submit({"execute:h2d_bytes": 8})]}) is None


def test_a_small_cpu_run_is_correct_and_reads_the_route():
    line = run_cell(ROOT, CELL, 2**31 + 11, SECONDS, False, device="cpu", overrides=SMALL)
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"query_s", "setup_s"}
    warm = []
    orig = program_spans.summarize

    def keep(record, *args):
        warm.extend(record["warm"])
        return orig(record, *args)

    program_spans.summarize = keep
    try:
        out = program_spans.traced_run(ROOT, CELL, 2**31 + 13, 0.3, device="cpu",
                                       overrides=SMALL)
    finally:
        program_spans.summarize = orig
    assert out["line"]["correct"]
    record = {"cold": [], "warm": warm}
    # every relation but nation (x4) goes to 16 cells; only the region's
    # r-slice of 16 cells can hold a row of every relation
    assert 15.9 < reader("shareroute.replication")(record) < 16.0
    assert 0 < reader("shareroute.live_cell_pct")(record) <= 25.0
    assert all(not any("TreeSemiJoin" in k for k in s["spans_us"]) for s in warm)


class _OpenClosure:
    """The reference with supplier's nation renamed apart: the answer keeps
    Q5's columns but drops the C-S nation closure, as a chain that skipped
    it would."""

    def __init__(self, reference):
        self.reference = reference

    def join(self, relations, device, dtype=None):
        opened = [(("S", "N_s") if tuple(s) == ("S", "N") else s, r) for s, r in relations]
        attrs, rows = self.reference.join(opened, device, dtype=dtype)
        keep = [i for i, a in enumerate(attrs) if a != "N_s"]
        return [attrs[i] for i in keep], rows[:, keep]


def test_the_open_closure_is_not_correct():
    """The answers without the C-S nation closure, in the program's place:
    they hold the rows whose supplier sits in another nation, so both gaps
    read above 0."""
    from portbench.control import NarrowKeys

    with NarrowKeys(_OpenClosure(natural_join), torch.device("cpu"), torch.int64):
        line = run_cell(ROOT, CELL, 2**31 + 23, SECONDS, False, device="cpu", overrides=SMALL)
    assert line["correct"] is False and line["attempted"] >= 1
    assert line["checks"]["rows_gap"]["value"] > 0
    assert line["checks"]["count_gap"]["value"] > 0
