"""The ``graph500-s15.clique4`` cell: its dataset at the sizes the
configuration states, its 4-clique query against ``chip_smoke.py``'s
oracle, the two LocalJoin readers on synthetic records, and a small CPU run
of the cell (plain, traced with the program's counters, with the answers
altered, and with the reference's unfiltered control in the program's
place)."""

import json

import numpy as np
import pytest
import torch

from chip_smoke import clique4_oracle
from portbench import program_spans
from portbench.reference import natural_join
from portbench.run import load_module, run_cell
from portbench_cells import ROOT, SECONDS, SMALL as SMALL_CELLS
from test_portbench_datasets import graph_sizes

CONFIG = json.loads((ROOT / "portbench/configs/graph500-s15.json").read_text())
CLIQUES = load_module(ROOT / "portbench" / "datasets" / "graph500_cliques.py")
CELL = "graph500-s15.clique4"
SMALL = {"scale": 9, "machines": 8}
READERS = ("localjoin.level_rows_max", "localjoin.pulled_rows")


def reader(name):
    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py").read


def test_the_configuration_states_its_graph():
    """Scale 15 from draw stream 0, oriented by (degree, id): the sizes
    ``expect`` states (its 102,566,898 4-cliques take ``clique4_oracle``
    ~45 s of host numpy, so they are counted at scale 10 below)."""
    data = CLIQUES.make(CONFIG, np.random.default_rng(2**31 + 5))
    expect = CONFIG["expect"]
    assert data["vertices"] == expect["vertices"] == 1 << CONFIG["scale"]
    assert graph_sizes(data["edges"], data["vertices"]) == (
        expect["vertices"], expect["edges"], expect["max_degree"], expect["two_paths"],
        expect["triangles"])
    traffic = json.loads((ROOT / "portbench/traffic/clique4.json").read_text())
    assert traffic["query"] == "clique4" and traffic["variants"] == 2


@pytest.mark.parametrize("variant", [0, 1])
def test_clique4_query_lists_each_4_clique_once(variant):
    """At scale 10 the plain reference join of the query, under either
    labelling, has as many rows as the oracle counts 4-cliques, each once
    and each in rank order."""
    cfg = {**CONFIG, "scale": 10}
    data = CLIQUES.make(cfg, np.random.default_rng(7))
    params = sorted(CLIQUES.draw_variants("clique4", np.random.default_rng(3), 2),
                    key=lambda v: v["labels"])[variant]
    spec = CLIQUES.query("clique4", data, params)
    assert [s for s, _, _ in spec] == [("A", "B"), ("B", "C"), ("A", "C"), ("C", "D"),
                                       ("A", "D"), ("B", "D")]
    assert all(rows is spec[0][1] and table == "E" for _, rows, table in spec)
    attrs, rows = natural_join.join([(s, r) for s, r, _ in spec], "cpu")
    want = clique4_oracle(np.unique(data["edges"], axis=0), data["vertices"])
    assert attrs == ["A", "B", "C", "D"] and rows.shape[0] == want > 1000
    assert torch.unique(rows, dim=0).shape[0] == want
    # each row's six pairs are edges of the labelled, oriented table
    codes = set((spec[0][1][:, 0] * (1 << 20) + spec[0][1][:, 1]).tolist())
    r = rows.numpy()
    for i, j in ((0, 1), (1, 2), (0, 2), (2, 3), (0, 3), (1, 3)):
        assert set((r[:, i] * (1 << 20) + r[:, j]).tolist()) <= codes


def test_variants_are_a_fixed_set_in_a_seeded_order():
    sets = [CLIQUES.draw_variants("clique4", np.random.default_rng(s), 2)
            for s in range(2**31, 2**31 + 8)]
    assert all(sorted(v, key=str) == sorted(sets[0], key=str) for v in sets)
    assert len({tuple(map(str, v)) for v in sets}) == 2
    with pytest.raises(ValueError):
        CLIQUES.draw_variants("triangle", np.random.default_rng(0), 2)


def submit(counters):
    return {"total_us": 0.0, "execute_us": 0.0, "rounds_us": 0.0, "spans_us": {},
            "counters": counters}


RECORD = {"cold": [], "warm": [
    submit({"execute/op.LocalJoin:level_rows_max": 300,
            "execute/op.LocalJoin/assemble:pulled_rows": 100,
            "execute/op.LocalJoin/assemble:d2h_bytes": 1600}),
    submit({"execute/op.LocalJoin:level_rows_max": 500,
            "execute/op.LocalJoin/assemble:pulled_rows": 140}),
]}


@pytest.mark.parametrize("name, want", [
    ("localjoin.level_rows_max", 400.0),     # (300 + 500) over 2 queries
    ("localjoin.pulled_rows", 120.0),        # (100 + 140) over 2 queries
])
def test_reader(name, want):
    assert reader(name)(RECORD) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_where_the_program_counts_nothing(name):
    assert reader(name)({"cold": [], "warm": [], "kernels": {}, "device": None}) is None
    # a program whose chain keeps no such counter (the parent of the counters)
    assert reader(name)({"cold": [], "warm": [submit({"execute:h2d_bytes": 8})]}) is None


def test_a_small_cpu_run_is_correct_and_reads_every_metric():
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
    assert all(v is not None for v in out["metrics"].values())
    record = {"cold": [], "warm": warm}
    pulled = reader("localjoin.pulled_rows")(record)
    assert pulled is not None and pulled > 0
    assert reader("localjoin.level_rows_max")(record) >= pulled


def test_an_altered_answer_is_caught(monkeypatch):
    from repro_torch.mpc.executors import DataplaneExecutor

    orig = DataplaneExecutor.run_many

    def run_many(self, programs, *args, **kwargs):
        results, stats = orig(self, programs, *args, **kwargs)
        for r in results:
            r.rows = r.rows.copy()
            r.rows[len(r.rows) // 2, 3] += 1
        return results, stats

    monkeypatch.setattr(DataplaneExecutor, "run_many", run_many)
    line = run_cell(ROOT, CELL, 2**31 + 19, SECONDS, False, device="cpu", overrides=SMALL)
    assert line["correct"] is False and line["checks"]["rows_gap"]["value"] > 0


def test_the_unfiltered_control_drops_the_last_closing_filter():
    from portbench.control_unfiltered import unfiltered

    clique = [(s, None) for s in CLIQUES.CLIQUE4]
    assert [s for s, _ in unfiltered(clique)] == list(CLIQUES.CLIQUE4[:-1])
    triangle = [(("A", "B"), None), (("B", "C"), None), (("A", "C"), None)]
    assert [s for s, _ in unfiltered(triangle)] == [("A", "B"), ("B", "C")]
    with pytest.raises(ValueError):
        unfiltered([(("o", "c"), None), (("c", "n"), None)])


@pytest.mark.parametrize("cell", [CELL, "graph500-s17.triangle"])
def test_the_unfiltered_control_is_not_correct(cell):
    """The reference without its closing filter, in the program's place: the
    answers hold rows the query rules out, so both gaps read above 0."""
    from portbench.control_unfiltered import control_run

    overrides = SMALL if cell == CELL else SMALL_CELLS[cell]
    line = control_run(ROOT, cell, 2**31 + 23, SECONDS, device="cpu", overrides=overrides)
    assert line["correct"] is False and line["attempted"] >= 1
    assert line["checks"]["rows_gap"]["value"] > 0
    assert line["checks"]["count_gap"]["value"] > 0
