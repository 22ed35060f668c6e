"""The cells' input generators: seeded, and at the sizes the configurations state."""

import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

from portbench.datasets import graph500, ssb

ROOT = Path(__file__).resolve().parents[2]
GRAPH = json.loads((ROOT / "portbench/configs/graph500-s17.json").read_text())
SSB = json.loads((ROOT / "portbench/configs/ssb-sf1.json").read_text())
SMALL_SSB = {**SSB, "fact_rows": 5000, "customers": 300, "suppliers": 50, "parts": 2000}


def graph_sizes(edges, n):
    """(vertices, edges, max degree, oriented 2-paths, triangles) by scipy."""
    deg = np.bincount(edges.reshape(-1), minlength=n)
    lmat = sp.csr_matrix((np.ones(len(edges), np.int64), (edges[:, 0], edges[:, 1])),
                         shape=(n, n))
    paths = lmat @ lmat
    return n, len(edges), int(deg.max()), int(paths.sum()), int(paths.multiply(lmat).sum())


@pytest.mark.parametrize("scale, want", [
    (15, (32768, 441430, 5985, 35750163, 6705189)),
    (16, (65536, 909286, 9809, 95171998, 15673932)),
    (17, (131072, 1864108, 15902, 251790655, 36260426)),
])
def test_graph500_sizes_at_draw_seed_0(scale, want):
    """The Graph500 draws of stream 0, oriented by (degree, id): the figures
    the configuration states (scale 17), which every run's relabelling keeps,
    and those of the scales below it."""
    n = 1 << scale
    drawn = graph500.kronecker_edges(np.random.default_rng(0), scale, 16, GRAPH["initiator"])
    assert drawn.shape == (16 << scale, 2)
    assert graph_sizes(graph500.orient_by_degree(graph500.normalize(drawn), n), n) == want
    expect = GRAPH["expect"]
    if scale == GRAPH["scale"]:
        assert want == (expect["vertices"], expect["edges"], expect["max_degree"],
                        expect["two_paths"], expect["triangles"])
        made = graph500.make(GRAPH, np.random.default_rng(2**31 + 5))["edges"]
        assert np.array_equal(made, graph500.orient_by_degree(graph500.normalize(drawn), n))


def test_graph500_variants_relabel_the_graph():
    """Each query of the mix joins the same graph under labels of its own:
    other edges, so the hash routing sees other keys, and the same sizes.  Every
    seed gets the same set of labellings, in an order of its own."""
    cfg = {**GRAPH, "scale": 10}
    n = 1 << 10
    data = graph500.make(cfg, np.random.default_rng(7))
    assert np.array_equal(data["edges"], graph500.make(cfg, np.random.default_rng(8))["edges"])
    variants = graph500.draw_variants("triangle", np.random.default_rng(7), 3)
    assert variants == graph500.draw_variants("triangle", np.random.default_rng(7), 3)
    orders = [graph500.draw_variants("triangle", np.random.default_rng(s), 3)
              for s in range(2**31, 2**31 + 8)]
    assert all(sorted(o, key=str) == sorted(variants, key=str) for o in orders)
    assert len({tuple(map(str, o)) for o in orders}) > 1
    tables = [graph500.query("triangle", data, v)[0][1] for v in variants]
    assert np.array_equal(tables[0], graph500.query("triangle", data, variants[0])[0][1])
    assert not np.array_equal(np.unique(tables[0], axis=0), np.unique(tables[1], axis=0))
    assert all(graph_sizes(t, n) == graph_sizes(data["edges"], n) for t in tables)
    a = tables[0]
    # an orientation: no edge both ways, no repeated edge, no self-loop
    keys = set(map(tuple, a.tolist()))
    assert len(keys) == len(a) and all((v, u) not in keys and u != v for u, v in keys)


def test_ssb_tables_are_seeded():
    a, b, c = (ssb.make(SMALL_SSB, np.random.default_rng(s)) for s in (3, 3, 4))
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["fact"], c["fact"])
    assert a["fact"].shape == (5000, 4)
    assert a["fact"][:, 0].min() >= 1 and a["fact"][:, 0].max() <= 300
    assert a["p_brand"].max() < SSB["brands"] and a["c_nation"].max() < SSB["nations"]
    # order dates are days of the date table, none in its last 151 days
    days = a["date"][:, 0]
    assert set(a["fact"][:, 3]) <= set(days[: SSB["dates"] - SSB["orderdate_cutoff_days"]])


def test_ssb_date_dimension():
    """2,556 days from 1992-01-01, keyed yyyymmdd, with d_year."""
    date = ssb.make(SMALL_SSB, np.random.default_rng(0))["date"]
    assert date.shape == (2556, 2)
    assert date[0].tolist() == [19920101, 1992] and date[59].tolist() == [19920229, 1992]
    assert date[-1].tolist() == [19981230, 1998]
    assert np.all(np.diff(date[:, 0]) > 0) and set(date[:, 1]) == set(range(1992, 1999))


def test_ssb_q41_variants_cover_each_region_once():
    variants = ssb.draw_variants("q41", np.random.default_rng(11), 5)
    assert sorted(v["region"] for v in variants) == [0, 1, 2, 3, 4]
    assert all(len(set(v["mfgrs"])) == 2 and max(v["mfgrs"]) < 5 for v in variants)
    assert variants != ssb.draw_variants("q41", np.random.default_rng(12), 5)


def test_ssb_q41_dimensions_keep_the_predicate():
    data = ssb.make(SMALL_SSB, np.random.default_rng(1))
    spec = ssb.query("q41", data, {"region": 2, "mfgrs": [0, 3]})
    (_, fact, _), (_, cust, _), (_, supp, _), (_, part, _), (scheme, date, _) = spec
    assert fact is data["fact"] and date is data["date"] and scheme == ("D", "D1")
    assert np.all(cust[:, 1] // 5 == 2) and np.all(supp[:, 1] // 5 == 2)
    assert set(np.unique(part[:, 1] // 200)) <= {0, 3}
    assert len(cust) == int((data["c_nation"] // 5 == 2).sum())
    flat = ssb.query("flat", data, {})
    assert [s for s, _, _ in flat] == [("A", "B", "C", "D"), ("A", "A1"), ("B", "B1"), ("C", "C1")]
    assert [len(r) for _, r, _ in flat[1:]] == [300, 50, 2000]
