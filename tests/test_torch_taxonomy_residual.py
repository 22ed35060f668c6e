"""The residual carve's dedup skip (``repro_torch.core.taxonomy``) ≡ the JAX
package's ``residual_relations``, on the CPU.

* For every H and every η of a small triangle R(A,B), S(B,C), T(A,C), the
  port's residuals, with and without the per-run memos (``heavy_masks``,
  ``sorted_rows``), equal the reference's in keys, values, dtype and shape;
  a sorted, unique parent sends no row through ``np.unique`` and an unsorted
  one built with ``Relation(...)`` is still deduplicated;
* ``rows_sorted_unique`` says True exactly where ``np.unique(axis=0)`` would
  hand the rows back unchanged;
* a ``JoinSession`` counts the rows its carve built (``carve:rows``) and
  those that went through the dedup (``carve:dedup_rows``): none for a
  query's sorted shared table, all of them for a table built unsorted,
  which returns the same rows.
"""

import itertools

import numpy as np
import pytest

from repro.core import query as jq
from repro.core import taxonomy as j_tax
from repro_torch.core import query as tq
from repro_torch.core import taxonomy as t_tax
from repro_torch.mpc import JoinSession

SCHEMES = (("A", "B"), ("B", "C"), ("A", "C"))


def graph(rng, n, v, lo=0):
    """A sorted, unique oriented edge set over ``v`` ids from ``lo``."""
    e = rng.integers(lo, lo + v, size=(n, 2))
    return np.unique(e[e[:, 0] < e[:, 1]], axis=0)


def hub(value, others, heavy_col):
    """Rows pairing ``value`` with each of ``others``, ``value`` in column ``heavy_col``."""
    cols = [np.full(len(others), value, np.int64), np.asarray(others, np.int64)]
    return np.stack(cols if heavy_col == 0 else cols[::-1], axis=1)


def triangle_shared(rng):
    # the cell's shape: one sorted table behind all three relations, no heavy value
    return "shared", 2, [graph(rng, 300, 80)] * 3, ()


def heavy_x(rng):
    # a hub on A, the first column of R(A,B) and T(A,C)
    e = graph(rng, 120, 40)
    return "make", 8, [np.concatenate([e, hub(0, range(1, 90), 0)]), e,
                       np.concatenate([e, hub(0, range(5, 80), 0)])], ("A",)


def heavy_y(rng):
    # a hub on C, the second column of S(B,C) and T(A,C)
    e = graph(rng, 120, 40)
    return "make", 8, [e, np.concatenate([e, hub(39, range(0, 90), 1)]),
                       np.concatenate([e, hub(39, range(3, 70), 1)])], ("C",)


def two_etas(rng):
    # two hubs on B: R(A,B) carves on y, S(B,C) on x, once per η
    e = graph(rng, 120, 40)
    return "make", 8, [np.concatenate([e, hub(3, range(0, 70), 1), hub(7, range(10, 90), 1)]),
                       np.concatenate([e, hub(3, range(0, 80), 0), hub(7, range(0, 60), 0)]),
                       e], ("B",)


def negative_shifted(rng):
    # negative ids on A, ids past 2**40 on C, a negative hub on A
    r = graph(rng, 150, 60, lo=-30)
    s = graph(rng, 150, 60) + np.array([0, 2**40])
    t = np.concatenate([graph(rng, 150, 60, lo=-30) + np.array([0, 2**40]),
                        hub(-2**35, np.arange(80) + 2**40, 0)])
    return "make", 8, [r, s, t], ("A",)


def empty_parent(rng):
    e = graph(rng, 120, 40)
    return "make", 8, [np.concatenate([e, hub(0, range(1, 90), 0)]),
                       np.zeros((0, 2), np.int64), e], ("A",)


def unsorted_repeats(rng):
    # built with Relation(...) directly: shuffled rows, some twice, a hub on B
    out = []
    for rows in (np.concatenate([graph(rng, 150, 50), hub(3, range(0, 90), 1)]),
                 np.concatenate([graph(rng, 150, 50), hub(3, range(0, 70), 0)]),
                 graph(rng, 150, 50)):
        rows = np.concatenate([rows, rows[::4]])
        out.append(rows[rng.permutation(len(rows))])
    return "direct", 8, out, ("B",)


CASES = {f.__name__: f for f in (triangle_shared, heavy_x, heavy_y, two_etas,
                                  negative_shifted, empty_parent, unsorted_repeats)}


def build(Q, how, tables):
    if how == "make":
        return Q.JoinQuery.make([Q.Relation.make(s, t) for s, t in zip(SCHEMES, tables)])
    if how == "shared":
        data = Q.Relation.make(SCHEMES[0], tables[0]).data
        return Q.JoinQuery.make([Q.Relation(scheme=s, data=data, table="E") for s in SCHEMES])
    return Q.JoinQuery.make([Q.Relation(scheme=s, data=t) for s, t in zip(SCHEMES, tables)])


def assert_same(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert (g.scheme, g.table) == (w.scheme, w.table), k
        assert g.data.dtype == w.data.dtype and g.data.shape == w.data.shape, k
        assert np.array_equal(g.data, w.data), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_residuals_equal_reference_with_and_without_the_memo(case, monkeypatch):
    how, lam, tables, heavy = CASES[case](np.random.default_rng(27))
    qt, qj = build(tq, how, tables), build(jq, how, tables)
    stats, jstats = t_tax.compute_stats(qt, lam), j_tax.compute_stats(qj, lam)
    assert sorted(a for a, v in stats.heavy.items() if v.size) == list(heavy)
    masks, ordered = t_tax.heavy_masks(qt, stats), t_tax.sorted_rows(qt)
    assert set(ordered.values()) == {how != "direct"}

    deduped = []
    base = tq._dedup_rows
    monkeypatch.setattr(tq, "_dedup_rows", lambda a: deduped.append(len(a)) or base(a))
    unary = 0
    for r in range(len(qt.attset) + 1):
        for h in itertools.combinations(qt.attset, r):
            plan, jplan = t_tax.plan_for_h(qt, h), j_tax.plan_for_h(qj, h)
            etas = list(t_tax.configurations(stats, plan.h_set))
            jetas = list(j_tax.configurations(jstats, jplan.h_set))
            assert [e.values for e in etas] == [e.values for e in jetas]
            for eta, jeta in zip(etas, jetas):
                if len(h) == len(qt.attset):
                    continue
                want = j_tax.residual_relations(qj, jstats, jplan, jeta)
                assert_same(t_tax.residual_relations(qt, stats, plan, eta), want)
                assert_same(t_tax.residual_relations(qt, stats, plan, eta, masks=masks,
                                                     ordered=ordered), want)
                unary += sum(len(k[1]) == 1 for k in (want or {}))
    assert unary > 0 if heavy else unary == 0
    if how == "direct":
        assert sum(deduped) > 0
    else:
        assert deduped == []


def rows(*r):
    return np.array(r, dtype=np.int64).reshape(len(r), -1)


ORDERS = {
    "sorted": rows((0, 1), (0, 2), (1, 0), (5, -3)),
    "repeat": rows((0, 1), (0, 1), (1, 0)),
    "swap_in_second_column": rows((0, 2), (0, 1), (1, 0)),
    "swap_in_first_column": rows((1, 0), (0, 9)),
    "negative": rows((-7, 3), (-7, 4), (-1, -9), (2**40, -2**40)),
    "signed_not_unsigned": rows((-1, 0), (1, 0)),
    "one_row": rows((4, 4)),
    "empty": np.zeros((0, 2), np.int64),
    "unary": rows(-3, 0, 8),
    "unary_repeat": rows(-3, 8, 8),
    "three_columns": rows((0, 0, 1), (0, 1, 0), (0, 1, 0)),
    "int32": rows((0, 1), (2, 3)).astype(np.int32),
}


@pytest.mark.parametrize("name", sorted(ORDERS))
def test_rows_sorted_unique_is_np_unique_leaving_rows_unchanged(name):
    a = ORDERS[name]
    want = a.size == 0 or np.array_equal(np.unique(a.astype(np.int64), axis=0), a)
    assert tq.rows_sorted_unique(a) == want


def rows_key(r):
    return sorted(map(tuple, r.tolist()))


def test_session_counts_carved_rows_and_dedups_only_unsorted_tables():
    rng = np.random.default_rng(27)
    e = graph(rng, 400, 60)
    q = tq.query_from_arrays([(s, e, "E") for s in SCHEMES])
    assert t_tax.compute_stats(q, 4).n_heavy() == 0     # one stage, η = ∅: every row carved
    raw = np.concatenate([e, e[::3]])
    raw = raw[rng.permutation(len(raw))]
    unsorted = tq.JoinQuery.make([tq.Relation(scheme=s, data=raw, table="E") for s in SCHEMES])
    assert t_tax.compute_stats(unsorted, 4).n_heavy() == 0

    session = JoinSession(p=8, device="cpu")
    cold, warm, loose = (session.submit(x, lam=4) for x in (q, q, unsorted))
    carve = "execute/op.RouteResidual/carve:"
    for res in (cold, warm):
        assert res.counters[carve + "rows"] == 3 * len(e)
        assert res.counters[carve + "dedup_rows"] == 0
    assert loose.counters[carve + "rows"] == loose.counters[carve + "dedup_rows"] == 3 * len(e)
    assert rows_key(loose.rows) == rows_key(warm.rows) == rows_key(tq.reference_join(q).data)
    assert len(warm.rows) > 0
