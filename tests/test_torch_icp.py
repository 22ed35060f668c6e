"""The port's isolated cartesian product accounting (``repro_torch.core.icp``),
semi-join reduction oracle (``repro_torch.core.semijoin``) and the heavy/light
taxonomy behind them ≡ the JAX package's, on the CPU.

Twins of tests/test_engine_property.py's ICP and taxonomy properties and of
benchmarks/bench_isolated_cp.py's hub star: both packages get the same data
(each package's own generator at the same numpy seed), ``all_icp_checks``
is equal field by field — (H, J), the exact left-hand side Σ_η |CP_J(η)|
and both right-hand sides (Theorem 5.4, Lemma 5.5) — and every left-hand
side stays within both bounds.
"""

import itertools

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import icp as j_icp
from repro.core import query as jq
from repro.core import semijoin as j_sj
from repro.core import taxonomy as j_tax
from repro_torch.core import icp as t_icp
from repro_torch.core import query as tq
from repro_torch.core import semijoin as t_sj
from repro_torch.core import taxonomy as t_tax


def build_query(Q, seed, kind, n_attrs, n_tuples, dom, skew):
    rng = np.random.default_rng(seed)
    rels = []
    for e in Q.pattern_edges(kind, n_attrs):
        cols = []
        for _ in range(2):
            if skew > 0:
                ranks = np.arange(1, dom + 1, dtype=np.float64) ** (-skew)
                ranks /= ranks.sum()
                cols.append(rng.choice(dom, size=n_tuples, p=ranks))
            else:
                cols.append(rng.integers(0, dom, size=n_tuples))
        rels.append(Q.Relation.make(e, np.stack(cols, axis=1)))
    return Q.JoinQuery.make(rels)


def hub_query(Q, kind, n_attrs, n, rng):
    """benchmarks/bench_load_vs_p.py's adversarial hub: one super-heavy value
    on X0 (rebuilt here for each package from the same seed)."""
    rels = []
    for e in Q.pattern_edges(kind, n_attrs):
        if e[0] == "X0":
            data = np.stack([np.zeros(n, np.int64), np.arange(n)], axis=1)
        elif e[1] == "X0":
            data = np.stack([np.arange(n), np.zeros(n, np.int64)], axis=1)
        else:
            data = rng.integers(0, n, size=(n, 2))
        rels.append(Q.Relation.make(e, data))
    return Q.JoinQuery.make(rels)


def assert_same_checks(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.h_set, a.j_set, a.lhs, a.rhs_thm54, a.rhs_lem55, a.ok) == (
            b.h_set, b.j_set, b.lhs, b.rhs_thm54, b.rhs_lem55, b.ok)
        assert type(a.lhs) is int


def assert_bounds_hold(checks):
    for c in checks:
        assert c.lhs <= c.rhs_thm54 + 1e-9, (c.h_set, c.j_set, c.lhs, c.rhs_thm54)
        assert c.lhs <= c.rhs_lem55 + 1e-9
        assert c.ok


@pytest.mark.parametrize("lam", [4, 8, 16])
def test_hub_star_icp_checks_equal_reference(lam):
    """bench_isolated_cp.py's configuration at a cut size (600 tuples per
    relation instead of 1500; the full size runs in chip_smoke.py)."""
    qt = hub_query(tq, "star", 4, 600, np.random.default_rng(2))
    qj = hub_query(jq, "star", 4, 600, np.random.default_rng(2))
    got = t_icp.all_icp_checks(qt, t_tax.compute_stats(qt, lam))
    want = j_icp.all_icp_checks(qj, j_tax.compute_stats(qj, lam))
    assert_same_checks(got, want)
    assert_bounds_hold(got)
    assert sum(1 for c in got if c.lhs > 0) > 0


@pytest.mark.parametrize("kind,n_attrs,lam", [("star", 4, 3), ("cycle", 4, 2),
                                              ("clique", 4, 4), ("line", 5, 3)])
def test_icp_checks_equal_reference(kind, n_attrs, lam):
    qt = build_query(tq, 9, kind, n_attrs, 50, 6, 2.0)
    qj = build_query(jq, 9, kind, n_attrs, 50, 6, 2.0)
    got = t_icp.all_icp_checks(qt, t_tax.compute_stats(qt, lam))
    assert_same_checks(got, j_icp.all_icp_checks(qj, j_tax.compute_stats(qj, lam)))
    assert_bounds_hold(got)


def test_icp_check_rejects_j_outside_isolated():
    q = build_query(tq, 1, "star", 4, 40, 6, 2.0)
    stats = t_tax.compute_stats(q, 3)
    plan = t_tax.plan_for_h(q, ("X0",))
    assert plan.isolated
    chk = t_icp.icp_check(q, stats, ("X0",))
    assert chk.j_set == plan.isolated
    with pytest.raises(ValueError):
        t_icp.icp_check(q, stats, ("X0",), ("X0",))


@settings(max_examples=10, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    kind=st.sampled_from(["star", "cycle", "clique"]),
    n_attrs=st.integers(3, 4),
    lam=st.sampled_from([2, 3, 4]),
)
def test_isolated_cartesian_product_theorem_matches_reference(seed, kind, n_attrs, lam):
    """Theorem 5.4 (and the weaker Lemma 5.5) for every H and non-empty
    J ⊆ I, with the port's checks equal to the reference's."""
    qt = build_query(tq, seed, kind, n_attrs, 50, 6, 2.0)
    qj = build_query(jq, seed, kind, n_attrs, 50, 6, 2.0)
    got = t_icp.all_icp_checks(qt, t_tax.compute_stats(qt, lam))
    assert_same_checks(got, j_icp.all_icp_checks(qj, j_tax.compute_stats(qj, lam)))
    assert_bounds_hold(got)


@settings(max_examples=10, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    kind=st.sampled_from(["line", "cycle", "clique", "star"]),
    n_attrs=st.integers(3, 4),
    dom=st.integers(3, 12),
    lam=st.sampled_from([2, 4]),
)
def test_taxonomy_is_disjoint_partition_and_matches_reference(seed, kind, n_attrs, dom, lam):
    """(4.2): Join(Q) = ⊎_H ⊎_η Join(Q'(η)) × {η}, through the port's
    semi-join reduction oracle — each reduced query equal to the
    reference's."""
    qt = build_query(tq, seed, kind, n_attrs, 60, dom, 2.0)
    qj = build_query(jq, seed, kind, n_attrs, 60, dom, 2.0)
    stats, jstats = t_tax.compute_stats(qt, lam), j_tax.compute_stats(qj, lam)
    attrs = qt.attset
    total = 0
    for r in range(len(attrs) + 1):
        for h in itertools.combinations(attrs, r):
            plan, jplan = t_tax.plan_for_h(qt, h), j_tax.plan_for_h(qj, h)
            etas = list(t_tax.configurations(stats, plan.h_set))
            jetas = list(j_tax.configurations(jstats, jplan.h_set))
            assert [e.values for e in etas] == [e.values for e in jetas]
            for eta, jeta in zip(etas, jetas):
                if len(h) == len(attrs):
                    total += all(
                        stats.pair.get((rel.edge, eta.value(rel.scheme[0]),
                                        eta.value(rel.scheme[1])), 0) > 0
                        for rel in qt.relations)
                    continue
                red = t_sj.semijoin_reduce(qt, stats, plan, eta)
                jred = j_sj.semijoin_reduce(qj, jstats, jplan, jeta)
                assert (red is None) == (jred is None)
                if red is None:
                    continue
                assert red.isolated_sizes() == jred.isolated_sizes()
                assert red.isolated_cp_size() == jred.isolated_cp_size()
                rows = t_sj.join_reduced(red, plan)
                assert rows.tobytes() == j_sj.join_reduced(jred, jplan).tobytes()
                total += rows.shape[0]
    assert total == len(tq.reference_join(qt))
