"""The port's static verifier (``repro_torch.mpc.verify``) and load model
(``repro_torch.analysis.loadmodel``) ≡ the JAX package's, on the CPU.

Twin of tests/test_verify.py, the binary suite and the general-program
(``join-tree`` / ``share-exponent``) mutations.  Every mutation compiles a
*good* program in each
package from the same data, corrupts the same invariant in both, and asserts
the port raises :class:`ProgramVerificationError` with exactly the
reference's ``(rule, op_round)``.  Good programs verify clean with equal
reports, the symbolic bounds and ``check_load``'s measured/bound fractions
are equal, and the service's cold/warm verification holds on the simulator
and the CPU data plane.  ``compile_plan`` verifies every program under
``REPRO_VERIFY`` (on for the whole suite), so every port test that compiles
is also a zero-false-positive check of this verifier.
"""

from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.analysis.loadmodel as j_lm
import repro.core.hypergraph as j_hg
import repro.core.planner as j_planner
import repro.core.query as j_query
import repro.core.taxonomy as j_tax
import repro.mpc.cartesian as j_cart
import repro.mpc.executors as j_exec
import repro.mpc.faults as j_faults
import repro.mpc.program as j_prog
import repro.mpc.verify as j_verify
from repro.mpc.service import JoinSession as JaxSession
import repro_torch.analysis.loadmodel as t_lm
import repro_torch.core.hypergraph as t_hg
import repro_torch.core.planner as t_planner
import repro_torch.core.query as t_query
import repro_torch.core.taxonomy as t_tax
import repro_torch.mpc.cartesian as t_cart
import repro_torch.mpc.executors as t_exec
import repro_torch.mpc.faults as t_faults
import repro_torch.mpc.program as t_prog
import repro_torch.mpc.verify as t_verify
from repro_torch.mpc import DataplaneExecutor, JoinServiceError, JoinSession, RunConfig
from repro_torch.mpc.executors import _pack_radices
from repro_torch.mpc.faults import ProgramVerificationError
from repro_torch.mpc.verify import (
    RULES,
    check_load,
    check_packed_key,
    on_cap_grid,
    verify_caps,
    verify_program,
)

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)


def package(q, hg, planner, tax, cart, ex, faults, prog, verify, lm):
    return SimpleNamespace(
        q=q, rho=hg.rho, heavy_parameter=planner.heavy_parameter,
        MachineGroup=planner.MachineGroup, compute_stats=tax.compute_stats,
        CartesianGrid=cart.CartesianGrid, SimulatorExecutor=ex.SimulatorExecutor,
        Error=faults.ProgramVerificationError, prog=prog, v=verify, lm=lm,
    )


PORT = package(t_query, t_hg, t_planner, t_tax, t_cart, t_exec, t_faults, t_prog, t_verify,
               t_lm)
REF = package(j_query, j_hg, j_planner, j_tax, j_cart, j_exec, j_faults, j_prog, j_verify,
              j_lm)


def triangle(P, seed=2, n=200, dom=30, skew=2.0):
    return P.q.random_query(np.random.default_rng(seed), "clique", 3, tuples_per_rel=n,
                            dom_size=dom, skew=skew)


def compiled(P, q=None, p=8, lam=16, fuse=False):
    q = q if q is not None else triangle(P)
    return P.prog.compile_plan(q, P.compute_stats(q, lam), p, fuse_semijoin=fuse,
                               verify=False)


def shared_triangle(P, other=False):
    base = np.random.default_rng(0).integers(0, 20, size=(60, 2))
    mid = np.random.default_rng(1).integers(0, 20, size=(60, 2)) if other else base
    return P.q.JoinQuery.make([
        P.q.Relation.make(("X0", "X1"), base, table="edges"),
        P.q.Relation.make(("X1", "X2"), mid, table="edges"),
        P.q.Relation.make(("X0", "X2"), base, table="edges"),
    ])


def hub_triangle(P, n=1500, seed=3):
    """Triangle with a degree-n hub value on X0 (tests/test_verify.py)."""
    rng = np.random.default_rng(seed)
    rels = []
    for e in P.q.pattern_edges("clique", 3):
        if e[0] == "X0":
            data = np.stack([np.zeros(n, np.int64), np.arange(n)], axis=1)
        elif e[1] == "X0":
            data = np.stack([np.arange(n), np.zeros(n, np.int64)], axis=1)
        else:
            data = rng.integers(0, n, size=(n, 2))
        rels.append(P.q.Relation.make(e, data))
    return P.q.JoinQuery.make(rels)


# ---------------------------------------------------------------------------
# the binary mutation suite: each returns a thunk that must raise
# ---------------------------------------------------------------------------


def m_dropped_op(P):
    prog = compiled(P)
    prog.ops = tuple(op for op in prog.ops if not isinstance(op, P.prog.RouteResidual))
    return lambda: P.v.verify_program(prog)


def m_duplicated_collective(P):
    prog = compiled(P)
    prog.ops = prog.ops + (P.prog.GridRoute(),)
    return lambda: P.v.verify_program(prog)


def m_reordered_collectives(P):
    prog = compiled(P)
    ops = list(prog.ops)
    ops[1], ops[-2] = ops[-2], ops[1]
    prog.ops = tuple(ops)
    return lambda: P.v.verify_program(prog)


def m_broken_semijoin_pair(P):
    prog = compiled(P)
    prog.ops = tuple(P.prog.SemiJoin(phase="x") if isinstance(op, P.prog.SemiJoin) else op
                     for op in prog.ops)
    return lambda: P.v.verify_program(prog)


def m_fused_flag_without_fused_ops(P):
    prog = compiled(P)
    prog.fused = True
    return lambda: P.v.verify_program(prog)


def m_fused_ops_reordered(P):
    prog = compiled(P, fuse=True)
    ops = list(prog.ops)
    i = next(i for i, op in enumerate(ops) if isinstance(op, P.prog.SemiJoin))
    ops[i], ops[i + 1] = ops[i + 1], ops[i]
    prog.ops = tuple(ops)
    return lambda: P.v.verify_program(prog)


def m_oversized_step1_group(P):
    prog = compiled(P)
    st = prog.stages[0]
    st.cfg.step1_group = P.MachineGroup(base=st.cfg.step1_group.base, size=prog.p + 5,
                                        p=prog.p)
    return lambda: P.v.verify_program(prog)


def m_corrupted_m_eta(P):
    prog = compiled(P)
    prog.stages[0].cfg.m_eta += 7
    return lambda: P.v.verify_program(prog)


def m_unstable_group_base(P):
    prog = compiled(P)
    st = prog.stages[0]
    st.cfg.step1_group = P.MachineGroup(base=(st.cfg.step1_group.base + 1) % prog.p,
                                        size=st.cfg.step1_group.size, p=prog.p)
    return lambda: P.v.verify_program(prog)


def m_lam_disagrees_with_stats(P):
    prog = compiled(P)
    prog.lam = prog.lam + 1
    return lambda: P.v.verify_program(prog)


def m_broken_grid_dims_product(P):
    prog = compiled(P)
    st = next(s for s in prog.stages if s.plan.isolated)
    geo = P.prog.stage_geometry(prog, st, {x: [(0, 50)] for x in st.plan.isolated})
    assert P.v.check_stage_geometry(geo, prog.p) > 0      # clean before corruption
    geo.grid.dims[0] = geo.grid.p + 1
    return lambda: P.v.check_stage_geometry(geo, prog.p)


def m_oversized_cell_space(P):
    geo = P.prog.StageGeometry()
    big = 1 << 32
    geo.grid = P.CartesianGrid([big], big)
    geo.step3_group = P.MachineGroup(base=0, size=big, p=big)
    return lambda: P.v.check_stage_geometry(geo, big)


def m_packed_flag_on_oversized_key_space(P):
    P.v.check_packed_key(2**10, [2**4, 2**3], packed=True)
    P.v.check_packed_key(2**40, [2**12], packed=False)
    return lambda: P.v.check_packed_key(2**20, [2**12, 2**5], packed=True)


def m_packed_flag_on_negative_key(P):
    return lambda: P.v.check_packed_key(2**4, [-1], packed=True)


def m_alias_class_mismatch(P):
    prog = compiled(P, q=shared_triangle(P), lam=8)
    P.v.verify_program(prog)                               # shared tables verify clean
    return lambda: P.v.verify_bindings(prog.rebind(shared_triangle(P, other=True)))


def m_unbound_cache_entry(P):
    prog = compiled(P)
    return lambda: P.v.verify_bindings(replace(prog, query=None))


def m_emit_machine_out_of_range(P):
    prog = compiled(P)
    if not prog.emit:
        prog.emit = [(0, np.zeros((1, len(prog.out_cols)), dtype=np.int64))]
    _, row = prog.emit[0]
    prog.emit[0] = (prog.p + 3, row)
    return lambda: P.v.verify_program(prog)


def m_emit_row_width(P):
    prog = compiled(P)
    prog.emit = [(0, np.zeros((1, len(prog.out_cols) + 1), dtype=np.int64))]
    return lambda: P.v.verify_program(prog)


def m_off_grid_cap(P):
    P.v.verify_caps({("k",): {"slot": 64, "out": 24}})
    return lambda: P.v.verify_caps({("k",): {"slot": 17}})


def m_off_grid_learned_cap_in_program_pass(P):
    return lambda: P.v.verify_program(compiled(P), caps={("k",): {"out": 40}})


def m_misplanned_load(P):
    """λ = 2 never tags the degree-n hub heavy: the measured semi-join load
    exceeds the Theorem 6.2 model bound at p = 256."""
    q = hub_triangle(P)
    prog = P.prog.compile_plan(q, P.compute_stats(q, 2), 256, verify=False)
    res = P.SimulatorExecutor(p=256).run(prog, materialize=False)
    with pytest.raises(P.Error):                           # the plain-mapping form too
        P.v.check_load(prog, res.sim.merged_round_loads())
    return lambda: P.v.check_load(prog, res)


MUTATIONS = {f.__name__[2:]: f for f in [
    m_dropped_op, m_duplicated_collective, m_reordered_collectives, m_broken_semijoin_pair,
    m_fused_flag_without_fused_ops, m_fused_ops_reordered, m_oversized_step1_group,
    m_corrupted_m_eta, m_unstable_group_base, m_lam_disagrees_with_stats,
    m_broken_grid_dims_product, m_oversized_cell_space, m_packed_flag_on_oversized_key_space,
    m_packed_flag_on_negative_key, m_alias_class_mismatch, m_unbound_cache_entry,
    m_emit_machine_out_of_range, m_emit_row_width, m_off_grid_cap,
    m_off_grid_learned_cap_in_program_pass, m_misplanned_load,
]}

#: the reference's (rule, op_round) where tests/test_verify.py pins it
PINNED = {
    "dropped_op": ("collective-stream", "step1"),
    "oversized_step1_group": ("grid-invariants", "step1"),
    "emit_machine_out_of_range": ("scatter-binding", "output"),
    "alias_class_mismatch": ("scatter-binding", "scatter"),
    "oversized_cell_space": ("packed-key", "step3-route"),
}


def raised(P, name):
    thunk = MUTATIONS[name](P)
    with pytest.raises(P.Error) as ei:
        thunk()
    assert isinstance(ei.value, JoinServiceError if P is PORT else j_faults.JoinServiceError)
    return ei.value.rule, ei.value.op_round


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_mutation_caught_with_the_reference_rule_and_round(name):
    got, want = raised(PORT, name), raised(REF, name)
    assert got == want
    assert got[0] in RULES
    if name in PINNED:
        assert got == PINNED[name]
    if name == "misplanned_load":
        assert got[1] in ("step2-bx", "step3-route")


def test_rules_are_the_binary_rules_of_the_reference():
    # the binary rules and, with the general route, the join-tree and
    # share-exponent rules: the reference's list, in its order
    assert RULES == tuple(j_verify.RULES)
    assert {"join-tree", "share-exponent"} <= set(RULES)


# ---------------------------------------------------------------------------
# zero false positives on good programs
# ---------------------------------------------------------------------------

GOOD = {
    "triangle": lambda P: compiled(P),
    "triangle-fused": lambda P: compiled(P, fuse=True),
    "shared-tables": lambda P: compiled(P, q=shared_triangle(P), lam=8),
    "cycle4-p16": lambda P: compiled(P, q=P.q.random_query(
        np.random.default_rng(3), "cycle", 4, tuples_per_rel=200, dom_size=20, skew=1.0),
        p=16, lam=3),
    "hub-star": lambda P: compiled(P, q=P.q.hub_star_query(n=48, hub_n=24, dom_size=25),
                                   lam=10),
    "disconnected": lambda P: compiled(P, q=P.q.disconnected_query(90, dom_size=12, skew=1.8),
                                       lam=8),
}


@pytest.mark.parametrize("name", list(GOOD))
def test_good_programs_verify_clean_with_equal_reports(name):
    got = verify_program(GOOD[name](PORT))
    want = j_verify.verify_program(GOOD[name](REF))
    assert (got.p, got.stages, got.checks, got.geometry_probes) == (
        want.p, want.stages, want.checks, want.geometry_probes)
    assert got.checks > 0 and got.geometry_probes > 0
    assert repr(got) == repr(want)


# ---------------------------------------------------------------------------
# load-bound: the symbolic model and check_load
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fuse", [False, True])
def test_load_model_equals_reference(fuse):
    got = t_lm.round_bounds(compiled(PORT, fuse=fuse))
    want = j_lm.round_bounds(compiled(REF, fuse=fuse))
    assert [(b.round, b.words, b.formula) for b in got] == [
        (b.round, b.words, b.formula) for b in want]
    names = [b.round for b in got]
    assert "step1" in names and "step3-route" in names
    assert "scatter" not in names and "output" not in names
    assert t_lm.predicted_load(compiled(PORT, fuse=fuse)) == pytest.approx(
        sum(b.words for b in got))
    if not fuse:
        by = t_lm.round_bounds_by_name(compiled(PORT))
        assert by["step2-bx"].words > by["step1"].words
    assert t_lm.ideal_load(1000, 64, 1.5) == j_lm.ideal_load(1000, 64, 1.5)
    assert (t_lm.MODEL_CONSTANT, t_lm.DATA_ROUNDS) == (j_lm.MODEL_CONSTANT, j_lm.DATA_ROUNDS)


@pytest.mark.parametrize("kind,k,skew,p", [("clique", 3, 0.0, 256), ("cycle", 4, 1.5, 64),
                                           ("hub", 3, None, 256)])
def test_check_load_fractions_equal_reference(kind, k, skew, p):
    """A well-planned program (canonical λ) sits inside every round bound,
    with measured/bound fractions equal to the reference's."""
    fr = []
    for P in (PORT, REF):
        q = hub_triangle(P) if kind == "hub" else P.q.random_query(
            np.random.default_rng(11), kind, k, tuples_per_rel=1500, dom_size=1500, skew=skew)
        lam = P.heavy_parameter(p, float(P.rho(q)))
        prog = P.prog.compile_plan(q, P.compute_stats(q, lam), p, verify=False)
        res = P.SimulatorExecutor(p=p).run(prog, materialize=False)
        fr.append(P.v.check_load(prog, res))
    assert fr[0] == fr[1]
    assert fr[0] and max(fr[0].values()) < 1.0


def test_bench_hub_triangle_load_bound_equals_reference_at_both_lambdas():
    """benchmarks/bench_subgraph.py's triangle-hubs graph at p = 64: planned
    at the canonical λ* it sits inside every round bound; at the bench's own
    λ = 24 the step-1 groups are sized for six times λ*, and both packages
    reject its step-1 load with the same (rule, op_round, detail)."""
    import repro.graph as j_graph
    import repro_torch.graph as t_graph

    verdicts = []
    for P, G in ((PORT, t_graph), (REF, j_graph)):
        g = G.zipf_graph(np.random.default_rng(11), 150, 700, skew=2.0)
        q = G.compile_pattern(g, G.triangle()).query
        lam_star = P.heavy_parameter(64, float(P.rho(q)))
        got = []
        for lam in (lam_star, 24):
            prog = P.prog.compile_plan(q, P.compute_stats(q, lam), 64, verify=False)
            res = P.SimulatorExecutor(p=64).run(prog, materialize=False)
            try:
                got.append(P.v.check_load(prog, res))
            except P.Error as e:
                got.append((e.rule, e.op_round, e.detail))
        verdicts.append((lam_star, got))
    assert verdicts[0] == verdicts[1]
    lam_star, (at_star, at_24) = verdicts[0]
    assert lam_star == 4
    assert isinstance(at_star, dict) and max(at_star.values()) < 1.0
    assert at_24[:2] == ("load-bound", "step1")


# ---------------------------------------------------------------------------
# general (arbitrary-arity) programs: join-tree / share-exponent
# ---------------------------------------------------------------------------


def general_compiled(P, kind="star3", p=8, lam=8):
    q = P.q.general_query(kind, n=60, dom_size=6, skew=0.5, seed=9)
    return P.prog.compile_plan(q, P.compute_stats(q, lam), p, verify=False)


def g_corrupted_tree_edge(P):
    # reattach the first GYO-removed child under a non-parent leaf
    prog = general_compiled(P)
    gen = prog.general
    c, par, sh = gen.tree_edges[0]
    other = next(i for i, _ in enumerate(prog.query.relations)
                 if i not in (c, par, gen.tree_root))
    prog.general = replace(gen, tree_edges=((c, other, sh),) + gen.tree_edges[1:])
    return lambda: P.v.verify_program(prog)


def g_edge_label_not_full_intersection(P):
    prog = general_compiled(P)
    gen = prog.general
    c, par, sh = gen.tree_edges[0]
    prog.general = replace(gen, tree_edges=((c, par, ()),) + gen.tree_edges[1:])
    return lambda: P.v.verify_program(prog)


def g_edge_label_widened(P):
    prog = general_compiled(P, "path4")
    gen = prog.general
    c, par, sh = gen.tree_edges[-1]
    wide = tuple(sorted(set(sh) | set(prog.query.relations[c].scheme)))
    prog.general = replace(gen, tree_edges=gen.tree_edges[:-1] + ((c, par, wide),))
    return lambda: P.v.verify_program(prog)


def g_sweep_order_not_leaves_first(P):
    prog = general_compiled(P, "snowflake")
    gen = prog.general
    e = list(gen.tree_edges)
    e[0], e[1] = e[1], e[0]
    prog.general = replace(gen, tree_edges=tuple(e))
    return lambda: P.v.verify_program(prog)


def g_join_order_child_before_parent(P):
    prog = general_compiled(P)
    gen = prog.general
    order = list(gen.join_order)
    order[0], order[1] = order[1], order[0]
    prog.general = replace(gen, join_order=tuple(order))
    return lambda: P.v.verify_program(prog)


def g_join_order_grandchild_first(P):
    # snowflake: the chain keeps the root first but joins a leaf of depth 2
    # before its parent
    prog = general_compiled(P, "snowflake")
    gen = prog.general
    order = list(gen.join_order)
    parent = {c: par for c, par, _ in gen.tree_edges}
    deep = next(n for n in order if parent.get(n) not in (None, gen.tree_root))
    order.remove(deep)
    order.insert(1, deep)
    prog.general = replace(gen, join_order=tuple(order))
    return lambda: P.v.verify_program(prog)


def g_join_order_not_a_permutation(P):
    prog = general_compiled(P, "triangle")
    gen = prog.general
    prog.general = replace(gen, join_order=gen.join_order[:-1] + (gen.join_order[0],))
    return lambda: P.v.verify_program(prog)


def g_acyclic_demoted_to_cyclic(P):
    prog = general_compiled(P)
    prog.general = replace(prog.general, kind="hypercube", tree_edges=())
    prog.ops = P.prog.GENERAL_CYCLIC_OPS
    return lambda: P.v.verify_program(prog)


def g_cyclic_plan_with_tree_edges(P):
    prog = general_compiled(P, "triangle")
    prog.general = replace(prog.general, tree_edges=((1, 0, ("X1",)),))
    return lambda: P.v.verify_program(prog)


def g_cyclic_claims_yannakakis(P):
    prog = general_compiled(P, "triangle")
    prog.general = replace(prog.general, kind="yannakakis")
    prog.ops = P.prog.GENERAL_ACYCLIC_OPS
    return lambda: P.v.verify_program(prog)


def g_share_product_over_budget(P):
    prog = general_compiled(P, "triangle")
    gen = prog.general
    prog.general = replace(gen, shares=tuple((a, s * 4) for a, s in gen.shares))
    return lambda: P.v.verify_program(prog)


def g_budget_legal_but_non_lp_shares(P):
    prog = general_compiled(P, "triangle")
    gen = prog.general
    attrs = [a for a, _ in gen.shares]
    prog.general = replace(gen, shares=((attrs[0], 8),) + tuple((a, 1) for a in attrs[1:]))
    return lambda: P.v.verify_program(prog)


def g_share_attribute_dropped(P):
    prog = general_compiled(P, "star3", p=64)
    gen = prog.general
    prog.general = replace(gen, shares=gen.shares[1:])
    return lambda: P.v.verify_program(prog)


def g_zero_share(P):
    prog = general_compiled(P, "star3", p=64)
    gen = prog.general
    (a, _), rest = gen.shares[0], gen.shares[1:]
    prog.general = replace(gen, shares=((a, 0),) + rest)
    return lambda: P.v.verify_program(prog)


def g_general_sweep_out_of_order(P):
    prog = general_compiled(P)
    prog.ops = (P.prog.Scatter(), P.prog.TreeSemiJoin(phase="down"),
                P.prog.TreeSemiJoin(phase="up"), P.prog.ShareRoute(), P.prog.CellJoin())
    return lambda: P.v.verify_program(prog)


def g_general_share_route_dropped(P):
    prog = general_compiled(P, "triangle")
    prog.ops = tuple(op for op in prog.ops if not isinstance(op, P.prog.ShareRoute))
    return lambda: P.v.verify_program(prog)


def g_general_binary_op_spliced_in(P):
    prog = general_compiled(P, "path4")
    prog.ops = prog.ops[:3] + (P.prog.GridRoute(),) + prog.ops[3:]
    return lambda: P.v.verify_program(prog)


def g_general_off_grid_learned_cap(P):
    prog = general_compiled(P)
    return lambda: P.v.verify_program(prog, caps={("hc-route", ("ghc", 0), "k", None): {
        "slot": 17, "out": 32}})


GENERAL_MUTATIONS = {f.__name__[2:]: f for f in [
    g_corrupted_tree_edge, g_edge_label_not_full_intersection, g_edge_label_widened,
    g_sweep_order_not_leaves_first, g_join_order_child_before_parent,
    g_join_order_grandchild_first, g_join_order_not_a_permutation,
    g_acyclic_demoted_to_cyclic, g_cyclic_plan_with_tree_edges, g_cyclic_claims_yannakakis,
    g_share_product_over_budget, g_budget_legal_but_non_lp_shares, g_share_attribute_dropped,
    g_zero_share, g_general_sweep_out_of_order, g_general_share_route_dropped,
    g_general_binary_op_spliced_in, g_general_off_grid_learned_cap,
]}

#: the reference's rule where tests/test_verify.py pins it
GENERAL_PINNED = {
    "corrupted_tree_edge": "join-tree",
    "sweep_order_not_leaves_first": "join-tree",
    "join_order_child_before_parent": "join-tree",
    "acyclic_demoted_to_cyclic": "join-tree",
    "share_product_over_budget": "share-exponent",
    "budget_legal_but_non_lp_shares": "share-exponent",
    "general_sweep_out_of_order": "collective-stream",
}


def general_raised(P, name):
    thunk = GENERAL_MUTATIONS[name](P)
    with pytest.raises(P.Error) as ei:
        thunk()
    return ei.value.rule, ei.value.op_round, str(ei.value)


@pytest.mark.parametrize("name", list(GENERAL_MUTATIONS))
def test_general_mutation_caught_with_the_reference_rule_and_round(name):
    got, want = general_raised(PORT, name), general_raised(REF, name)
    assert got[:2] == want[:2]
    assert got[0] in RULES
    if name in GENERAL_PINNED:
        assert got[0] == GENERAL_PINNED[name]
    if name == "share_product_over_budget":
        assert "exceeds the machine budget" in got[2]


@pytest.mark.parametrize("kind", ["star3", "snowflake", "path4", "triangle"])
@pytest.mark.parametrize("p", [8, 64])
def test_good_general_programs_verify_clean_with_equal_reports(kind, p):
    got = verify_program(general_compiled(PORT, kind, p=p))
    want = j_verify.verify_program(general_compiled(REF, kind, p=p))
    assert repr(got) == repr(want)
    assert got.checks > 0 and got.geometry_probes == 0
    assert general_compiled(PORT, kind).general.kind == (
        "hypercube" if kind == "triangle" else "yannakakis")


@pytest.mark.parametrize("kind", ["star3", "snowflake", "path4", "triangle"])
def test_general_check_load_fractions_equal_reference(kind):
    """The four general families at p=64, the canonical λ: the metered
    simulator's general rounds are held to the load model in both packages
    with equal fractions, or fail with the same rule and round."""
    def run(P):
        q = P.q.general_query(kind, n=120, dom_size=16, skew=0.8, seed=11)
        lam = P.heavy_parameter(64, P.rho(q))
        prog = P.prog.compile_plan(q, P.compute_stats(q, lam), 64, verify=False)
        res = P.SimulatorExecutor(p=64).run(prog, materialize=False)
        try:
            return P.v.check_load(prog, res)
        except P.Error as e:
            return (e.rule, e.op_round)

    got, want = run(PORT), run(REF)
    assert got == want
    if isinstance(got, dict):
        assert "hc-route" in got


# ---------------------------------------------------------------------------
# verification hooks: compile_plan, RunConfig, the service
# ---------------------------------------------------------------------------


def test_compile_plan_env_default(monkeypatch):
    q = triangle(PORT)
    stats = PORT.compute_stats(q, 16)
    prog = t_prog.compile_plan(q, stats, 8)
    prog.stages[0].cfg.m_eta += 1
    monkeypatch.setenv("REPRO_VERIFY", "0")
    assert not t_prog._verify_default()
    t_prog.compile_plan(q, stats, 8)
    monkeypatch.setenv("REPRO_VERIFY", "1")
    assert t_prog._verify_default()
    t_prog.compile_plan(q, stats, 8)
    with pytest.raises(ProgramVerificationError):
        verify_program(prog)
    # compile_plan's own pass runs the verifier: a corrupted planner shows
    calls = []
    monkeypatch.setattr(t_verify, "verify_program", lambda prog, caps=None: calls.append(prog))
    out = t_prog.compile_plan(q, stats, 8)
    assert calls == [out]
    t_prog.compile_plan(q, stats, 8, verify=False)
    assert calls == [out]


@pytest.mark.parametrize("backend", ["simulator", "dataplane"])
def test_service_verifies_cold_and_rebinds_warm(backend):
    q = triangle(PORT)
    s = JoinSession(p=4, backend=backend, device="cpu", verify=True)
    ref = JaxSession(p=4, backend="simulator", verify=True)
    try:
        cold, warm = s.submit(q, lam=16), s.submit(q, lam=16)
        assert cold.verified and not cold.plan_cache_hit
        assert cold.verify_us > 0
        assert warm.plan_cache_hit and not warm.verified
        assert warm.verify_us < cold.verify_us
        assert s.stats.verified == 1
        assert s.stats.verify_us >= cold.verify_us
        assert cold.total_us == pytest.approx(
            cold.stats_us + cold.compile_us + cold.verify_us + cold.execute_us)
        want = ref.submit(triangle(REF), lam=16)
        assert cold.count == warm.count == want.count
        assert sorted(map(tuple, cold.rows.tolist())) == sorted(map(tuple, want.rows.tolist()))
        # coalesced and async submits verify the same way (all warm here)
        co = s.submit_coalesced([q, q], lam=16)
        fut = s.submit_async(q, lam=16).result(timeout=120)
        assert all(r.plan_cache_hit and r.verify_us > 0 and not r.verified
                   for r in co + [fut])
        assert s.stats.verified == 1
    finally:
        s.close()
        ref.close()


@pytest.mark.parametrize("backend", ["simulator", "dataplane"])
def test_service_verify_off_is_free(backend):
    s = JoinSession(p=4, backend=backend, device="cpu", verify=False)
    try:
        r = s.submit(triangle(PORT), lam=16)
        assert not r.verified and r.verify_us == 0.0
        assert s.stats.verified == 0 and s.stats.verify_us == 0.0
    finally:
        s.close()


def test_service_default_follows_repro_verify(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY", "0")
    assert not JoinSession(p=4, device="cpu").verify
    monkeypatch.setenv("REPRO_VERIFY", "1")
    assert JoinSession(p=4, device="cpu").verify
    assert not JoinSession(p=4, device="cpu", verify=False).verify


def test_dataplane_learned_caps_stay_on_grid():
    q = triangle(PORT, n=120, dom=20)
    ex = DataplaneExecutor(8, device="cpu")
    prog = compiled(PORT, q=q, lam=8)
    ex.run(prog, config=RunConfig(materialize=True, verify=True))
    assert ex._learned_caps
    assert verify_caps(ex._learned_caps) > 0
    assert all(on_cap_grid(c) for chans in ex._learned_caps.values() for c in chans.values())
    ex.run(prog, config=RunConfig(materialize=True, verify=True))


def test_run_config_verify_raises_before_any_dispatch(monkeypatch):
    """A broken program under ``RunConfig(verify=True)`` raises the
    reference's rule before the executor stages a single bucket, while the
    good program passes verification and reaches the dispatch path."""
    ex = DataplaneExecutor(8, device="cpu")
    prog = compiled(PORT, lam=8)
    broken = replace(prog, ops=tuple(op for op in prog.ops
                                     if not isinstance(op, t_prog.RouteResidual)))

    def no_dispatch(*a, **kw):
        raise AssertionError("a bucket was dispatched")

    monkeypatch.setattr(DataplaneExecutor, "_run_buckets", no_dispatch)
    with pytest.raises(ProgramVerificationError) as ei:
        ex.run(broken, config=RunConfig(verify=True))
    assert (ei.value.rule, ei.value.op_round) == ("collective-stream", "step1")
    with pytest.raises(AssertionError, match="dispatched"):
        ex.run(prog, config=RunConfig(verify=True))


def test_packed_keys_the_executor_chooses_pass_the_packed_key_rule():
    """Wherever ``_pack_radices`` packs a composite key, the ``packed-key``
    rule accepts the same key space, and wherever it falls back the rule
    rejects a packed flag."""
    rng = np.random.default_rng(5)
    packed = fallback = 0
    for _ in range(300):
        n_dup = int(rng.integers(1, 4))
        hi = int(rng.choice([8, 1 << 8, 1 << 12, 1 << 20]))
        a = rng.integers(0, hi, size=(3, 5, 1 + n_dup))
        b = rng.integers(0, hi, size=(3, 4, 1 + n_dup))
        pairs = [(c, c) for c in range(1, 1 + n_dup)]
        rads = _pack_radices(a, b, pairs)
        max_cell = int(max(a[:, :, 0].max(), b[:, :, 0].max()))
        dup_maxes = [int(max(a[:, :, c].max(), b[:, :, c].max())) for c in range(1, 1 + n_dup)]
        if rads is not None:
            packed += 1
            check_packed_key(max_cell, dup_maxes, packed=True)
            assert list(rads) == [d + 1 for d in dup_maxes]
        else:
            fallback += 1
            with pytest.raises(ProgramVerificationError) as ei:
                check_packed_key(max_cell, dup_maxes, packed=True)
            assert ei.value.rule == "packed-key"
    assert packed > 20 and fallback > 20
    # a negative key component never packs, and the rule rejects it too
    a[0, 0, 1] = -1
    assert _pack_radices(a, b, pairs) is None
    with pytest.raises(ProgramVerificationError):
        check_packed_key(max_cell, [-1], packed=True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_verified_card_session_equals_cpu(cuda_device):
    q = triangle(PORT, n=400, dom=40)
    card = JoinSession(p=16, device=cuda_device, verify=True)
    cpu = JoinSession(p=16, device="cpu", verify=False)
    try:
        for _ in range(2):
            got, want = card.submit(q, lam=16), cpu.submit(q, lam=16)
            assert got.rows.tobytes() == want.rows.tobytes()
            assert got.per_h_counts == want.per_h_counts
            assert got.verify_us > 0
        assert card.stats.verified == 1
        verify_caps(card.executor._learned_caps)
    finally:
        card.close()
        cpu.close()
