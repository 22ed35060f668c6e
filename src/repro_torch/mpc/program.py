"""Round-program IR for the Theorem 6.2 join (paper Sec. 6).

``compile_plan`` turns (query, histogram, p) into a :class:`RoundProgram`: the
complete host-side plan of the constant-round algorithm — which (H, η) stages
exist, how many machines each gets, and the fixed sequence of :class:`RoundOp`s
that any execution backend must perform.  Compilation is pure metadata work
(every machine could derive it identically from the shared histogram, so it
costs zero communication); all data movement happens in an
:class:`~repro_torch.mpc.executors.Executor` that interprets the ops.

Op vocabulary (one op per logical engine phase; the simulator meters each as
one named round, see docs/DESIGN.md §7):

  ``Scatter``          even initial placement of the input relations
  ``RouteResidual``    step 1 — residual tuples of every Q'(η) to its group
  ``HashPartition``    step 2a — unary residuals hashed per border attribute,
                       then the local intersection → R''_X(η)
  ``SemiJoin``         step 2b/2c — light edges semi-joined on X then Y
  ``BroadcastSizes``   step 3 — |R''_X(η)| pieces broadcast (the O(p²) round)
  ``GridRoute``        step 3 — Lemma 3.1 CP grid × Lemma 3.3 HyperCube,
                       composed via the Lemma 3.2 matrix; one round
  ``LocalJoin``        output — local joins; each result tuple materializes on
                       exactly one machine

Program rewrites are passes over the op list: ``fuse_semijoin_pass`` replaces
the two-round semi-join with the beyond-paper fused variant (one data round
saved when a light edge's X attribute is not a border attribute).

Arbitrary-arity queries (any relation with arity ≠ 2, or ``force_general``)
compile through :func:`compile_general_plan` instead: acyclic queries get a
Yannakakis-style program — two semijoin sweeps along a GYO join tree
(``TreeSemiJoin``) followed by a HyperCube route + tree-ordered local join
chain — and cyclic queries the generalized one-round HyperCube (per-attribute
shares from the fractional edge cover LP, Beame–Koutris–Suciu) with the same
route + chain-join tail (``ShareRoute`` + ``CellJoin``).  General programs
carry a :class:`GeneralPlan` and a single :class:`GeneralStage`, flow through
the same executors/caches/verifier as binary programs, and are checked by the
``join-tree`` / ``share-exponent`` rules of :mod:`repro_torch.mpc.verify`.

``compile_plan(verify=...)`` runs the static verifier over every program it
returns.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.hypergraph import rho
from ..core.jointree import build_join_tree
from ..core.planner import (
    ConfigPlan,
    HPlanWithAlloc,
    MachineGroup,
    QueryPlan,
    _stable_base,
    step1_allocation,
    step3_allocation,
)
from ..core.query import Attr, JoinQuery
from ..core.taxonomy import (
    Configuration,
    HPlan,
    HeavyStats,
    config_feasible,
    configurations,
    plan_for_h,
    residual_size,
)
from .cartesian import CartesianGrid
from .hypercube import HyperCubeGrid, uniform_lp_shares


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RoundOp:
    """One logical phase of the constant-round algorithm."""

    @property
    def round(self) -> str:
        raise NotImplementedError


@dataclass(frozen=True)
class Scatter(RoundOp):
    """Even initial placement of every input relation (Θ(m/p) per machine).
    Costs no load in the MPC model; backends that already hold the inputs
    (e.g. because the statistics preprocessing placed them) treat it as a
    no-op.  Relations sharing a physical ``Relation.table`` (self-join-shaped
    queries, e.g. the subgraph-enumeration reduction) are placed once and
    aliased per edge — the shared-input Scatter path."""

    seed_offset: int = 17

    @property
    def round(self) -> str:
        return "scatter"


@dataclass(frozen=True)
class RouteResidual(RoundOp):
    """Step 1: every machine routes, per stage, the residual tuples of Q'(η)
    to a uniformly random virtual machine of the stage's p'_η group."""

    @property
    def round(self) -> str:
        return "step1"


@dataclass(frozen=True)
class HashPartition(RoundOp):
    """Step 2a: unary residuals (from cross edges) are hash-partitioned per
    border attribute; machines then intersect the co-located pieces into
    R''_X(η) locally."""

    @property
    def round(self) -> str:
        return "step2-unary"


@dataclass(frozen=True)
class SemiJoin(RoundOp):
    """Step 2b/2c: semi-join of the light edges against the R''_X pieces.

    ``phase`` selects the sub-round:
      * ``"x"``            route by hash(X)                    (round step2-bx)
      * ``"y"``            filter on X, route by hash(Y),
                           then filter on Y locally            (round step2-by)
      * ``"fused-route"``  fused variant: non-border-X edges go straight to
                           their Y partition                   (round step2-fused)
      * ``"fused-filter"`` border-X edges complete the detour  (round step2-by)
    """

    phase: str = "x"

    @property
    def round(self) -> str:
        return {
            "x": "step2-bx",
            "y": "step2-by",
            "fused-route": "step2-fused",
            "fused-filter": "step2-by",
        }[self.phase]


@dataclass(frozen=True)
class BroadcastSizes(RoundOp):
    """Step 3 statistics: every machine broadcasts the sizes of its R''_X
    pieces (the paper's O(p²) round); afterwards all machines agree on the
    step-3 geometry (grid dims, HyperCube shares) of every stage."""

    @property
    def round(self) -> str:
        return "step3-sizes"


@dataclass(frozen=True)
class GridRoute(RoundOp):
    """Step 3 routing: the Lemma 3.1 cartesian grid over the isolated
    R''_X lists composed with the Lemma 3.3 HyperCube over L \\ I, glued by
    the Lemma 3.2 matrix — a single communication round."""

    @property
    def round(self) -> str:
        return "step3-route"


@dataclass(frozen=True)
class LocalJoin(RoundOp):
    """Output: each machine joins its fragments locally; every result tuple
    of every stage materializes on exactly one machine (no communication)."""

    @property
    def round(self) -> str:
        return "output"


@dataclass(frozen=True)
class TreeSemiJoin(RoundOp):
    """Yannakakis semijoin sweep along the GYO join tree (general route).

    ``phase`` = ``"up"`` (leaves → root, GYO removal order: each parent is
    filtered by every child) or ``"down"`` (root → leaves, reversed order:
    each child filtered by its already-reduced parent).  After both sweeps the
    query is fully reduced — every surviving tuple contributes to the output
    (Yannakakis; Hu/Yi 1903.09717 give the MPC instance-optimal form).  Each
    tree edge is one hash-partitioned semijoin on the edge's shared attributes
    (an empty label degenerates to a non-emptiness filter — the cartesian
    stitch edge between components)."""

    phase: str = "up"

    @property
    def round(self) -> str:
        return {"up": "yan-up", "down": "yan-down"}[self.phase]


@dataclass(frozen=True)
class ShareRoute(RoundOp):
    """Generalized HyperCube route (BKS 1604.01848): every relation's tuples
    are replicated to the grid cells agreeing with their hashed coordinates,
    with per-attribute shares from the fractional edge cover LP (Π shares ≤ p,
    load m/p^{1/ρ} on skew-free data).  One communication round; each result
    tuple is assembled at exactly one cell."""

    @property
    def round(self) -> str:
        return "hc-route"


@dataclass(frozen=True)
class CellJoin(RoundOp):
    """Output round of the general route: each cell joins its co-located
    fragments through a chain of local joins — ordered by the join tree for
    acyclic queries, by shared-attribute greedy order for cyclic ones — with
    every attribute a grid dimension, so each result tuple materializes on
    exactly one machine (no communication)."""

    @property
    def round(self) -> str:
        return "output"


DEFAULT_OPS: Tuple[RoundOp, ...] = (
    Scatter(),
    RouteResidual(),
    HashPartition(),
    SemiJoin(phase="x"),
    SemiJoin(phase="y"),
    BroadcastSizes(),
    GridRoute(),
    LocalJoin(),
)

GENERAL_ACYCLIC_OPS: Tuple[RoundOp, ...] = (
    Scatter(),
    TreeSemiJoin(phase="up"),
    TreeSemiJoin(phase="down"),
    ShareRoute(),
    CellJoin(),
)

GENERAL_CYCLIC_OPS: Tuple[RoundOp, ...] = (
    Scatter(),
    ShareRoute(),
    CellJoin(),
)


# ---------------------------------------------------------------------------
# Stages + program
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StageSignature:
    """Compile-time batching signature of a stage (bucket-signature metadata).

    Two stages with equal signatures perform structurally identical work in
    every round — same light/cross edge shapes, same border and isolated
    attribute counts — differing only in η values and data sizes.  The
    stage-batched :class:`~repro_torch.mpc.executors.DataplaneExecutor` groups work
    finer than this (adding run-time geometry and pow2 capacities), but the
    signature is the IR-level upper bound on how many compiled variants a
    program can need: O(#signatures), never O(#stages)."""

    h_set: Tuple[Attr, ...]
    light_edges: Tuple[Tuple[Attr, ...], ...]
    cross_edges: Tuple[Tuple[Attr, ...], ...]
    border: Tuple[Attr, ...]
    isolated: Tuple[Attr, ...]


@dataclass
class ProgramStage:
    """One (H, η) configuration with its machine allocation.

    ``cfg`` carries the step-1 group at compile time; the step-3 geometry is
    filled in at run time by :func:`stage_geometry` once the R''_X sizes are
    known (they depend on the data, not the histogram)."""

    plan: HPlan
    cfg: ConfigPlan

    @property
    def hkey(self) -> Tuple[Attr, ...]:
        return self.plan.h_set

    @property
    def ekey(self) -> Tuple[int, ...]:
        return self.cfg.eta.values

    @property
    def signature(self) -> StageSignature:
        """The stage's compile-time batching signature (see
        :class:`StageSignature`)."""
        return StageSignature(
            h_set=tuple(self.plan.h_set),
            light_edges=tuple(
                tuple(sorted(e)) for e in self.plan.light_edges
            ),
            cross_edges=tuple(
                tuple(sorted(e)) for e in self.plan.cross_edges
            ),
            border=tuple(sorted(self.plan.border)),
            isolated=tuple(sorted(self.plan.isolated)),
        )


@dataclass(frozen=True)
class GeneralPlan:
    """Structure of a general (arbitrary-arity) program.

    ``kind`` is ``"yannakakis"`` (acyclic: semijoin sweeps + routed join) or
    ``"hypercube"`` (cyclic: one-round generalized shares).  ``tree_edges``
    lists the join tree's (child, parent, shared attrs) in GYO removal order
    (the valid up-sweep order; the down sweep is its exact reverse — the
    ``join-tree`` verify rule re-checks both).  ``join_order`` is the relation
    order of the CellJoin chain (a pre-order of the tree for acyclic queries,
    so each joined relation is adjacent to the already-joined set).
    ``shares`` are the per-attribute HyperCube shares from the fractional edge
    cover LP, with Π shares ≤ p (the ``share-exponent`` verify rule)."""

    kind: str
    tree_root: int
    tree_edges: Tuple[Tuple[int, int, Tuple[Attr, ...]], ...]
    join_order: Tuple[int, ...]
    shares: Tuple[Tuple[Attr, int], ...]

    @property
    def shares_dict(self) -> Dict[Attr, int]:
        return dict(self.shares)


@dataclass
class GeneralStage:
    """The single pseudo-stage a general program carries.

    Duck-typed to the :class:`ProgramStage` surface the stage-batched executor
    reads (``hkey``/``ekey``/``signature``; ``plan`` is None — there is no
    binary (H, η) taxonomy behind it).  ``struct`` pins the query structure so
    salts and retry groups derived from the stage key are deterministic."""

    kind: str
    struct: Tuple

    plan = None

    @property
    def hkey(self) -> Tuple[Attr, ...]:
        return ("*",)

    @property
    def ekey(self) -> Tuple[int, ...]:
        return ()

    @property
    def signature(self) -> Tuple:
        return ("general", self.kind, self.struct)


@dataclass
class RoundProgram:
    """A compiled Theorem 6.2 instance: stages + op sequence + emit tuples.

    Attributes:
        query: the query this program is currently bound to (swap the data
            with :meth:`rebind` — compilation never read it).
        p / lam / rho_val: machine count, heavy parameter, edge-cover number.
        stats: the histogram the plan was compiled against.
        stages: one :class:`ProgramStage` per surviving (H, η) configuration.
        emit: the H = attset(Q) results (η itself is the result tuple; zero
            communication) as (machine, row over ``out_cols``) pairs;
            ``emit_counts`` their per-H totals.
        ops: the fixed :class:`RoundOp` sequence every backend interprets;
            ``fused`` records whether ``fuse_semijoin_pass`` rewrote it.

    Programs are immutable execution artifacts: compile once, execute on any
    backend any number of times (executors copy per-run state out of the
    stages), cache across queries under :func:`plan_cache_key`.
    """

    query: JoinQuery
    p: int
    lam: int
    rho_val: float
    stats: HeavyStats
    stages: List[ProgramStage]
    emit: List[Tuple[int, np.ndarray]]
    emit_counts: Dict[Tuple[Attr, ...], int]
    ops: Tuple[RoundOp, ...] = DEFAULT_OPS
    fused: bool = False
    general: Optional[GeneralPlan] = None

    @property
    def out_cols(self) -> Tuple[Attr, ...]:
        return tuple(self.query.attset)

    @property
    def round_names(self) -> List[str]:
        return [op.round for op in self.ops]

    def op_sequence(self) -> List[str]:
        """Compact human/test-readable op listing, e.g. ['Scatter', ...]."""
        out = []
        for op in self.ops:
            name = type(op).__name__
            if isinstance(op, (SemiJoin, TreeSemiJoin)):
                name += f"[{op.phase}]"
            out.append(name)
        return out

    def bucket_histogram(self) -> Dict["StageSignature", int]:
        """Stage count per compile-time batching signature — the IR-level
        view of how a stage-batched executor will bucket this program (the
        bench and the scheduler-observability tests read it)."""
        out: Dict[StageSignature, int] = {}
        for st in self.stages:
            sig = st.signature
            out[sig] = out.get(sig, 0) + 1
        return out

    def rebind(self, query: JoinQuery) -> "RoundProgram":
        """Return a copy of this compiled program bound to ``query``'s data.

        Sound exactly when ``plan_cache_key(query, self.stats, self.p, ...)``
        equals the key this program was compiled under: compilation is a pure
        function of (query structure, histogram, p) — see
        :func:`plan_cache_key` — so the stages, emits, and op list can be
        shared verbatim and only the relation data behind the plan changes.
        The cross-query plan cache of :class:`repro_torch.mpc.service.JoinSession`
        is built on this."""
        return replace(self, query=query)

    def query_plan(self) -> QueryPlan:
        """Group the stages back into the planner's per-H view."""
        h_plans: Dict[Tuple[Attr, ...], HPlanWithAlloc] = {}
        for st in self.stages:
            h_plans.setdefault(st.hkey, HPlanWithAlloc(plan=st.plan)).configs.append(
                st.cfg
            )
        return QueryPlan(
            p=self.p, lam=self.lam, rho_val=self.rho_val, h_plans=h_plans
        )


# ---------------------------------------------------------------------------
# Run configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RunConfig:
    """Per-run execution knobs threaded through ``Executor.run_many``.

    Separates *what* runs (the :class:`RoundProgram`, cached and reused
    across queries) from *how this particular run* behaves — so deadlines
    and fault plans never leak into plan cache keys or coalesce signatures.

    Attributes:
        materialize: gather output rows to host (False = sizes only).
        deadline: absolute ``time.monotonic()`` instant after which the
            executor raises ``DeadlineExceededError``.  Checked *between*
            dispatches only, so overshoot is bounded by one bucket dispatch.
            None = no budget.
        fault_plan: a ``repro_torch.mpc.faults.FaultPlan`` consulted at the
            executor's injection sites for this run, overriding any plan the
            executor itself was constructed with.  None = use the
            executor's own (which defaults to no injection).
        verify: re-run the static verifier (``repro_torch.mpc.verify``) over
            every program of this run — including the executor's
            learned-caps store — before any kernel is launched.  Off by
            default; compile-time verification is governed separately by
            ``compile_plan(verify=...)`` / the ``REPRO_VERIFY`` env var.
        table_digests: one tuple per program of its relations'
            :func:`~repro_torch.core.query.relation_digests`, taken by a
            caller that has hashed the bound tables already (the service,
            before its statistics).  None = the executor hashes them.
    """

    materialize: bool = True
    deadline: Optional[float] = None
    fault_plan: Optional[object] = None
    verify: bool = False
    table_digests: Optional[Sequence[Tuple[bytes, ...]]] = None


def _verify_default() -> bool:
    """Resolve compile-time verification from the ``REPRO_VERIFY`` env var
    (the test suite's conftest turns it on for every test)."""
    return os.environ.get("REPRO_VERIFY", "0").strip().lower() not in (
        "", "0", "false", "off",
    )


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------


def _general_join_order(
    schemes: Sequence[Tuple[Attr, ...]],
    tree_edges: Sequence[Tuple[int, int, Tuple[Attr, ...]]],
    root: int,
) -> Tuple[int, ...]:
    """Relation order of the CellJoin chain.

    Acyclic (tree present): pre-order of the join tree, lowest child index
    first — every joined relation is tree-adjacent to the already-joined set,
    so each chain step is a real join on the tree edge's shared attributes.
    Cyclic: greedy connected order — start at relation 0, repeatedly take the
    lowest-index remaining relation sharing an attribute with the covered set
    (falling back to the lowest index for a disconnected component)."""
    n = len(schemes)
    if n == 1:
        return (0,)
    if tree_edges:
        children: Dict[int, List[int]] = {}
        for c, parent, _ in tree_edges:
            children.setdefault(parent, []).append(c)
        order: List[int] = []
        stack = [root]
        while stack:
            node = stack.pop()
            order.append(node)
            stack.extend(sorted(children.get(node, []), reverse=True))
        return tuple(order)
    order = [0]
    covered = set(schemes[0])
    remaining = [i for i in range(1, n)]
    while remaining:
        nxt = next(
            (i for i in remaining if covered & set(schemes[i])), remaining[0]
        )
        remaining.remove(nxt)
        order.append(nxt)
        covered |= set(schemes[nxt])
    return tuple(order)


def compile_general_plan(
    query: JoinQuery,
    stats: HeavyStats,
    p: int,
    verify: Optional[bool] = None,
) -> RoundProgram:
    """Compile an arbitrary-arity query into a general :class:`RoundProgram`.

    Acyclic queries (GYO-reducible) get the Yannakakis program: an up + down
    :class:`TreeSemiJoin` sweep along the join tree (a full reducer — every
    surviving tuple contributes), then a :class:`ShareRoute` over *all*
    attributes and a tree-ordered :class:`CellJoin` chain.  Cyclic queries
    skip the sweeps: the generalized HyperCube shares (fractional edge cover
    LP exponents, Π shares ≤ p) bound the per-cell load by m/p^{1/ρ} on
    skew-free data, and the same route + chain tail assembles the output.
    Every attribute is a grid dimension (share-1 attributes collapse to
    coordinate 0), so each result tuple materializes at exactly one cell —
    the exactly-once emission the differential harness locks."""
    rho_val = float(rho(query))
    schemes = [r.scheme for r in query.relations]
    tree = build_join_tree([frozenset(s) for s in schemes])
    shares = uniform_lp_shares(query.hypergraph, p)
    shares_t = tuple(sorted((a, int(s)) for a, s in shares.items()))
    if tree is not None:
        kind = "yannakakis"
        root = tree.root
        tree_edges = tuple(
            (c, par, tuple(sorted(shared))) for c, par, shared in tree.edges
        )
        ops = GENERAL_ACYCLIC_OPS
    else:
        kind = "hypercube"
        root = 0
        tree_edges = ()
        ops = GENERAL_CYCLIC_OPS
    join_order = _general_join_order(schemes, tree_edges, root)
    plan = GeneralPlan(
        kind=kind,
        tree_root=root,
        tree_edges=tree_edges,
        join_order=join_order,
        shares=shares_t,
    )
    stage = GeneralStage(
        kind=kind,
        struct=(tuple(schemes), tree_edges, root, join_order, shares_t),
    )
    program = RoundProgram(
        query=query,
        p=p,
        lam=stats.lam,
        rho_val=rho_val,
        stats=stats,
        stages=[stage],
        emit=[],
        emit_counts={},
        ops=ops,
        general=plan,
    )
    if _verify_default() if verify is None else verify:
        from .verify import verify_program  # local: verify imports this module

        verify_program(program)
    return program


def compile_plan(
    query: JoinQuery,
    stats: HeavyStats,
    p: int,
    h_subsets: Optional[Sequence[Sequence[Attr]]] = None,
    fuse_semijoin: bool = False,
    verify: Optional[bool] = None,
) -> RoundProgram:
    """Compile the full H-taxonomy of ``query`` into a :class:`RoundProgram`.

    Absorbs all host-side planning of the engine: H enumeration, per-η
    inactive-edge feasibility (from the extended histogram — ruled-out η cost
    no communication), residual sizing, step-1 machine allocation, and the
    H = attset(Q) emit set.  ``h_subsets`` restricts the taxonomy (testing).

    ``verify`` runs the static verifier (``repro_torch.mpc.verify``) over the
    compiled program before returning it; None defers to the ``REPRO_VERIFY``
    env var (on in the test suite, off by default — the service layer times
    its own verification pass).

    Arbitrary-arity queries (``query.is_general``) compile through
    :func:`compile_general_plan`.
    """
    if query.is_general:
        # arbitrary-arity route: h_subsets/fuse_semijoin are binary-taxonomy
        # knobs with no general counterpart — the general compiler ignores
        # them (plan_cache_key keeps the keyspaces apart via is_general).
        return compile_general_plan(query, stats, p, verify=verify)

    attset = query.attset
    k = len(attset)
    rho_val = float(rho(query))

    if h_subsets is None:
        h_subsets = [
            h for r in range(k + 1) for h in itertools.combinations(attset, r)
        ]

    stages: List[ProgramStage] = []
    emit: List[Tuple[int, np.ndarray]] = []
    emit_counts: Dict[Tuple[Attr, ...], int] = {}
    out_cols = list(attset)

    for h in h_subsets:
        plan = plan_for_h(query, h)
        cfg_sizes: List[Tuple[Configuration, int]] = []
        for eta in configurations(stats, plan.h_set):
            if not config_feasible(query, stats, plan, eta):
                continue
            if len(plan.h_set) == k:
                # every edge inactive; η itself is the result tuple (no comm).
                mid = _stable_base(p, "emit", plan.h_set, eta.values)
                row = np.array([[eta.value(a) for a in out_cols]], dtype=np.int64)
                emit.append((mid, row))
                emit_counts[plan.h_set] = emit_counts.get(plan.h_set, 0) + 1
                continue
            m_eta = residual_size(query, stats, plan, eta)
            if m_eta == 0 and (plan.light_edges or plan.cross_edges):
                # some active edge has empty residual input ⇒ empty join.
                continue
            cfg_sizes.append((eta, m_eta))
        for cfg in step1_allocation(query, stats, plan, cfg_sizes, p):
            stages.append(ProgramStage(plan=plan, cfg=cfg))

    program = RoundProgram(
        query=query,
        p=p,
        lam=stats.lam,
        rho_val=rho_val,
        stats=stats,
        stages=stages,
        emit=emit,
        emit_counts=emit_counts,
        ops=DEFAULT_OPS,
    )
    if fuse_semijoin:
        program = fuse_semijoin_pass(program)
    if _verify_default() if verify is None else verify:
        from .verify import verify_program  # local: verify imports this module

        verify_program(program)
    return program


# ---------------------------------------------------------------------------
# Canonical plan keys (cross-query plan/compile reuse)
# ---------------------------------------------------------------------------


def histogram_signature(stats: HeavyStats) -> Tuple:
    """Hashable canonical form of a histogram — the data-side half of a plan
    cache key.

    Two instances with equal signatures have *identical* extended histograms
    (λ, m, heavy-value sets, and every cond/pair/light_cnt record), which is
    everything :func:`compile_plan` reads from the data.  Equal signature +
    equal query structure therefore implies an identical compiled program —
    the invariant the service-layer plan cache relies on (docs/design/
    09-service.md)."""
    return (
        stats.lam,
        stats.m,
        tuple(sorted((a, tuple(v.tolist())) for a, v in stats.heavy.items())),
        tuple(
            sorted(
                (tuple(sorted(e)), a, x, c) for (e, a, x), c in stats.cond.items()
            )
        ),
        tuple(
            sorted(
                (tuple(sorted(e)), x, y, c) for (e, x, y), c in stats.pair.items()
            )
        ),
        tuple(sorted((tuple(sorted(e)), c) for e, c in stats.light_cnt.items())),
    )


def plan_cache_key(
    query: JoinQuery,
    stats: HeavyStats,
    p: int,
    h_subsets: Optional[Sequence[Sequence[Attr]]] = None,
    fuse_semijoin: bool = False,
) -> Tuple:
    """Canonical cache key under which :func:`compile_plan` is a pure function.

    The key captures every compile-time input: the query *structure* (relation
    schemes in relation order, plus which relations alias one physical
    ``Relation.table`` — the shared-input Scatter classes), the machine count,
    the taxonomy restriction, the fusion flag, and the full
    :func:`histogram_signature`.  Concrete tuples are deliberately absent:
    two instances with equal keys compile to the same program, so a cached
    program may be :meth:`RoundProgram.rebind`-ed onto fresh data.  A shifted
    histogram (new heavy values, changed counts) changes the signature and
    therefore simply *misses* — stale plans age out of the service LRU rather
    than being invalidated in place."""
    alias: Dict[str, int] = {}
    struct = []
    for rel in query.relations:
        tid = None
        if rel.table is not None:
            tid = alias.setdefault(rel.table, len(alias))
        struct.append((rel.scheme, tid))
    hs = (
        None
        if h_subsets is None
        else tuple(tuple(sorted(h)) for h in h_subsets)
    )
    return (
        tuple(struct),
        bool(query.force_general),
        p,
        hs,
        bool(fuse_semijoin),
        histogram_signature(stats),
    )


def coalesce_signature(program: RoundProgram) -> Tuple:
    """Bucket-layer compatibility key for cross-query coalescing.

    Two compiled programs with equal signatures run the *same op sequence*
    over the *same machine count*, which is exactly what
    :meth:`StageBatchedDataplaneExecutor.run_many` requires to drive several
    programs through one scheduling pass: each op lowers every program's
    stages into one shared work-item round, and stages whose geometry buckets
    coincide fuse into one stacked dispatch.  The bucket histogram rides
    along so schedulers (and the service drainer) can see *how much* fusion
    to expect: equal histograms mean the stacked round has the same bucket
    population as replaying one program ``k`` times — the perfect-fusion
    case — while differing histograms still coalesce, just with partially
    shared buckets.

    Deliberately coarser than :func:`plan_cache_key`: data identity, heavy
    value sets, and λ are absent, because the stage axis is data-blind —
    only op order and block geometry decide whether dispatches merge."""
    return (
        program.p,
        tuple(program.op_sequence()),
        tuple(sorted(
            ((sig, n) for sig, n in program.bucket_histogram().items()),
            key=repr,
        )),
    )


def programs_coalescible(a: RoundProgram, b: RoundProgram) -> bool:
    """True when ``a`` and ``b`` may share one batched scheduling pass.

    The hard requirement (checked again by ``run_many``) is identical op
    sequences on identical ``p``; the histogram component of
    :func:`coalesce_signature` additionally demands matching bucket shapes,
    which is the profitable case — so this predicate is the service
    drainer's grouping rule, not merely the executor's legality rule."""
    return coalesce_signature(a) == coalesce_signature(b)


def fuse_semijoin_pass(program: RoundProgram) -> RoundProgram:
    """Program rewrite: replace SemiJoin[x] + SemiJoin[y] with the fused pair.

    The fused route sends each light tuple whose X attribute is *not* a border
    attribute straight to its Y partition (no X-membership to resolve), saving
    one full data round for those edges; border-X edges keep the two-hop
    detour.  Correctness is unchanged — the rewrite only reorders routing (see
    EXPERIMENTS §Perf and tests/test_engine_fusion.py)."""
    ops: List[RoundOp] = []
    i = 0
    seq = list(program.ops)
    while i < len(seq):
        op = seq[i]
        if (
            isinstance(op, SemiJoin)
            and op.phase == "x"
            and i + 1 < len(seq)
            and isinstance(seq[i + 1], SemiJoin)
            and seq[i + 1].phase == "y"
        ):
            ops.append(SemiJoin(phase="fused-route"))
            ops.append(SemiJoin(phase="fused-filter"))
            i += 2
            continue
        ops.append(op)
        i += 1
    return replace(program, ops=tuple(ops), fused=True)


# ---------------------------------------------------------------------------
# Run-time geometry (shared by all executors)
# ---------------------------------------------------------------------------


@dataclass
class StageGeometry:
    """Step-3 geometry of one stage, derived from the broadcast |R''_X| sizes.

    Identical on every machine (a pure function of broadcast data), so any
    backend may compute it host-side without extra communication.  It is
    per-*run* state: the compiled program (and its ``ConfigPlan``s) is never
    mutated, so one program can be executed concurrently by many executors."""

    iso_order: List[Attr] = field(default_factory=list)  # isolated attrs, size desc
    iso_sizes: Dict[Attr, int] = field(default_factory=dict)
    offsets: Dict[Tuple[Attr, int], int] = field(default_factory=dict)
    grid: Optional[CartesianGrid] = None
    hc_grid: Optional[HyperCubeGrid] = None
    step3_group: Optional[MachineGroup] = None
    skip: bool = False

    # -- Lemma 3.2 composition (shared by every backend) ---------------------

    @property
    def hc_size(self) -> int:
        return self.hc_grid.size if self.hc_grid else 1

    @property
    def cp_size(self) -> int:
        return self.grid.size if self.grid else 1

    def cell(self, cp_cell: int, hc_cell: int) -> int:
        """Virtual machine id of (CP row, HyperCube column): the Lemma 3.2
        matrix flattened row-major.  Both executors route through this one
        composition rule."""
        return cp_cell * self.hc_size + hc_cell


def stage_geometry(
    program: RoundProgram,
    stage: ProgramStage,
    piece_entries: Dict[Attr, List[Tuple[int, int]]],
) -> StageGeometry:
    """Finalize a stage's step-3 allocation from the broadcast piece sizes.

    ``piece_entries[x]`` lists (machine, count) for attribute x's R''_X
    pieces; ids are offset in sorted-machine order so every backend assigns
    the same global ids.  Runs :func:`~repro_torch.core.planner.step3_allocation`
    on a *copy* of the stage's ``ConfigPlan`` (the shared program stays
    immutable) and builds the CP / HyperCube grids of Lemma 6.1."""
    geo = StageGeometry()
    plan = stage.plan
    for x in plan.isolated:
        entries = sorted(piece_entries.get(x, []))
        total = sum(c for _, c in entries)
        geo.iso_sizes[x] = total
        off = 0
        for mid, c in entries:
            geo.offsets[(x, mid)] = off
            off += c
    if any(v == 0 for v in geo.iso_sizes.values()):
        geo.skip = True
        return geo
    cfg = replace(stage.cfg)
    step3_allocation(
        program.query,
        program.stats,
        plan,
        cfg,
        geo.iso_sizes,
        program.p,
        program.rho_val,
    )
    geo.step3_group = cfg.step3_group
    geo.iso_order = sorted(plan.isolated, key=lambda a: -geo.iso_sizes[a])
    if geo.iso_order:
        geo.grid = CartesianGrid(
            [geo.iso_sizes[a] for a in geo.iso_order], cfg.cp_machines
        )
    l_minus_i = [a for a in plan.light if a not in plan.isolated]
    if l_minus_i:
        geo.hc_grid = HyperCubeGrid(
            l_minus_i, {a: program.stats.lam for a in l_minus_i}
        )
    return geo
