"""Static verification of compiled RoundPrograms (docs/design/11-verification.md).

A verification pass runs entirely host-side — no device, no collective, no
relation data movement — and either returns a :class:`VerificationReport` or
raises a typed :class:`~repro_torch.mpc.faults.ProgramVerificationError` carrying
``(op_round, rule, detail)``.  The rules:

  ``scatter-binding``    every relation's data matches its scheme arity; all
                         relations declaring one physical ``Relation.table``
                         bind the same rows (the shared-input alias classes
                         Scatter places once); emit tuples target machines
                         in [0, p) with the right width.
  ``semijoin-fusion``    the SemiJoin phases are exactly ("x", "y") or, when
                         ``program.fused``, ("fused-route", "fused-filter")
                         *and* the fused op list is the exact image of
                         :func:`~repro_torch.mpc.program.fuse_semijoin_pass`.
  ``grid-invariants``    machine groups live on [0, p) with stable-hash
                         bases; step-1 group sizes match the allocation
                         formula; recorded m_η equals the recomputed residual
                         size; CP grids respect the Lemma 3.1 budget
                         Π(grid_dims) ≤ p; the Lemma 3.2 composition matrix
                         has ≤ |step-3 group| cells and flattens row-major.
  ``cap-grid``           every learned capacity sits on the {2^k, 3·2^(k-1)}
                         quantization grid (≥ 16) that keeps the executable
                         signature count bounded.
  ``packed-key``         packed int32 composite keys only when the
                         mixed-radix space (max_cell+1)·Π(max_dup+1) fits
                         INT32_MAX; grid-route cell spaces stay < 2^31.
  ``collective-stream``  the op sequence admits exactly one strictly-serial
                         collective order — each collective op appears
                         exactly once, in canonical phase order (two
                         collectives in flight deadlock; a missing one
                         starves every downstream round).
  ``load-bound``         (``check_load``, needs a metered run) every measured
                         round load is ≤ the symbolic model bound of
                         :mod:`repro_torch.analysis.loadmodel` — the Theorem 6.2
                         Õ(m/p^{1/ρ}) promise as an executable assertion.
  ``join-tree``          (general programs) the compiled join tree is real:
                         full-intersection edge labels, running intersection,
                         leaves-first sweep order, pre-order CellJoin chain,
                         and no acyclic query demoted to the cyclic route.
  ``share-exponent``     (general programs) HyperCube shares are positive
                         ints over exactly the output attributes, Π ≤ p, and
                         equal the fractional-edge-cover LP solution.

General programs (``program.general`` set) swap the binary-taxonomy rules
(semijoin-fusion, grid-invariants) for ``join-tree`` + ``share-exponent`` and
a general ``collective-stream`` check; scatter-binding and cap-grid apply to
both routes unchanged.

``verify_program`` runs every static rule (everything but ``load-bound``).
``verify_bindings`` is the cheap warm-path subset: a plan-cache hit rebinds a
verified plan onto fresh data, so only the binding-dependent checks need to
re-run (the service's cache-hit path calls exactly this).
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..analysis.loadmodel import MODEL_CONSTANT, round_bounds_by_name
from ..core.jointree import JoinTree, build_join_tree, running_intersection_ok
from ..core.planner import _stable_base
from ..core.taxonomy import residual_size
from .faults import ProgramVerificationError
from .hypercube import uniform_lp_shares
from .program import (
    GENERAL_ACYCLIC_OPS,
    GENERAL_CYCLIC_OPS,
    BroadcastSizes,
    GridRoute,
    HashPartition,
    LocalJoin,
    RoundProgram,
    RouteResidual,
    Scatter,
    SemiJoin,
    StageGeometry,
    fuse_semijoin_pass,
    stage_geometry,
)

#: Every rule a verification pass can fail with (ProgramVerificationError.rule).
RULES = (
    "scatter-binding",
    "semijoin-fusion",
    "grid-invariants",
    "cap-grid",
    "packed-key",
    "collective-stream",
    "load-bound",
    "join-tree",
    "share-exponent",
)

#: Cell-id space limit of the packed grid-route path (mirrors the
#: ``_lower_grid_route`` guard in executors.py).
INT32_CELLS = 1 << 31

_INT32_MAX = int(np.iinfo(np.int32).max)


def _fail(rule: str, op_round: Optional[str], detail: str) -> None:
    raise ProgramVerificationError(
        f"[{rule}] {op_round or 'program'}: {detail}",
        op_round=op_round,
        rule=rule,
        detail=detail,
    )


class VerificationReport:
    """What a successful pass covered (``repr`` shows up in CI logs)."""

    def __init__(self, p: int, stages: int, checks: int, geometry_probes: int):
        self.p = p
        self.stages = stages
        self.checks = checks
        self.geometry_probes = geometry_probes
        self.rules = RULES

    def __repr__(self) -> str:
        return (
            f"VerificationReport(p={self.p}, stages={self.stages}, "
            f"checks={self.checks}, geometry_probes={self.geometry_probes})"
        )


# ---------------------------------------------------------------------------
# collective-stream + semijoin-fusion: the op sequence
# ---------------------------------------------------------------------------

_OP_ORDER = {
    Scatter: 0,
    RouteResidual: 1,
    HashPartition: 2,
    SemiJoin: 3,
    BroadcastSizes: 4,
    GridRoute: 5,
    LocalJoin: 6,
}

#: Ops that must appear exactly once for a serial collective order to exist.
_SINGLETONS = (Scatter, RouteResidual, HashPartition, BroadcastSizes, GridRoute, LocalJoin)


def _check_op_stream(program: RoundProgram) -> int:
    """``collective-stream``: exactly-once collectives in canonical order."""
    last = -1
    counts: Dict[type, int] = {}
    for op in program.ops:
        rank = _OP_ORDER.get(type(op))
        if rank is None:
            _fail("collective-stream", getattr(op, "round", None),
                  f"unknown op {type(op).__name__} has no place in the serial collective order")
        if rank < last:
            _fail("collective-stream", op.round,
                  f"{type(op).__name__} is scheduled after a later phase — two collectives "
                  f"could be in flight at once (a deadlock)")
        last = rank
        counts[type(op)] = counts.get(type(op), 0) + 1
    for cls in _SINGLETONS:
        n = counts.get(cls, 0)
        if n == 0:
            _fail("collective-stream", cls().round,
                  f"{cls.__name__} is missing: downstream rounds would consume data that "
                  f"was never routed")
        if n > 1:
            _fail("collective-stream", cls().round,
                  f"{cls.__name__} appears {n} times: the op list admits no strictly-serial "
                  f"collective order")
    return len(program.ops) + len(_SINGLETONS)


def _check_semijoin_fusion(program: RoundProgram) -> int:
    """``semijoin-fusion``: phase pair legality + fuse-pass re-derivability."""
    phases = [op.phase for op in program.ops if isinstance(op, SemiJoin)]
    want = ["fused-route", "fused-filter"] if program.fused else ["x", "y"]
    if phases != want:
        _fail("semijoin-fusion", "step2-bx",
              f"SemiJoin phases {phases} do not form the legal pair {want} "
              f"(fused={program.fused})")
    if program.fused:
        unfused = tuple(
            SemiJoin(phase="x") if isinstance(op, SemiJoin) and op.phase == "fused-route"
            else SemiJoin(phase="y") if isinstance(op, SemiJoin) and op.phase == "fused-filter"
            else op
            for op in program.ops
        )
        refused = fuse_semijoin_pass(replace(program, ops=unfused, fused=False))
        if tuple(refused.ops) != tuple(program.ops):
            _fail("semijoin-fusion", "step2-fused",
                  "fused op list is not the image of fuse_semijoin_pass over its unfused "
                  "form — the rewrite cannot be re-verified")
    return 2


# ---------------------------------------------------------------------------
# scatter-binding: the warm-path (rebind) subset
# ---------------------------------------------------------------------------


def verify_bindings(program: RoundProgram) -> int:
    """The binding-dependent checks (rule ``scatter-binding``) — everything a
    plan-cache hit must re-establish after :meth:`RoundProgram.rebind`.

    O(#relations + #emits) plus one row comparison per shared-table alias
    pair; deliberately cheap enough for the service's warm path.  Returns the
    number of checks performed."""
    q = program.query
    if q is None:
        _fail("scatter-binding", "scatter",
              "program is not bound to a query (cache entries strip the data; "
              "rebind before verifying bindings)")
    if program.p < 1:
        _fail("scatter-binding", "scatter", f"p={program.p} < 1")
    checks = 2
    first_for_table: Dict[str, Tuple[int, object]] = {}
    for i, rel in enumerate(q.relations):
        d = rel.data
        if d.ndim != 2 or d.shape[1] != len(rel.scheme):
            _fail("scatter-binding", "scatter",
                  f"relation {i} {rel.scheme}: data shape {d.shape} does not match "
                  f"scheme arity {len(rel.scheme)}")
        checks += 1
        if rel.table is None:
            continue
        prev = first_for_table.setdefault(rel.table, (i, rel))
        if prev[1] is rel:
            continue
        pd = prev[1].data
        # Scatter places each physical table once and aliases it per edge, so
        # every relation of an alias class must bind identical rows.  Arrays
        # need not be the same object (Relation.make dedups into fresh
        # arrays) — compare contents.
        if pd is not d and (
            pd.shape != d.shape or pd.dtype != d.dtype or not np.array_equal(pd, d)
        ):
            _fail("scatter-binding", "scatter",
                  f"relations {prev[0]} and {i} both declare table {rel.table!r} "
                  f"but bind different data — the shared-input Scatter would place "
                  f"one and silently drop the other")
        checks += 1
    width = len(program.out_cols)
    for mid, row in program.emit:
        if not (0 <= mid < program.p):
            _fail("scatter-binding", "output",
                  f"emit targets machine {mid} outside [0, {program.p})")
        if row.ndim != 2 or row.shape[1] != width:
            _fail("scatter-binding", "output",
                  f"emit row block has shape {row.shape}, want (*, {width})")
        checks += 1
    return checks


# ---------------------------------------------------------------------------
# grid-invariants + packed-key: allocations and geometry
# ---------------------------------------------------------------------------


def check_stage_geometry(geo: StageGeometry, p: int, op_round: str = "step3-route") -> int:
    """Lemma 3.1 / 3.2 invariants of one finalized stage geometry."""
    if geo.skip:
        return 1
    checks = 0
    grp = geo.step3_group
    if grp is not None:
        if grp.p != p or not (0 <= grp.base < p) or grp.size < 1:
            _fail("grid-invariants", op_round,
                  f"step-3 group (base={grp.base}, size={grp.size}, p={grp.p}) is not "
                  f"a valid virtual group over {p} machines")
        checks += 1
    if geo.grid is not None:
        g = geo.grid
        prod = 1
        for d in g.dims:
            if d < 1:
                _fail("grid-invariants", op_round, f"CP grid dimension {d} < 1")
            prod *= int(d)
        if prod > g.p:
            _fail("grid-invariants", op_round,
                  f"Π(grid_dims)={prod} exceeds the Lemma 3.1 machine budget {g.p}")
        if prod != g.size:
            _fail("grid-invariants", op_round,
                  f"CartesianGrid.size={g.size} disagrees with Π(grid_dims)={prod}")
        checks += 3
    cells = geo.cp_size * geo.hc_size
    if grp is not None and cells > grp.size:
        _fail("grid-invariants", op_round,
              f"the Lemma 3.2 composition matrix has {cells} cells but the step-3 "
              f"group only has {grp.size} machines")
    if cells >= INT32_CELLS:
        _fail("packed-key", op_round,
              f"cell space {cells} ≥ 2^31: packed int32 cell ids would overflow "
              f"(the _lower_grid_route guard would reject this at run time)")
    for cp in {0, geo.cp_size - 1}:
        for hc in {0, geo.hc_size - 1}:
            if geo.cell(cp, hc) != cp * geo.hc_size + hc:
                _fail("grid-invariants", op_round,
                      f"cell({cp}, {hc}) = {geo.cell(cp, hc)} is not the row-major "
                      f"Lemma 3.2 flattening {cp * geo.hc_size + hc}")
            checks += 1
    return checks + 2


def _check_stages(program: RoundProgram) -> Tuple[int, int]:
    """Per-stage allocation checks + synthetic geometry probes.

    Geometry depends only on (stage signature, m_η) for a fixed program, so
    probes are deduplicated on that key — stage counts can be large (one per
    surviving η) while distinct geometries stay O(#signatures)."""
    p = program.p
    stats = program.stats
    if stats.lam != program.lam:
        _fail("grid-invariants", "step1",
              f"program.lam={program.lam} disagrees with stats.lam={stats.lam}")
    k = len(program.query.attset)
    denom = max(1.0, float(stats.m) * float(stats.lam) ** max(0, k - 2))
    checks, probes = 1, 0
    probed = set()
    for st in program.stages:
        cfg = st.cfg
        grp = cfg.step1_group
        if grp.p != p or not (0 <= grp.base < p) or not (1 <= grp.size <= p):
            _fail("grid-invariants", "step1",
                  f"stage (H={st.plan.h_set}, η={cfg.eta.values}): step-1 group "
                  f"(base={grp.base}, size={grp.size}, p={grp.p}) is not a valid "
                  f"virtual group over {p} machines")
        if grp.base != _stable_base(p, "s1", st.plan.h_set, cfg.eta.values):
            _fail("grid-invariants", "step1",
                  f"stage (H={st.plan.h_set}, η={cfg.eta.values}): step-1 group base "
                  f"{grp.base} disagrees with the stable hash — senders and receivers "
                  f"would disagree on the group")
        m_eta = residual_size(program.query, stats, st.plan, cfg.eta)
        if m_eta != cfg.m_eta:
            _fail("grid-invariants", "step1",
                  f"stage (H={st.plan.h_set}, η={cfg.eta.values}): recorded "
                  f"m_η={cfg.m_eta} but the residual size recomputes to {m_eta}")
        want = min(p, max(1, math.ceil(p * cfg.m_eta / denom)))
        if grp.size != want:
            _fail("grid-invariants", "step1",
                  f"stage (H={st.plan.h_set}, η={cfg.eta.values}): step-1 group size "
                  f"{grp.size} != allocation formula ⌈p·m_η/(m·λ^(k-2))⌉ = {want}")
        checks += 4
        pkey = (st.signature, cfg.m_eta)
        if pkey in probed:
            continue
        probed.add(pkey)
        for s in sorted({1, max(1, cfg.m_eta)}):
            entries = {x: [(0, s)] for x in st.plan.isolated}
            geo = stage_geometry(program, st, entries)
            checks += check_stage_geometry(geo, p)
            probes += 1
    return checks, probes


# ---------------------------------------------------------------------------
# join-tree + share-exponent + collective-stream: the general route
# ---------------------------------------------------------------------------


def _check_general_stream(program: RoundProgram) -> int:
    """``collective-stream`` for general programs: the op list must be the
    exact compiler image — Scatter, both TreeSemiJoin sweeps (up before
    down), ShareRoute, CellJoin for acyclic plans; Scatter, ShareRoute,
    CellJoin for cyclic ones.  Anything else breaks either the strictly
    serial collective order or the Yannakakis reduction (a down sweep before
    the up sweep is not a full reducer)."""
    want = (
        GENERAL_ACYCLIC_OPS if program.general.kind == "yannakakis"
        else GENERAL_CYCLIC_OPS
    )
    if tuple(program.ops) != want:
        _fail("collective-stream", None,
              f"general op sequence {program.op_sequence()} is not the "
              f"canonical {[op.round for op in want]} stream for a "
              f"{program.general.kind!r} plan — the semijoin sweeps must run "
              f"up-then-down before the route, each collective exactly once")
    return 1


def _check_join_tree(program: RoundProgram) -> int:
    """``join-tree``: the compiled plan's tree is a real join tree of the
    query — every non-root relation hangs off exactly one parent, every edge
    label is the full scheme intersection, the running intersection property
    holds, the recorded order is leaves-first (a valid up sweep), and the
    CellJoin order is a tree pre-order.  Cyclic plans must carry no tree and
    acyclic queries must not have been demoted to the cyclic route."""
    gen = program.general
    schemes = [frozenset(r.scheme) for r in program.query.relations]
    n = len(schemes)
    real_tree = build_join_tree(schemes)
    if gen.kind == "hypercube":
        if gen.tree_edges:
            _fail("join-tree", "hc-route",
                  "cyclic (hypercube) plan carries join-tree edges")
        if real_tree is not None:
            _fail("join-tree", "hc-route",
                  "query is GYO-acyclic but the plan routes it through the "
                  "cyclic HyperCube program — the Yannakakis reduction was "
                  "dropped")
        if sorted(gen.join_order) != list(range(n)):
            _fail("join-tree", "output",
                  f"join order {gen.join_order} is not a permutation of the "
                  f"{n} relations")
        return 3
    if real_tree is None:
        _fail("join-tree", "yan-up",
              "query is cyclic but the plan claims a Yannakakis join tree")
    tree = JoinTree(
        n_nodes=n,
        root=gen.tree_root,
        edges=tuple(
            (c, par, frozenset(sh)) for c, par, sh in gen.tree_edges
        ),
    )
    if not running_intersection_ok(schemes, tree):
        _fail("join-tree", "yan-up",
              f"tree edges {gen.tree_edges} violate the running intersection "
              f"property (or are structurally broken) — the two semijoin "
              f"sweeps would not be a full reducer")
    checks = 2
    for c, par, sh in gen.tree_edges:
        if frozenset(sh) != schemes[c] & schemes[par]:
            _fail("join-tree", "yan-up",
                  f"edge ({c}, {par}) label {sh} is not the full scheme "
                  f"intersection {sorted(schemes[c] & schemes[par])}")
        checks += 1
    removed: set = set()
    for c, par, _ in gen.tree_edges:
        if c in removed or par in removed:
            _fail("join-tree", "yan-up",
                  f"edge ({c}, {par}) fires after one endpoint was already "
                  f"removed — the recorded order is not a leaves-first up "
                  f"sweep (the down sweep, its reverse, breaks too)")
        removed.add(c)
        checks += 1
    order = gen.join_order
    if sorted(order) != list(range(n)):
        _fail("join-tree", "output",
              f"join order {order} is not a permutation of the {n} relations")
    if order and order[0] != gen.tree_root:
        _fail("join-tree", "output",
              f"join order starts at {order[0]}, not the tree root "
              f"{gen.tree_root}")
    parent = tree.parent
    placed = {gen.tree_root}
    for node in order[1:]:
        if parent.get(node) not in placed:
            _fail("join-tree", "output",
                  f"join order {order} joins relation {node} before its tree "
                  f"parent — the chain step would be a cartesian blowup, not "
                  f"a tree-edge join")
        placed.add(node)
        checks += 1
    return checks + 2


def _check_share_exponent(program: RoundProgram) -> int:
    """``share-exponent``: the HyperCube shares are positive integers over
    exactly the output attributes, their product respects the machine budget
    Π ≤ p, and they equal the fractional-edge-cover LP solution the compiler
    derives (`uniform_lp_shares`) — a tampered share vector either breaks
    exactly-once cell assembly or the m/p^{1/ρ} load shape."""
    gen = program.general
    shares = dict(gen.shares)
    attrs = set(program.query.attset)
    if set(shares) != attrs:
        _fail("share-exponent", "hc-route",
              f"share attributes {sorted(shares)} do not cover the query "
              f"attributes {sorted(attrs)} — unshared attributes break "
              f"exactly-once cell assembly")
    prod = 1
    for a, s in sorted(shares.items()):
        if not isinstance(s, int) or s < 1:
            _fail("share-exponent", "hc-route",
                  f"share({a}) = {s!r} is not a positive integer")
        prod *= s
    if prod > program.p:
        _fail("share-exponent", "hc-route",
              f"Π shares = {prod} exceeds the machine budget p = {program.p}")
    want = uniform_lp_shares(program.query.hypergraph, program.p)
    if shares != {a: int(s) for a, s in want.items()}:
        _fail("share-exponent", "hc-route",
              f"shares {sorted(shares.items())} disagree with the "
              f"fractional-edge-cover LP solution "
              f"{sorted((a, int(s)) for a, s in want.items())}")
    return len(shares) + 3


# ---------------------------------------------------------------------------
# cap-grid + packed-key: executor-facing helpers
# ---------------------------------------------------------------------------


def on_cap_grid(n: int) -> bool:
    """True iff ``n`` is a legal quantized capacity: ≥ 16 and of the form
    2^k or 3·2^(k-1) (the ``_quant`` grid in executors.py)."""
    if n != int(n) or n < 16:
        return False
    n = int(n)
    if n & (n - 1) == 0:
        return True
    return n % 3 == 0 and (n // 3) >= 8 and ((n // 3) & (n // 3 - 1)) == 0


def verify_caps(caps: Mapping, op_round: Optional[str] = None) -> int:
    """``cap-grid``: every learned capacity is a positive int on the quant
    grid and every signature maps channel names to capacities."""
    checks = 0
    for key, chans in caps.items():
        if not isinstance(chans, Mapping):
            _fail("cap-grid", op_round,
                  f"cap signature {key!r} maps to {type(chans).__name__}, "
                  f"want a channel→capacity mapping")
        for chan, cap in chans.items():
            if not isinstance(chan, str):
                _fail("cap-grid", op_round,
                      f"cap signature {key!r} has non-string channel {chan!r}")
            if not on_cap_grid(cap):
                _fail("cap-grid", op_round,
                      f"cap {chan}={cap!r} for {key!r} is off the {{2^k, 3·2^(k-1)}} "
                      f"quantization grid (≥ 16) — unbounded executable signatures")
            checks += 1
    return checks


def check_packed_key(
    max_cell: int, dup_maxes: Sequence[int], packed: bool, op_round: str = "output"
) -> None:
    """``packed-key``: the packed flag is only legal when the mixed-radix key
    space (max_cell+1)·Π(max_dup_i+1) fits int32 with non-negative parts."""
    if not packed:
        return
    if max_cell < 0 or any(d < 0 for d in dup_maxes):
        _fail("packed-key", op_round,
              "packed flag set with a negative key component — packing is not "
              "collision-free over negatives")
    space = int(max_cell) + 1
    for d in dup_maxes:
        space *= int(d) + 1
    if space > _INT32_MAX:
        _fail("packed-key", op_round,
              f"packed flag set but the mixed-radix key space {space} exceeds "
              f"INT32_MAX={_INT32_MAX} — keys would collide")


# ---------------------------------------------------------------------------
# load-bound: the symbolic model vs a metered run
# ---------------------------------------------------------------------------


def check_load(program: RoundProgram, result, constant: float = 1.0) -> Dict[str, float]:
    """``load-bound``: assert every measured round load of a metered run is
    ≤ ``constant`` × the symbolic model bound of
    :func:`repro_torch.analysis.loadmodel.round_bounds`.

    ``result`` is an ``MPCJoinResult`` (anything with ``.sim``) or a plain
    ``{round: load}`` mapping (e.g. ``sim.merged_round_loads()``).  Returns
    the per-round measured/bound fractions on success."""
    measured = result if isinstance(result, Mapping) else result.sim.merged_round_loads()
    bounds = round_bounds_by_name(program, constant=MODEL_CONSTANT)
    fractions: Dict[str, float] = {}
    for name, load in measured.items():
        b = bounds.get(name)
        if b is None:  # scatter/output: load-free rounds
            continue
        limit = constant * b.words
        if load > limit:
            _fail("load-bound", name,
                  f"measured load {load:.0f} exceeds the Theorem 6.2 model bound "
                  f"{limit:.0f} = {constant:g} × {b.formula}")
        fractions[name] = load / max(limit, 1e-30)
    return fractions


# ---------------------------------------------------------------------------
# the full static pass
# ---------------------------------------------------------------------------


def verify_program(
    program: RoundProgram, caps: Optional[Mapping] = None
) -> VerificationReport:
    """Run every static rule over a *bound* compiled program.

    ``caps`` optionally adds the executor's learned-capacity store to the
    pass (rule ``cap-grid``).  Raises :class:`ProgramVerificationError` on
    the first violation; returns a :class:`VerificationReport` otherwise."""
    checks = verify_bindings(program)
    if getattr(program, "general", None) is not None:
        # General (arbitrary-arity) programs: the binary taxonomy rules have
        # no meaning here — the structural invariants are the join tree, the
        # share exponents, and the general collective stream.
        checks += _check_general_stream(program)
        checks += _check_join_tree(program)
        checks += _check_share_exponent(program)
        if caps is not None:
            checks += verify_caps(caps)
        return VerificationReport(
            p=program.p, stages=len(program.stages), checks=checks,
            geometry_probes=0,
        )
    checks += _check_op_stream(program)
    checks += _check_semijoin_fusion(program)
    stage_checks, probes = _check_stages(program)
    checks += stage_checks
    if caps is not None:
        checks += verify_caps(caps)
    return VerificationReport(
        p=program.p, stages=len(program.stages), checks=checks, geometry_probes=probes
    )
