"""Execution backends for the round-program IR (repro_torch.mpc.program).

One verified plan, two backends:

* :class:`SimulatorExecutor` interprets every op on the exact-cost
  :class:`~repro_torch.mpc.simulator.MPCSimulator` — the load oracle, host
  numpy.  It is the reference package's simulator executor with the same
  hash keys, per-machine RNG streams and loop order, so its rows,
  ``per_h_counts`` and per-round loads equal the reference's.

* :class:`DataplaneExecutor` lowers every op of a compiled
:class:`~repro_torch.mpc.program.RoundProgram` onto the torch data plane —
one lowering rule per :class:`~repro_torch.mpc.program.RoundOp`, dispatched
over ``program.ops``: capacity-padded hash exchanges and grid routes among p
machines held as a leading tensor axis on one device, plus the
``merge_join_counts`` / ``merge_join_pairs`` / ``hash_partition_pack``
kernels.  Stages with isolated attributes run the Lemma 3.1 cartesian grid
composed with the Lemma 3.3 HyperCube (the Lemma 3.2 cell mapping lives in
:class:`~repro_torch.mpc.program.StageGeometry`).  General (arbitrary-arity)
programs run their Yannakakis sweeps, share route and cell join on the same
primitives.
"""

from __future__ import annotations

import hashlib
import math
import time
from collections import OrderedDict, defaultdict
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.query import Attr, JoinQuery, Relation, reference_join, relation_digests
from ..core.taxonomy import heavy_masks, residual_relations, sorted_rows
from ..dataplane.exchange import to_host
from ..device import resolve_device
from ..kernels.digest import chunk_digests
from ..spans import count, span
from .faults import DeadlineExceededError, RetryExhaustedError
from .hypercube import HyperCubeGrid, route_hypercube
from .program import (
    BroadcastSizes,
    CellJoin,
    GridRoute,
    HashPartition,
    LocalJoin,
    ProgramStage,
    RoundOp,
    RoundProgram,
    RouteResidual,
    RunConfig,
    Scatter,
    SemiJoin,
    ShareRoute,
    StageGeometry,
    TreeSemiJoin,
    stage_geometry,
)
from .simulator import MPCSimulator, scatter_input
from .verify import verify_program


@dataclass
class MPCJoinResult:
    p: int
    lam: int
    rho: float
    m: int
    count: int
    rows: Optional[np.ndarray]          # over sorted(attset), if materialized
    sim: MPCSimulator
    per_h_counts: Dict[Tuple[Attr, ...], int]

    @property
    def bound(self) -> float:
        """The claimed load bound m / p^{1/ρ} (polylog factors not included)."""
        return self.m / (self.p ** (1.0 / self.rho))

    @property
    def load(self) -> int:
        return self.sim.parallel_total_load

    @property
    def load_ratio(self) -> float:
        return self.load / max(1.0, self.bound)


def _send_grouped(sim: MPCSimulator, phys: np.ndarray, tag, rows: np.ndarray) -> None:
    """Group rows by destination and send one message per destination."""
    if rows.ndim == 1:
        rows = rows.reshape(-1, 1)
    if rows.shape[0] == 0:
        return
    order = np.argsort(phys, kind="stable")
    ps, rs = phys[order], rows[order]
    uniq = np.unique(ps)
    bounds = np.append(np.searchsorted(ps, uniq), ps.shape[0])
    for i, dst in enumerate(uniq.tolist()):
        sim.send(int(dst), tag, rs[bounds[i] : bounds[i + 1]])


# ---------------------------------------------------------------------------
# Simulator backend
# ---------------------------------------------------------------------------


class SimulatorExecutor:
    """Runs a compiled :class:`RoundProgram` on the exact-cost simulator.

    May be handed an existing simulator (so the statistics preprocessing and
    the program execution meter into the same round ledger — the ``mpc_join``
    path), or a bare ``p`` to own a fresh one."""

    def __init__(
        self, sim: Optional[MPCSimulator] = None, p: Optional[int] = None, seed: int = 0
    ):
        if sim is None:
            if p is None:
                raise ValueError("need either a simulator or p")
            sim = MPCSimulator(p, seed=seed)
        self.sim = sim
        self.seed = seed

    # -- input placement (Scatter semantics; idempotent) ---------------------

    def place_inputs(
        self,
        query: JoinQuery,
        seed_offset: int = 17,
        scatter_cache: Optional[Dict] = None,
    ) -> None:
        """Scatter every input relation evenly (Θ(m/p) per machine).

        Shared-input path: relations carrying the same ``Relation.table`` id
        and the same tuple set are physically one table (the subgraph
        reduction binds k pattern edges to one edge set), so the tuples are
        shuffled and placed ONCE and the per-edge ``("in", e)`` tags alias the
        same numpy blocks — k logical copies cost one placement.  Aliasing is
        invisible to the MPC accounting (Scatter is load-free initial
        placement) and to downstream ops, which only ever read these tags;
        it also matches the unshared behavior bit for bit, because every
        relation was already scattered with the same seed.

        ``scatter_cache`` extends the sharing *across* simulators: a
        :class:`~repro_torch.mpc.service.JoinSession` batch passes its session dict
        keyed by (table, p, seed), and queries binding the same physical
        table reuse the first query's shuffled placement instead of
        re-shuffling — bit-identical, because ``scatter_input`` is
        deterministic in (data, seed, p)."""
        placed: Dict[str, Tuple[object, np.ndarray]] = {}
        for rel in query.relations:
            tag = ("in", rel.edge)
            if self.sim.machines_with(tag):
                continue
            shared = placed.get(rel.table) if rel.table is not None else None
            if shared is not None and (
                shared[1] is rel.data or np.array_equal(shared[1], rel.data)
            ):
                src = shared[0]
                for mid in range(self.sim.p):
                    parts = self.sim.stores[mid].get(src)
                    if parts:
                        self.sim.stores[mid][tag] = list(parts)
                continue
            ckey = None
            if scatter_cache is not None and rel.table is not None:
                ckey = (rel.table, self.sim.p, self.seed + seed_offset)
                hit = scatter_cache.get(ckey)
                if hit is not None and (
                    hit[0] is rel.data or np.array_equal(hit[0], rel.data)
                ):
                    for mid, parts in enumerate(hit[1]):
                        if parts:
                            self.sim.stores[mid][tag] = list(parts)
                    placed.setdefault(rel.table, (tag, rel.data))
                    continue
            scatter_input(self.sim, tag, rel.data, seed=self.seed + seed_offset)
            if ckey is not None and ckey not in scatter_cache:
                scatter_cache[ckey] = (
                    rel.data,
                    [
                        list(self.sim.stores[mid].get(tag) or [])
                        for mid in range(self.sim.p)
                    ],
                )
            if rel.table is not None and rel.table not in placed:
                placed[rel.table] = (tag, rel.data)

    # -- program interpretation ----------------------------------------------

    def run(self, program: RoundProgram, materialize: bool = True) -> MPCJoinResult:
        if self.sim.p != program.p:
            raise ValueError(f"simulator has p={self.sim.p}, program wants {program.p}")
        self._program = program
        self._materialize = materialize
        self._geo: Dict[int, StageGeometry] = {}
        self._outputs: Dict[int, List[np.ndarray]] = defaultdict(list)
        self._counts: Dict[Tuple[Attr, ...], int] = defaultdict(int)
        # general route: per-relation working tag (TreeSemiJoin sweeps move a
        # relation's surviving rows under fresh tags as they filter it)
        self._gtags: Dict[int, Tuple] = {
            i: ("in", rel.edge) for i, rel in enumerate(program.query.relations)
        }
        self._ggrid: Optional[HyperCubeGrid] = None

        # H = attset(Q) emits: host-side placement, zero communication.
        for mid, row in program.emit:
            self._outputs[mid].append(row)
        for hkey, c in program.emit_counts.items():
            self._counts[hkey] += c

        for op in program.ops:
            self._dispatch(op)

        rows_out = None
        if materialize:
            chunks = [r for parts in self._outputs.values() for r in parts]
            rows_out = (
                np.concatenate(chunks, axis=0)
                if chunks
                else np.zeros((0, len(program.out_cols)), dtype=np.int64)
            )
        return MPCJoinResult(
            p=program.p,
            lam=program.lam,
            rho=program.rho_val,
            m=program.stats.m,
            count=sum(self._counts.values()),
            rows=rows_out,
            sim=self.sim,
            per_h_counts=dict(self._counts),
        )

    def _dispatch(self, op: RoundOp) -> None:
        if isinstance(op, Scatter):
            self.place_inputs(self._program.query, op.seed_offset)
        elif isinstance(op, RouteResidual):
            self._op_route_residual()
        elif isinstance(op, HashPartition):
            self._op_hash_partition()
        elif isinstance(op, SemiJoin):
            self._op_semijoin(op)
        elif isinstance(op, BroadcastSizes):
            self._op_broadcast_sizes()
        elif isinstance(op, GridRoute):
            self._op_grid_route()
        elif isinstance(op, LocalJoin):
            self._op_local_join()
        elif isinstance(op, TreeSemiJoin):
            self._op_tree_semijoin(op)
        elif isinstance(op, ShareRoute):
            self._op_share_route()
        elif isinstance(op, CellJoin):
            self._op_cell_join()
        else:
            raise NotImplementedError(f"unknown op {op!r}")

    # -- step 1: route residual tuples ---------------------------------------

    def _op_route_residual(self) -> None:
        sim, program = self.sim, self._program
        query, stats, p = program.query, program.stats, program.p
        sim.begin_round("step1")
        for mid in range(sim.p):
            mrng = np.random.default_rng(self.seed * 1_000_003 + mid)
            local_cache: Dict = {}
            for rel in query.relations:
                local = sim.local(mid, ("in", rel.edge))
                if local.shape[0] == 0:
                    continue
                x_attr, y_attr = rel.scheme
                hx = stats.is_heavy(x_attr, local[:, 0])
                hy = stats.is_heavy(y_attr, local[:, 1])
                local_cache[rel.edge] = (local, hx, hy)
            for st in program.stages:
                plan, cfg = st.plan, st.cfg
                h = set(plan.h_set)
                grp = cfg.step1_group
                for rel in query.relations:
                    if rel.edge not in local_cache:
                        continue
                    local, hx, hy = local_cache[rel.edge]
                    x_attr, y_attr = rel.scheme
                    inter = rel.edge & h
                    if len(inter) == 2:
                        continue
                    if len(inter) == 0:
                        sel = ~hx & ~hy
                        rows = local[sel]
                    else:
                        (heavy_attr,) = inter
                        if heavy_attr == x_attr:
                            sel = (local[:, 0] == cfg.eta.value(x_attr)) & ~hy
                            rows = local[sel][:, 1:2]   # project to light attr
                        else:
                            sel = (local[:, 1] == cfg.eta.value(y_attr)) & ~hx
                            rows = local[sel][:, 0:1]
                    if rows.shape[0] == 0:
                        continue
                    virt = mrng.integers(0, grp.size, size=rows.shape[0])
                    phys = (grp.base + virt) % p
                    _send_grouped(sim, phys, ("r1", st.hkey, st.ekey, rel.edge), rows)
        sim.end_round()

    # -- step 2a: unary partition + intersection -----------------------------

    def _op_hash_partition(self) -> None:
        sim, program = self.sim, self._program
        query, p = program.query, program.p
        sim.begin_round("step2-unary")
        for st in program.stages:
            plan, cfg = st.plan, st.cfg
            grp = cfg.step1_group
            for e in plan.cross_edges:
                light_attr = next(iter(e - set(plan.h_set)))
                tag_in = ("r1", st.hkey, st.ekey, e)
                for mid in sim.machines_with(tag_in):
                    rows = sim.local(mid, tag_in, arity=1)
                    virt = sim.hashes.hash(
                        (st.hkey, st.ekey, "sj", light_attr), rows[:, 0], grp.size
                    )
                    phys = (grp.base + virt) % p
                    _send_grouped(sim, phys, ("u", st.hkey, st.ekey, light_attr, e), rows)
        sim.end_round()

        # local intersection → R''_X pieces (no communication)
        for st in program.stages:
            plan = st.plan
            for x in plan.border:
                es = [e for e in plan.cross_edges if x in e]
                for mid in range(sim.p):
                    pieces = []
                    ok = True
                    for e in es:
                        vals = sim.local(mid, ("u", st.hkey, st.ekey, x, e), arity=1)
                        if vals.shape[0] == 0:
                            ok = False
                            break
                        pieces.append(np.unique(vals[:, 0]))
                    if not ok:
                        continue
                    inter = pieces[0]
                    for arr in pieces[1:]:
                        inter = np.intersect1d(inter, arr, assume_unique=True)
                    if inter.size:
                        sim.stores[mid][("ux", st.hkey, st.ekey, x)] = [inter.reshape(-1, 1)]

    # -- step 2b/2c: semi-join light edges -----------------------------------

    def _filter_by_membership(self, mid, rows, col, attr, st):
        """Keep rows whose rows[:, col] is in the machine-local R''_attr piece."""
        piece = self.sim.local(mid, ("ux", st.hkey, st.ekey, attr), arity=1)[:, 0]
        if piece.size == 0:
            return rows[:0]
        return rows[np.isin(rows[:, col], piece)]

    def _op_semijoin(self, op: SemiJoin) -> None:
        if op.phase == "x":
            self._semijoin_x()
        elif op.phase == "y":
            self._semijoin_y(fused=False)
            self._semijoin_local_y_filter()
        elif op.phase == "fused-route":
            self._semijoin_fused_route()
        elif op.phase == "fused-filter":
            self._semijoin_y(fused=True)
            self._semijoin_local_y_filter()
        else:
            raise NotImplementedError(f"SemiJoin phase {op.phase!r}")

    def _semijoin_x(self) -> None:
        sim, program = self.sim, self._program
        query, p = program.query, program.p
        sim.begin_round("step2-bx")
        for st in program.stages:
            grp = st.cfg.step1_group
            for e in st.plan.light_edges:
                rel = query.relation_for(e)
                x_attr = rel.scheme[0]
                tag_in = ("r1", st.hkey, st.ekey, e)
                for mid in sim.machines_with(tag_in):
                    rows = sim.local(mid, tag_in, arity=2)
                    virt = sim.hashes.hash(
                        (st.hkey, st.ekey, "sj", x_attr), rows[:, 0], grp.size
                    )
                    phys = (grp.base + virt) % p
                    _send_grouped(sim, phys, ("bx", st.hkey, st.ekey, e), rows)
        sim.end_round()

    def _semijoin_fused_route(self) -> None:
        # Beyond-paper fusion: route directly to the Y partition; X-filtering
        # happens at the Y-side against a replicated X piece fetched in the same
        # round — saves one full data round when X is not a border attribute,
        # else falls back to the two-hop detour.  See EXPERIMENTS §Perf.
        sim, program = self.sim, self._program
        query, p = program.query, program.p
        sim.begin_round("step2-fused")
        for st in program.stages:
            grp = st.cfg.step1_group
            for e in st.plan.light_edges:
                rel = query.relation_for(e)
                x_attr, y_attr = rel.scheme
                tag_in = ("r1", st.hkey, st.ekey, e)
                for mid in sim.machines_with(tag_in):
                    rows = sim.local(mid, tag_in, arity=2)
                    if x_attr not in st.plan.border:
                        virt = sim.hashes.hash(
                            (st.hkey, st.ekey, "sj", y_attr), rows[:, 1], grp.size
                        )
                        phys = (grp.base + virt) % p
                        _send_grouped(sim, phys, ("rr", st.hkey, st.ekey, e), rows)
                    else:
                        virt = sim.hashes.hash(
                            (st.hkey, st.ekey, "sj", x_attr), rows[:, 0], grp.size
                        )
                        phys = (grp.base + virt) % p
                        _send_grouped(sim, phys, ("bx", st.hkey, st.ekey, e), rows)
        sim.end_round()

    def _semijoin_y(self, fused: bool) -> None:
        sim, program = self.sim, self._program
        query, p = program.query, program.p
        sim.begin_round("step2-by")
        for st in program.stages:
            grp = st.cfg.step1_group
            for e in st.plan.light_edges:
                rel = query.relation_for(e)
                x_attr, y_attr = rel.scheme
                if fused and x_attr not in st.plan.border:
                    continue
                tag_in = ("bx", st.hkey, st.ekey, e)
                for mid in sim.machines_with(tag_in):
                    rows = sim.local(mid, tag_in, arity=2)
                    if x_attr in st.plan.border:
                        rows = self._filter_by_membership(mid, rows, 0, x_attr, st)
                    if rows.shape[0] == 0:
                        continue
                    virt = sim.hashes.hash(
                        (st.hkey, st.ekey, "sj", y_attr), rows[:, 1], grp.size
                    )
                    phys = (grp.base + virt) % p
                    _send_grouped(sim, phys, ("rr", st.hkey, st.ekey, e), rows)
        sim.end_round()

    def _semijoin_local_y_filter(self) -> None:
        # Y-side filtering is local (the piece lives where the hash sent the row).
        sim, program = self.sim, self._program
        query = program.query
        for st in program.stages:
            for e in st.plan.light_edges:
                rel = query.relation_for(e)
                y_attr = rel.scheme[1]
                if y_attr not in st.plan.border:
                    continue
                tag = ("rr", st.hkey, st.ekey, e)
                for mid in sim.machines_with(tag):
                    rows = sim.local(mid, tag, arity=2)
                    rows = self._filter_by_membership(mid, rows, 1, y_attr, st)
                    sim.stores[mid][tag] = [rows]

    # -- step 3 sizes: broadcast |R''_X| pieces ------------------------------

    def _op_broadcast_sizes(self) -> None:
        sim, program = self.sim, self._program
        attset = program.query.attset
        stages = program.stages
        sim.begin_round("step3-sizes")
        cfg_index = {(st.hkey, st.ekey): i for i, st in enumerate(stages)}
        attr_index = {a: i for i, a in enumerate(attset)}
        for st in stages:
            for x in st.plan.isolated:
                tag = ("ux", st.hkey, st.ekey, x)
                for mid in sim.machines_with(tag):
                    cnt = sim.local(mid, tag, arity=1).shape[0]
                    msg = np.array(
                        [[cfg_index[(st.hkey, st.ekey)], attr_index[x], mid, cnt]],
                        dtype=np.int64,
                    )
                    sim.broadcast(("sz",), msg)
        sim.end_round()

        size_rows = (
            sim.local(0, ("sz",), arity=4)
            if sim.machines_with(("sz",))
            else np.zeros((0, 4), np.int64)
        )
        piece_sizes: Dict[Tuple[int, int], List[Tuple[int, int]]] = defaultdict(list)
        for ci, ai, mid, cnt in size_rows.tolist():
            piece_sizes[(ci, ai)].append((mid, cnt))

        for i, st in enumerate(stages):
            entries = {
                x: piece_sizes.get((i, attr_index[x]), []) for x in st.plan.isolated
            }
            self._geo[i] = stage_geometry(program, st, entries)

    # -- step 3 route: Lemma 3.1 grid × Lemma 3.3 HyperCube ------------------

    def _op_grid_route(self) -> None:
        sim, program = self.sim, self._program
        query = program.query
        sim.begin_round("step3-route")
        for i, st in enumerate(program.stages):
            geo = self._geo[i]
            if geo.skip:
                continue
            grp = geo.step3_group
            hc_size, cp_size = geo.hc_size, geo.cp_size

            # CP side: every grid cell is instantiated in every HC column.
            if geo.grid:
                for li, x in enumerate(geo.iso_order):
                    tag = ("ux", st.hkey, st.ekey, x)
                    for mid in sim.machines_with(tag):
                        vals = sim.local(mid, tag, arity=1)
                        ids = geo.offsets[(x, mid)] + np.arange(
                            vals.shape[0], dtype=np.int64
                        )
                        if li < geo.grid.t_prime:
                            cells = geo.grid.cells_for_ids(li, ids)
                            for combo in range(cells.shape[1]):
                                flat = cells[:, combo]
                                for cell in np.unique(flat).tolist():
                                    rows = vals[flat == cell]
                                    for h_cell in range(hc_size):
                                        v = geo.cell(cell, h_cell)
                                        sim.send(
                                            grp.phys(v),
                                            ("cp", st.hkey, st.ekey, v, x),
                                            rows,
                                        )
                        else:
                            for cell in range(cp_size):
                                for h_cell in range(hc_size):
                                    v = geo.cell(cell, h_cell)
                                    sim.send(
                                        grp.phys(v), ("cp", st.hkey, st.ekey, v, x), vals
                                    )

            # HC side: every HC cell instantiated in every CP row.
            if geo.hc_grid:
                for e in st.plan.light_edges:
                    rel = query.relation_for(e)
                    tag = ("rr", st.hkey, st.ekey, e)
                    for mid in sim.machines_with(tag):
                        rows = sim.local(mid, tag, arity=2)

                        def deliver(
                            h_cell, out_tag, rs, _grp=grp, _geo=geo, _cp=cp_size, _st=st
                        ):
                            for c in range(_cp):
                                v = _geo.cell(c, h_cell)
                                sim.send(
                                    _grp.phys(v), ("hc", _st.hkey, _st.ekey, v, out_tag), rs
                                )

                        route_hypercube(
                            sim,
                            geo.hc_grid,
                            [(rel.scheme, e, rows)],
                            salt=(st.hkey, st.ekey, "hc"),
                            deliver=deliver,
                        )
        sim.end_round()

    # -- output: local joins, exactly-once -----------------------------------

    def _op_local_join(self) -> None:
        sim, program = self.sim, self._program
        query = program.query
        out_cols = list(program.out_cols)
        materialize = self._materialize
        for i, st in enumerate(program.stages):
            geo = self._geo[i]
            if geo.skip:
                continue
            plan = st.plan
            grp = geo.step3_group
            l_minus_i = [a for a in plan.light if a not in plan.isolated]
            h_count = 0
            for v in range(grp.size):
                mid = grp.phys(v)
                # light side
                if plan.light_edges:
                    frags = []
                    ok = True
                    for e in plan.light_edges:
                        rel = query.relation_for(e)
                        rows = sim.local(mid, ("hc", st.hkey, st.ekey, v, e), arity=2)
                        if rows.shape[0] == 0:
                            ok = False
                            break
                        frags.append(Relation.make(rel.scheme, rows))
                    if not ok:
                        continue
                    light_join = reference_join(JoinQuery.make(frags))
                    light_rows = light_join.data  # over sorted(l_minus_i)
                    if light_rows.shape[0] == 0:
                        continue
                else:
                    light_rows = np.zeros((1, 0), dtype=np.int64)

                # CP side
                cp_lists = []
                ok = True
                for x in geo.iso_order:
                    vals = sim.local(mid, ("cp", st.hkey, st.ekey, v, x), arity=1)
                    vals = np.unique(vals[:, 0])
                    if vals.size == 0:
                        ok = False
                        break
                    cp_lists.append(vals)
                if not ok:
                    continue

                n_cp = math.prod(arr.size for arr in cp_lists) if cp_lists else 1
                n_here = light_rows.shape[0] * n_cp
                h_count += n_here
                if materialize and n_here:
                    rows = light_rows
                    cols = sorted(l_minus_i)
                    for x, vals in zip(geo.iso_order, cp_lists):
                        nn = rows.shape[0]
                        rows = np.repeat(rows, vals.size, axis=0)
                        rows = np.concatenate(
                            [rows, np.tile(vals, nn).reshape(-1, 1)], axis=1
                        )
                        cols.append(x)
                    for a in plan.h_set:
                        rows = np.concatenate(
                            [
                                rows,
                                np.full((rows.shape[0], 1), st.cfg.eta.value(a), np.int64),
                            ],
                            axis=1,
                        )
                        cols.append(a)
                    perm = [cols.index(a) for a in out_cols]
                    self._outputs[mid].append(rows[:, perm])
            self._counts[st.hkey] += h_count

    # -- general route: Yannakakis sweeps + generalized HyperCube -------------

    def _op_tree_semijoin(self, op: TreeSemiJoin) -> None:
        """One semijoin sweep along the join tree (general acyclic route).

        Each tree edge is its own communication round (the next edge's filter
        reads this edge's output); same-named rounds merge in the parallel
        load accounting, matching the paper's process-all-in-parallel model.
        Both sides of an edge are hash-partitioned on the first shared
        attribute (same hash key ⇒ co-located), then the filtered side keeps
        exactly the rows whose full shared-attribute tuple appears in the
        filtering side.  An empty shared label degenerates to a non-emptiness
        filter: both sides key on the constant 0, so the filtered relation
        survives iff the filtering one has any row (the cartesian stitch
        between disconnected components)."""
        sim, program = self.sim, self._program
        query, gen = program.query, program.general
        edges = gen.tree_edges
        if op.phase == "down":
            edges = tuple(reversed(edges))
        for ei, (child, parent, shared) in enumerate(edges):
            if op.phase == "up":
                tgt, src = parent, child
            else:
                tgt, src = child, parent
            tgt_rel, src_rel = query.relations[tgt], query.relations[src]
            hkey = ("gsj", op.phase, ei)
            tag_f = ("gsjf", op.phase, ei)      # filtering-side key tuples
            tag_e = ("gsje", op.phase, ei)      # filtered-side rows
            new_tag = ("gsj", op.phase, ei, tgt)
            sim.begin_round(op.round)
            for mid in range(sim.p):
                srows = sim.local(mid, self._gtags[src], arity=src_rel.arity)
                if srows.shape[0]:
                    if shared:
                        scols = [src_rel.scheme.index(a) for a in shared]
                        proj = np.unique(srows[:, scols], axis=0)
                    else:
                        proj = np.zeros((1, 1), dtype=np.int64)
                    hv = sim.hashes.hash(hkey, proj[:, 0], sim.p)
                    _send_grouped(sim, hv, tag_f, proj)
                trows = sim.local(mid, self._gtags[tgt], arity=tgt_rel.arity)
                if trows.shape[0]:
                    if shared:
                        tcols = [tgt_rel.scheme.index(a) for a in shared]
                        keyvals = trows[:, tcols[0]]
                    else:
                        keyvals = np.zeros(trows.shape[0], dtype=np.int64)
                    hv = sim.hashes.hash(hkey, keyvals, sim.p)
                    _send_grouped(sim, hv, tag_e, trows)
            sim.end_round()
            for mid in sim.machines_with(tag_e):
                trows = sim.local(mid, tag_e, arity=tgt_rel.arity)
                fl = sim.local(mid, tag_f, arity=max(1, len(shared)))
                if shared:
                    tcols = [tgt_rel.scheme.index(a) for a in shared]
                    fset = set(map(tuple, fl.tolist()))
                    keep = np.fromiter(
                        (tuple(r) in fset for r in trows[:, tcols].tolist()),
                        dtype=bool,
                        count=trows.shape[0],
                    )
                else:
                    keep = np.full(trows.shape[0], fl.shape[0] > 0)
                sim.stores[mid][new_tag] = [trows[keep]]
            self._gtags[tgt] = new_tag

    def _op_share_route(self) -> None:
        """Generalized HyperCube route: every attribute is a grid dimension
        (shares from the compiled plan, Π ≤ p), every relation's tuples go to
        all cells agreeing with their hashed coordinates — one round."""
        sim, program = self.sim, self._program
        query, gen = program.query, program.general
        grid = HyperCubeGrid(program.out_cols, gen.shares_dict)
        self._ggrid = grid
        sim.begin_round("hc-route")
        for mid in range(sim.p):
            frags = []
            for i, rel in enumerate(query.relations):
                local = sim.local(mid, self._gtags[i], arity=rel.arity)
                frags.append((rel.scheme, i, local))
            route_hypercube(
                sim,
                grid,
                frags,
                salt="ghc",
                deliver=lambda cell, i, rows: sim.send(cell, ("gcell", i), rows),
            )
        sim.end_round()

    def _op_cell_join(self) -> None:
        """Output round of the general route: each cell joins its co-located
        fragments locally (every attribute is a grid dimension, so each result
        tuple materializes at exactly one cell — no communication)."""
        sim, program = self.sim, self._program
        query, gen = program.query, program.general
        grid = self._ggrid
        total = 0
        for cell in range(grid.size):
            frags = []
            empty = False
            for i in gen.join_order:
                rel = query.relations[i]
                rows = sim.local(cell, ("gcell", i), arity=rel.arity)
                if rows.shape[0] == 0:
                    empty = True
                    break
                frags.append(Relation.make(rel.scheme, rows))
            if empty:
                continue
            local_join = reference_join(JoinQuery.make(frags))
            total += len(local_join)
            if self._materialize and len(local_join):
                self._outputs[cell].append(local_join.data)
        self._counts[("*",)] += total


# ---------------------------------------------------------------------------
# Torch dataplane backend
# ---------------------------------------------------------------------------


@dataclass
class DataplaneJoinResult:
    """Result of running a program on the data plane.  ``rows`` is the full
    exactly-once result multiset (over sorted(attset)) as int64.

    ``dispatches`` counts bucket calls (one per (op, bucket, attempt)) and
    ``bucket_stage_counts`` maps each op round to the per-dispatch batch
    sizes."""

    p: int
    count: int
    rows: Optional[np.ndarray]
    per_h_counts: Dict[Tuple[Attr, ...], int]
    retries: int = 0    # capacity-doubling retries triggered by overflow
    # one entry per retry: ((H, η), op round name, "slot" | "out" | "slot+out")
    retry_log: List[Tuple[Tuple, str, str]] = field(default_factory=list)
    dispatches: int = 0
    #: learned-caps store outcomes for this run: a caps hit means a work item
    #: started at the capacities a previous run converged to.
    caps_hits: int = 0
    caps_misses: int = 0
    caps_evictions: int = 0
    bucket_stage_counts: Dict[str, List[int]] = field(default_factory=dict)
    #: per-round wall time (µs), keyed by op round name — count rounds appear
    #: under "<round>/count": the totals of the ``round.<round>`` spans (a
    #: count pass's is ``round.<round>.count``), split by their ``dispatch``
    #: (host stacking), ``launch`` (host→device copies, enqueued kernels) and
    #: ``readback`` (the deferred device→host pull) spans.
    round_us: Dict[str, float] = field(default_factory=dict)


class DataplaneUnsupported(NotImplementedError):
    """The program contains an op type with no dataplane lowering rule."""


def _salt(*key, attempt: int = 0) -> int:
    """Stable 31-bit salt for the routing hashes (shared randomness: every
    host derives the same salt from the stage key alone).  ``attempt`` threads
    the overflow-retry count into the salt so a capacity-doubling retry also
    re-randomizes the routing."""
    h = hashlib.blake2b(repr((key, attempt)).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % (1 << 31)


def _pow2(n: int) -> int:
    """Round a capacity up to a power of two (≥ 16)."""
    return 1 << max(4, int(n - 1).bit_length() if n > 1 else 0)


def _quant(n: int) -> int:
    """Round an *exactly counted* capacity up onto the {2^k, 3·2^(k-1)} grid
    (≥ 16): ≤ 33% padding, and doubling a grid value stays on the grid."""
    p2 = _pow2(n)
    if p2 >= 32 and 3 * (p2 // 4) >= n:
        return 3 * (p2 // 4)
    return p2


def _pull_rows(rows, counts):
    """Pull (rows (s, p, cap[, w]), counts (s, p)) to the host; the valid
    rows' bytes count as ``d2h_row_bytes``, a part of the pull's
    ``d2h_bytes`` (the rest is capacity padding and the counts)."""
    rows, counts = to_host(rows), to_host(counts)
    width = rows.shape[3] if rows.ndim == 4 else 1
    count("d2h_row_bytes", int(counts.sum()) * width * rows.itemsize)
    return rows, counts


def _pack_radices(a_blocks, b_blocks, dup_pairs) -> Optional[np.ndarray]:
    """Eligibility check for packed int32 composite join keys.

    When every key column (cell, dup-attr...) is non-negative and the
    mixed-radix product (max_cell + 1) · Π (max_dup_i + 1) fits int32, the
    tuple packs collision-free into one int32 word.  Returns the per-dup-column
    radices, or None for the ranked fallback.  Padding rows are zeros, so
    block-level min/max (with 0) are exact bounds for the valid prefixes.
    The blocks are host arrays or tensors; a tensor's minima and maxima are
    computed where it lives and read back in one transfer."""
    if not dup_pairs:
        return None
    cols = [(0, 0)] + list(dup_pairs)
    a, b = torch.as_tensor(a_blocks), torch.as_tensor(b_blocks)
    ext = [torch.stack(torch.aminmax(x[:, :, c])) if x[:, :, c].numel()
           else torch.zeros(2, dtype=x.dtype, device=x.device)
           for ca, cb in cols for x, c in ((a, ca), (b, cb))]
    ext = torch.stack(ext).cpu().tolist()     # [[min, max]] of a's and b's columns
    lim = np.iinfo(np.int32).max
    space = 1
    rads = []
    for i in range(len(cols)):
        (a_lo, a_hi), (b_lo, b_hi) = ext[2 * i], ext[2 * i + 1]
        if min(a_lo, b_lo) < 0:
            return None
        hi = max(a_hi, b_hi, 0) + 1
        if i == 0:
            space = hi
        else:
            rads.append(hi)
            space *= hi
        if space > lim:
            return None
    return np.asarray(rads, dtype=np.int32)


@dataclass
class BatchRunStats:
    """Scheduler-level counters of one (possibly multi-program) executor run,
    once per batch (the per-query results carry them too)."""

    queries: int = 1
    dispatches: int = 0
    retries: int = 0
    retry_log: List[Tuple[Tuple, str, str]] = field(default_factory=list)
    caps_hits: int = 0
    caps_misses: int = 0
    caps_evictions: int = 0
    caps_quarantined: int = 0
    bucket_stage_counts: Dict[str, List[int]] = field(default_factory=dict)
    round_us: Dict[str, float] = field(default_factory=dict)


@dataclass
class _StageState:
    """State of one (H, η) stage as it flows through the ops.

    ``skip_count`` mirrors the simulator's geo.skip rule: a stage whose
    isolated R''_X is empty never reaches LocalJoin and contributes *no*
    per-H count entry; every other stage contributes one (possibly 0).
    ``skey`` stays query-unqualified so a stage's routing salts (and result
    bytes) do not depend on which other programs share the run."""

    stage: ProgramStage
    skey: Tuple
    program: Optional[RoundProgram] = None
    qi: int = 0
    light: Optional[List] = None          # [(scheme, blocks, counts, n_rows)]
    unary: Optional[Dict[Attr, List]] = None   # x -> [(vals, counts, n)] staged
    host_piece_n: Optional[Dict[Attr, int]] = None  # |R''_X| (host cross-check)
    pieces: Dict[Attr, Tuple] = field(default_factory=dict)   # x -> (vals, counts)
    piece_salt: Dict[Attr, int] = field(default_factory=dict)
    piece_n: Dict[Attr, int] = field(default_factory=dict)
    geo: Optional[StageGeometry] = None
    #: the routed fragments, from GridRoute or ShareRoute to the output
    #: chain: [(scheme incl. cell col, blocks on the device, counts, n)]
    routed: Optional[List] = None
    #: general route: per-relation fragments on the device, indexed by
    #: relation position — [(scheme, blocks, counts, n)], updated in place by
    #: the TreeSemiJoin sweeps, released once ShareRoute has taken them.
    gparts: Optional[List] = None
    n_out: int = 0
    rows: Optional[np.ndarray] = None
    empty: bool = False
    skip_count: bool = False


@dataclass
class _WorkItem:
    """One schedulable unit of an op — a (stage, fragment) pair.

    ``key`` is the static bucket signature (op kind, route spec, input block
    shapes); items sharing (key, caps) ride one dispatch.  ``group`` is the
    retry unit: a *slot* overflow re-randomizes the routing of every member
    at the next ``attempt``; an *out*-only overflow re-runs just the tripped
    members with a grown output buffer and the salts untouched, so row order
    never depends on capacity history."""

    state: _StageState
    key: Tuple
    caps: Dict[str, int]
    payload: Dict
    group: Tuple
    attempt: int = 0
    retries: int = 0
    result: object = None


@dataclass
class _Chain:
    """One stage's output chain, over all of its machines or a contiguous
    range of them (``machine_range``, absolute): ``parts`` [(scheme incl.
    the cell column, blocks (machines, cap, w) on the device, counts
    (machines,) on the host, valid rows)] in join order, and ``done``
    [(rows, compacted rows on the device or None)] of its finished ranges,
    in machine order.  ``tag`` keys its levels' buckets and ``group`` is
    their retry group (a slice's adds its machine range)."""

    state: _StageState
    parts: List
    tag: str
    group: Tuple
    machine_range: Optional[Tuple[int, int]] = None
    done: List = field(default_factory=list)

    def machines(self, lo: int, hi: int) -> "_Chain":
        """The chain over its machines [lo, hi): views of every part."""
        base = self.machine_range[0] if self.machine_range else 0
        parts = [(scheme, blocks[lo:hi], cnts[lo:hi], int(cnts[lo:hi].sum()))
                 for scheme, blocks, cnts, _ in self.parts]
        return _Chain(state=self.state, parts=parts, tag=self.tag, group=self.group,
                      machine_range=(base + lo, base + hi))


class DataplaneExecutor:
    """Runs compiled :class:`RoundProgram`\\ s among ``p`` machines held on
    one device.

      Scatter          host no-op (inputs are host-resident)
      RouteResidual    host carves Q'(η) per stage and blockifies the padded
                       residual blocks evenly onto the machines
      HashPartition    `batched_sharded_intersect`: unary residuals exchanged
                       by hash(value) and intersected into R''_X(η)
      SemiJoin         `batched_sharded_semijoin`: the light edges' X (phase
                       x / fused-route) or Y (phase y / fused-filter) column
                       filtered against the co-located pieces
      BroadcastSizes   piece counts (already on the host) → `stage_geometry`
      GridRoute        `batched_sharded_grid_route`: isolated pieces to their
                       CP cells, light residents to their HyperCube shares,
                       every copy tagged with its Lemma 3.2 virtual cell;
                       the routed blocks stay on the device
      LocalJoin        a chain of communication-free colocated joins keyed on
                       the cell column, its levels left on the device and
                       only the answer's rows pulled; a level past the
                       device's budget runs over slices of its machines
      TreeSemiJoin     general route: per join-tree edge, the filtering side's
                       packed keys `batched_sharded_intersect`-ed, then the
                       filtered side `batched_sharded_semijoin`-ed under the
                       same salt; keys built and fragments kept on the device
      ShareRoute       general route: every relation routed as GridRoute's
                       HyperCube side over the LP share grid (every attribute
                       a dimension); the routed blocks stay on the device
      CellJoin         general route: the LocalJoin chain, in the compiler's
                       join order

    Every call is *stage-batched*: work items with the same static signature
    and capacities form a geometry bucket whose inputs are stacked along a
    leading stage axis and run as one call.  Overflow is detected per stage
    and channel and read back once per (op, bucket); the retry re-runs just
    the overflowed stages at grown caps.  ``batch_stages=False`` dispatches
    every item as its own bucket; results and retries are identical.

    Args: ``p`` — machine count (a tensor axis, not a device count);
    ``device`` — where the data plane runs (default ``cuda``; raises without
    CUDA); ``slack`` — initial capacity headroom multiplier; ``max_retries``
    — capacity-doubling attempts before giving up; ``batch_stages`` —
    stage-batched vs per-stage scheduling; ``exact_caps`` — size the cell
    routes' and chains' buffers with an exchange-free counting pass (count-then-emit)
    instead of estimates + overflow retry; ``fault_plan`` — a
    :class:`~repro_torch.mpc.faults.FaultPlan` consulted at the dispatch,
    first-build and overflow-readback sites (None = no injection; a per-run
    ``RunConfig.fault_plan`` overrides it)."""

    _LOWERING = {
        Scatter: "_lower_scatter",
        RouteResidual: "_lower_route_residual",
        HashPartition: "_lower_hash_partition",
        SemiJoin: "_lower_semijoin",
        BroadcastSizes: "_lower_broadcast_sizes",
        GridRoute: "_lower_grid_route",
        LocalJoin: "_lower_local_join",
        TreeSemiJoin: "_lower_tree_semijoin",
        ShareRoute: "_lower_share_route",
        CellJoin: "_lower_cell_join",
    }

    #: executor-lifetime learned-caps entries kept before LRU eviction
    _LEARNED_CAPS_CAPACITY = 1 << 16

    def __init__(
        self,
        p: int,
        device=None,
        slack: int = 4,
        max_retries: int = 6,
        batch_stages: bool = True,
        exact_caps: bool = True,
        fault_plan=None,
    ):
        if p < 1:
            raise ValueError("p must be >= 1")
        self.p = p
        self.device = resolve_device(device)
        self.slack = slack
        self.max_retries = max_retries
        self.batch_stages = batch_stages
        #: grid-route fanouts within this pow2 ratio of their group max merge
        #: into the max's bucket (sentinel-padded)
        self.fanout_merge_ratio = 2
        #: capacities learned from previous runs, keyed by (round, group,
        #: static key, data fingerprint): a repeat run of the *same data*
        #: starts each work item at its last successful caps, so steady-state
        #: runs retry zero times.  LRU-bounded.
        self._learned_caps: "OrderedDict" = OrderedDict()
        self.caps_hits = 0
        self.caps_misses = 0
        self.caps_evictions = 0
        #: lifetime count of learned-caps entries dropped after failed runs
        self.caps_quarantined = 0
        self.exact_caps = exact_caps
        self.fault_plan = fault_plan
        #: (round, static key, caps) of every bucket built so far, LRU-bounded:
        #: the first build of one is where ``FaultPlan.at_compile`` fires
        self._built: "OrderedDict[Tuple, None]" = OrderedDict()
        self._deadline: Optional[float] = None
        self._fault_plan_run = None           # plan resolved for the active run
        self._tainted_caps: Optional[set] = None   # keys that saw injected overflow
        self._touched_caps: Optional[set] = None
        self._run_fps: Tuple[str, ...] = ()
        self._round_us: Dict[str, float] = {}

    # -- capacity guesses (pow2-bucketed; all are starting points for retry) --

    def _cap(self, n_total: int) -> int:
        """Per-machine receive/output capacity for n_total rows spread over p."""
        return _pow2(self.slack * (-(-max(1, n_total) // self.p)))

    def _slot_cap(self, n_total: int) -> int:
        """Per-(src, dst) send-slot capacity."""
        return _pow2(self.slack * (-(-max(1, n_total) // (self.p * self.p))))

    def _block_cap(self, n_total: int) -> int:
        """Host-staging block capacity (pow2 so geometry buckets coincide)."""
        return _pow2(-(-max(1, n_total) // self.p))

    # -- public entry ---------------------------------------------------------

    def run(self, program: RoundProgram, materialize: bool = True,
            config: Optional[RunConfig] = None) -> DataplaneJoinResult:
        results, _ = self.run_many([program], materialize=materialize, config=config)
        return results[0]

    def run_many(
        self,
        programs: List[RoundProgram],
        materialize: bool = True,
        config: Optional[RunConfig] = None,
    ) -> Tuple[List[DataplaneJoinResult], BatchRunStats]:
        """Run several compiled programs through ONE pass of the scheduler.

        Every program's stages become work items of the same op rounds, so
        stages of different queries landing in one geometry bucket share a
        dispatch.  The programs must have identical op sequences.  Results
        demultiplex exactly, and a stage's rows are byte-identical to a
        serial :meth:`run` of its program.  Returns ``(results, batch)``.

        ``config`` adds a monotonic-clock ``deadline`` checked between
        dispatches, a per-run ``fault_plan`` override and ``verify``, which
        runs the static verifier over every program and the learned-caps
        store before the first kernel launch.  On any failure the run's
        touched learned-caps entries are dropped before the exception
        propagates."""
        if config is not None:
            materialize = config.materialize
        if not programs:
            return [], BatchRunStats(queries=0)
        ops = programs[0].ops
        for prog in programs[1:]:
            if prog.ops != ops:
                raise ValueError(
                    "run_many needs coalescible programs (identical op "
                    f"sequences); got {programs[0].op_sequence()} vs "
                    f"{prog.op_sequence()}"
                )
        if config is not None and config.verify:
            for prog in programs:
                verify_program(prog, caps=self._learned_caps)
        self._retries = 0
        self._retry_log: List[Tuple[Tuple, str, str]] = []
        self._qi_retries: Dict[int, int] = defaultdict(int)
        self._qi_retry_log: Dict[int, List] = defaultdict(list)
        self._materialize = materialize
        self._dispatches = 0
        self._caps_hits = 0
        self._caps_misses = 0
        self._caps_evictions = 0
        self._caps_quarantined = 0
        self._bucket_log: Dict[str, List[int]] = {}
        self._round_us = {}
        self._deadline = config.deadline if config is not None else None
        self._fault_plan_run = (
            config.fault_plan if config is not None and config.fault_plan is not None
            else self.fault_plan
        )
        self._touched_caps = set()
        self._tainted_caps = set()
        with span("fingerprint"):
            digests = config.table_digests if config is not None else None
            if digests is None:     # a caller without the service's digests
                memo: Dict = {}
                chunks = partial(chunk_digests, device=self.device)
                digests = [relation_digests(p.query, memo, chunks) for p in programs]
            self._run_fps = tuple(self._program_fingerprint(p, d)
                                  for p, d in zip(programs, digests))
        states = [
            _StageState(stage=st, skey=(st.hkey, st.ekey), program=prog, qi=qi)
            for qi, prog in enumerate(programs)
            for st in prog.stages
        ]

        try:
            for op in ops:
                try:
                    lower = getattr(self, self._LOWERING[type(op)])
                except KeyError:
                    raise DataplaneUnsupported(
                        f"op {op!r} has no dataplane lowering rule"
                    ) from None
                live = [state for state in states if not state.empty]
                if live:
                    with span("op." + type(op).__name__):
                        lower(programs[0], live, op)
        except BaseException:
            self._quarantine_touched()
            raise
        finally:
            self._deadline = None
            self._fault_plan_run = None
            self._touched_caps = None
            self._tainted_caps = None
            self._run_fps = ()

        batch = BatchRunStats(
            queries=len(programs),
            dispatches=self._dispatches,
            retries=self._retries,
            retry_log=list(self._retry_log),
            caps_hits=self._caps_hits,
            caps_misses=self._caps_misses,
            caps_evictions=self._caps_evictions,
            caps_quarantined=self._caps_quarantined,
            bucket_stage_counts={k: list(v) for k, v in self._bucket_log.items()},
            round_us=dict(self._round_us),
        )
        results: List[DataplaneJoinResult] = []
        with span("assemble"):
            for qi, program in enumerate(programs):
                counts: Dict[Tuple[Attr, ...], int] = defaultdict(int)
                chunks: List[np.ndarray] = [row for _, row in program.emit]
                for hkey, c in program.emit_counts.items():
                    counts[hkey] += c
                for state in states:
                    if state.qi != qi or state.skip_count:
                        continue
                    counts[state.stage.hkey] += state.n_out
                    if state.rows is not None and state.rows.shape[0]:
                        chunks.append(state.rows)
                rows_out = None
                if materialize:
                    if len(chunks) == 1 and not program.emit:
                        rows_out = chunks[0]     # one stage's rows, made by this run
                    elif chunks:
                        rows_out = np.concatenate(chunks, axis=0)
                    else:
                        rows_out = np.zeros((0, len(program.out_cols)), dtype=np.int64)
                results.append(DataplaneJoinResult(
                    p=self.p,
                    count=sum(counts.values()),
                    rows=rows_out,
                    per_h_counts=dict(counts),
                    retries=self._qi_retries.get(qi, 0),
                    retry_log=list(self._qi_retry_log.get(qi, [])),
                    dispatches=batch.dispatches,
                    caps_hits=batch.caps_hits,
                    caps_misses=batch.caps_misses,
                    caps_evictions=batch.caps_evictions,
                    bucket_stage_counts={k: list(v) for k, v in batch.bucket_stage_counts.items()},
                    round_us=dict(batch.round_us),
                ))
        return results, batch

    # -- robustness hooks ------------------------------------------------------

    def _check_deadline(self, round_name: str) -> None:
        """Raise :class:`DeadlineExceededError` once the run's monotonic
        budget is spent (checked between dispatches only)."""
        dl = self._deadline
        if dl is not None and time.monotonic() > dl:
            raise DeadlineExceededError(
                f"deadline exceeded before op round {round_name!r} dispatch",
                op_round=round_name,
                deadline_s=dl,
            )

    def _quarantine_touched(self) -> None:
        """Drop every learned-caps entry the active (failed) run touched."""
        for k in self._touched_caps or ():
            if self._learned_caps.pop(k, None) is not None:
                self._caps_quarantined += 1
                self.caps_quarantined += 1

    @staticmethod
    def _program_fingerprint(program, digests: Sequence[bytes]) -> str:
        """Content key of a program's bound input tables, from each relation's
        scheme and :func:`~repro_torch.core.query.table_digest`: learned caps
        are only guaranteed sufficient for the data they were learned on."""
        h = hashlib.blake2b(digest_size=8)
        for rel, digest in zip(program.query.relations, digests):
            h.update(repr(tuple(rel.scheme)).encode())
            h.update(digest)
        return h.hexdigest()

    def _caps_key(self, round_name: str, it) -> Tuple:
        fps = self._run_fps
        fp = fps[it.state.qi] if it.state.qi < len(fps) else None
        return (round_name, it.group, it.key, fp)

    # -- stage-batched scheduler ----------------------------------------------

    @staticmethod
    def _pow2_stages(s: int) -> int:
        """Pad the stage axis to a power of two (bounded shape count)."""
        return 1 << max(0, int(s - 1).bit_length())

    @staticmethod
    def _stack(arrs, s_pad: int):
        """Stack per-stage blocks along a new leading stage axis and zero-pad
        to ``s_pad`` (padded stages carry count 0 — inert rows that cannot
        overflow).  Host arrays stack on the host, tensors where they live;
        a lone tensor that needs no padding is viewed, not copied."""
        arrs = list(arrs)
        if isinstance(arrs[0], torch.Tensor):
            if len(arrs) == s_pad == 1:
                return arrs[0][None]
            x = torch.stack(arrs)
            if x.shape[0] < s_pad:
                x = torch.cat([x, x.new_zeros((s_pad - x.shape[0],) + tuple(x.shape[1:]))])
            return x
        x = np.stack(arrs)
        if x.shape[0] < s_pad:
            x = np.concatenate([x, np.zeros((s_pad - x.shape[0],) + x.shape[1:], x.dtype)])
        return x

    @staticmethod
    def _rows_counts_post(outs, s: int):
        """Postprocessor for (rows, counts, ovf) primitives: slice off the
        stage padding and defer the host pull to ``finalize``."""
        out, c, ovf = outs

        def finalize(out=out, c=c):
            out, c = _pull_rows(out[:s], c[:s])
            return [(out[i], c[i]) for i in range(s)]

        return finalize, ovf[:s]

    @staticmethod
    def _device_rows_post(outs, s: int):
        """Postprocessor for (rows, counts, ovf) primitives whose rows stay on
        the device for the next op: ``finalize`` pulls only the counts and
        gives (rows, counts on the device, counts on the host)."""
        out, c, ovf = outs

        def finalize(out=out, c=c):
            c_host = to_host(c[:s])
            return [(out[i], c[i], c_host[i]) for i in range(s)]

        return finalize, ovf[:s]

    @staticmethod
    def _hist_post(outs, s: int):
        """Postprocessor for count-only routes: (s, p_src, p_dst) histograms,
        structurally overflow-free."""
        (hist,) = outs

        def finalize(hist=hist):
            h = to_host(hist[:s])
            return [h[i] for i in range(s)]

        return finalize, np.zeros((s, 1, 2), np.int32)

    @staticmethod
    def _count_post(outs, s: int):
        """Postprocessor for count-only joins: (s, p) match totals."""
        cnt, ovf = outs

        def finalize(cnt=cnt):
            c = to_host(cnt[:s])
            return [c[i] for i in range(s)]

        return finalize, ovf[:s]

    def _run_buckets(self, round_name: str, items: List[_WorkItem], dispatch):
        """The one scheduling + retry harness every lowering rule runs on.

        Groups ``items`` by (static key, caps) into buckets, builds each
        bucket's call with ``dispatch(bucket) -> (fn, args, post)``, launches
        every bucket, then reads each bucket back once — ``post(fn(*args))``
        gives ``(finalize, ovf (s, p, 2))``.  A *slot* trip re-buckets the
        whole retry group at ``attempt + 1`` (fresh salts); an *out*-only trip
        re-buckets just the tripped items with their output channel grown.
        The round is the span ``round.<round name>`` (a ``/`` in the name
        reads ``.``), its total the round's ``round_us``."""
        if not items:
            return items
        self._check_deadline(round_name)
        with span("round." + round_name.replace("/", ".")) as sp:
            self._schedule(round_name, items, dispatch)
        self._round_us[round_name] = self._round_us.get(round_name, 0.0) + sp.us
        return items

    def _schedule(self, round_name: str, items: List[_WorkItem], dispatch) -> None:
        fp = self._fault_plan_run
        # learned capacities: start each item at the caps its slot ended the
        # previous run with
        for it in items:
            k = self._caps_key(round_name, it)
            learned = self._learned_caps.get(k)
            if self._touched_caps is not None and it.caps:
                self._touched_caps.add(k)
            if learned:
                self._learned_caps.move_to_end(k)
                for ch in it.caps:
                    it.caps[ch] = max(it.caps[ch], learned[ch])
            if it.caps:
                if learned:
                    self._caps_hits += 1
                    self.caps_hits += 1
                else:
                    self._caps_misses += 1
                    self.caps_misses += 1
        # cap harmonization: items sharing a static key (per query) start
        # from the group max per channel — a pure function of the round's
        # item set, so batched and unbatched schedules see identical caps
        by_key: Dict[Tuple, List[_WorkItem]] = {}
        for it in items:
            by_key.setdefault((it.state.qi, it.key), []).append(it)
        for group in by_key.values():
            for ch in group[0].caps:
                m = max(g.caps[ch] for g in group)
                for g in group:
                    g.caps[ch] = m
        pending = list(items)
        while pending:
            self._check_deadline(round_name)
            buckets: Dict[Tuple, List[_WorkItem]] = {}
            for it in pending:
                bkey = (it.key, tuple(sorted(it.caps.items())))
                if not self.batch_stages:
                    bkey = bkey + (id(it),)     # force singleton buckets
                buckets.setdefault(bkey, []).append(it)

            with span("dispatch"):
                prepared = []
                for bucket in buckets.values():
                    # nothing is compiled ahead of a dispatch here, so the first
                    # build of a (round, key, caps) bucket stands where the
                    # reference's executable-cache miss compiles: the compile
                    # fault site fires there
                    sig = (round_name, bucket[0].key, tuple(sorted(bucket[0].caps.items())))
                    if sig in self._built:
                        self._built.move_to_end(sig)
                    else:
                        if fp is not None:
                            fp.at_compile(round_name)
                        self._built[sig] = None
                        while len(self._built) > self._LEARNED_CAPS_CAPACITY:
                            self._built.popitem(last=False)
                    prepared.append((bucket, *dispatch(bucket)))
                    self._dispatches += 1
                    self._bucket_log.setdefault(round_name, []).append(len(bucket))

            with span("launch"):
                launched = []
                for bucket, fn, args, post in prepared:
                    self._check_deadline(round_name)
                    if fp is not None:
                        fp.at_dispatch(round_name)
                    launched.append((bucket, *post(fn(*args))))

            # one deferred readback per (op, bucket), after every bucket of
            # the round is enqueued
            with span("readback"):
                tripped: Dict[int, set] = {}
                for bucket, finalize, ovf in launched:
                    ovf_np = to_host(ovf)
                    results = finalize()
                    for i, it in enumerate(bucket):
                        tot = ovf_np[i].reshape(-1, 2).sum(axis=0)
                        kinds = set()
                        if int(tot[0]):
                            kinds.add("slot")
                        if int(tot[1]):
                            kinds.add("out")
                        if fp is not None:
                            # injected overflow: forced channels read exactly like
                            # real trips (doubling, re-salting, retry accounting),
                            # but the item's learned-caps slot is tainted so the
                            # inflated caps are never written back
                            forced = {ch for ch in fp.overflow(round_name) if ch in it.caps}
                            if forced:
                                kinds |= forced
                                if self._tainted_caps is not None:
                                    self._tainted_caps.add(self._caps_key(round_name, it))
                        tripped[id(it)] = kinds
                        it.result = results[i]

            group_kinds: Dict[Tuple, set] = {}
            for it in pending:
                if tripped[id(it)]:
                    group_kinds.setdefault(it.group, set()).update(tripped[id(it)])

            retry: List[_WorkItem] = []
            logged = set()
            for it in pending:          # original item order → deterministic log
                kinds = group_kinds.get(it.group)
                if not kinds:
                    continue
                resalt = "slot" in kinds
                if not resalt and not tripped[id(it)]:
                    continue
                if it.group not in logged:
                    logged.add(it.group)
                    self._retries += 1
                    entry = (it.state.skey, round_name, "+".join(sorted(kinds)))
                    self._retry_log.append(entry)
                    for qi in sorted({
                        x.state.qi for x in pending
                        if x.group == it.group and (resalt or tripped[id(x)])
                    }):
                        self._qi_retries[qi] += 1
                        self._qi_retry_log[qi].append(entry)
                # grow only the tripped channels: ×2 on the first retry, ×4 after
                for ch in tripped[id(it)]:
                    it.caps[ch] *= 2 if it.retries == 0 else 4
                if resalt:
                    it.attempt += 1
                it.retries += 1
                if it.retries > self.max_retries:
                    raise RetryExhaustedError(
                        f"stage {it.state.skey} op {round_name} still overflows "
                        f"after {self.max_retries} capacity doublings",
                        stage=it.state.skey,
                        op_round=round_name,
                        attempts=it.retries,
                        attempt_log=tuple(self._retry_log),
                    )
                retry.append(it)
            pending = retry
        quarantined: set = set()
        for it in items:
            if not it.caps:        # count-only rounds carry no capacities
                continue
            k = self._caps_key(round_name, it)
            if self._tainted_caps is not None and k in self._tainted_caps:
                # caps doubled by *injected* overflow: the data never needed
                # them, so writing them back would pin the steady state at
                # fault-inflated buffer sizes
                if k not in quarantined:
                    quarantined.add(k)
                    self._learned_caps.pop(k, None)
                    self._caps_quarantined += 1
                    self.caps_quarantined += 1
                continue
            self._learned_caps[k] = dict(it.caps)
            self._learned_caps.move_to_end(k)
        while len(self._learned_caps) > self._LEARNED_CAPS_CAPACITY:
            self._learned_caps.popitem(last=False)
            self._caps_evictions += 1
            self.caps_evictions += 1

    def _apply_exact_caps(self, round_name, items, count_dispatch, caps_from_count, floor):
        """Count-then-emit capacity sizing (``exact_caps=True``): items with
        no learned caps run through an exchange-free ``<round>/count`` pass
        (same destination / key algebra, same attempt-0 salts) and get their
        emit caps exactly from it; items with learned caps skip the count and
        start at ``floor`` (below any learned value, so the learned caps win)."""
        fresh = [it for it in items if not self._learned_caps.get(self._caps_key(round_name, it))]
        fresh_ids = {id(it) for it in fresh}
        for it in items:
            if id(it) not in fresh_ids:
                it.caps = dict(floor)
        if not fresh:
            return
        counters = [
            _WorkItem(state=it.state, key=it.key, caps={}, payload=it.payload, group=it.group)
            for it in fresh
        ]
        self._run_buckets(round_name + "/count", counters, count_dispatch)
        for cit, it in zip(counters, fresh):
            it.caps = caps_from_count(cit.result)

    # -- per-op lowering rules (each batches every live stage of the op) ------

    def _lower_scatter(self, program: RoundProgram, states, op) -> None:
        """Scatter costs no load in the MPC model; the inputs stay host-side
        until RouteResidual stages the carved residuals."""

    def _lower_route_residual(self, program, states, op) -> None:
        # residual carving is per program, each with its own histogram
        groups: Dict[int, List[_StageState]] = {}
        for state in states:
            groups.setdefault(state.qi, []).append(state)
        for qi in sorted(groups):
            pstates = groups[qi]
            self._route_residual_one(pstates[0].program, pstates)

    def _route_residual_one(self, program, states) -> None:
        from ..dataplane.exchange import blockify

        query, stats = program.query, program.stats
        with span("carve"):
            masks = heavy_masks(query, stats)   # once per run, not once per stage
            ordered = sorted_rows(query)        # likewise, once per distinct table
            staged_states = []
            for state in states:
                plan = state.stage.plan
                residuals = residual_relations(query, stats, plan, state.stage.cfg.eta,
                                               masks=masks, ordered=ordered)
                if residuals is None:
                    raise RuntimeError(
                        f"stage {state.skey} compiled for an infeasible η — compiler bug"
                    )
                # rows carved, and those of unsorted parents, which np.unique built
                count("rows", sum(len(r) for r in residuals.values()))
                count("dedup_rows", sum(len(r) for (e, _), r in residuals.items()
                                        if not ordered[e]))
                # host view of R''_X = ∩ unary pieces decides the stage's fate the
                # way the simulator's geometry does
                host_piece: Dict[Attr, np.ndarray] = {}
                for x in plan.border:
                    vals = None
                    for e in plan.cross_edges:
                        if x not in e:
                            continue
                        pv = residuals[(e, (x,))].data[:, 0]   # sorted and unique
                        vals = pv if vals is None else np.intersect1d(vals, pv, assume_unique=True)
                    host_piece[x] = vals
                if any(host_piece[x].size == 0 for x in plan.isolated):
                    state.empty, state.skip_count = True, True
                    continue
                if any(v.size == 0 for v in host_piece.values()):
                    state.empty = True
                    continue
                if any(len(residuals[(e, query.relation_for(e).scheme)]) == 0
                       for e in plan.light_edges):
                    state.empty = True
                    continue
                state.host_piece_n = {x: int(v.size) for x, v in host_piece.items()}
                staged_states.append((state, residuals))

        with span("stage"):
            # program-wide unary block capacity and piece count: every stage's
            # staged R''_X inputs share one shape, so the HashPartition
            # intersects coalesce into one bucket
            unary_cap, n_pieces = 1, 1
            for state, residuals in staged_states:
                plan = state.stage.plan
                for x in plan.border:
                    es = [e for e in plan.cross_edges if x in e]
                    n_pieces = max(n_pieces, len(es))
                    for e in es:
                        unary_cap = max(unary_cap, self._block_cap(len(residuals[(e, (x,))])))

            for state, residuals in staged_states:
                plan = state.stage.plan
                state.light = []
                for e in plan.light_edges:
                    rel = residuals[(e, query.relation_for(e).scheme)]
                    blocks, cnts = blockify(rel.data, self.p, self._block_cap(len(rel)))
                    state.light.append((list(query.relation_for(e).scheme), blocks, cnts, len(rel)))
                state.unary = {}
                for x in plan.border:
                    staged = []
                    for e in plan.cross_edges:
                        if x not in e:
                            continue
                        r = residuals[(e, (x,))]
                        bv, bc = blockify(r.data[:, 0], self.p, unary_cap)
                        staged.append((bv[:, :, 0], bc, len(r)))
                    # padding with a repeat of the last piece is an intersection
                    # no-op (A ∩ A = unique(A)) that gives every stage one shape
                    while len(staged) < n_pieces:
                        staged.append(staged[-1])
                    state.unary[x] = staged

    def _lower_hash_partition(self, program, states, op) -> None:
        from ..dataplane.exchange import salt_offset
        from ..dataplane.join import batched_sharded_intersect

        with span("stage"):
            items: List[_WorkItem] = []
            for state in states:
                for x, staged in state.unary.items():
                    n_max = max(n for _, _, n in staged)
                    items.append(_WorkItem(
                        state=state,
                        key=("intersect", tuple(bv.shape for bv, _, _ in staged)),
                        caps={"slot": self._slot_cap(n_max), "out": self._cap(n_max)},
                        payload={"x": x, "staged": staged},
                        group=("intersect", state.skey, x),
                    ))

        def dispatch(bucket):
            s, s_pad = len(bucket), self._pow2_stages(len(bucket))
            n_pieces = len(bucket[0].payload["staged"])
            pieces = [
                (
                    self._stack([it.payload["staged"][i][0] for it in bucket], s_pad),
                    self._stack([it.payload["staged"][i][1] for it in bucket], s_pad),
                )
                for i in range(n_pieces)
            ]
            salts = [_salt(it.state.skey, it.payload["x"], attempt=it.attempt) for it in bucket]
            offs = np.asarray([salt_offset(v) for v in salts] + [0] * (s_pad - s), np.int32)
            caps = bucket[0].caps
            fn, args = batched_sharded_intersect(
                pieces, offs, cap_slot=caps["slot"], cap_out=caps["out"],
                device=self.device, invoke=False,
            )

            def post(outs, salts=salts, s=s):
                vals, cnts, ovf = outs

                def finalize(vals=vals, cnts=cnts):
                    vals, cnts = _pull_rows(vals[:s], cnts[:s])
                    return [(vals[i], cnts[i], salts[i]) for i in range(s)]

                return finalize, ovf[:s]

            return fn, args, post

        for it in self._run_buckets(op.round, items, dispatch):
            state, x = it.state, it.payload["x"]
            vals, cnts, salt = it.result
            total = int(cnts.sum())
            if total != state.host_piece_n[x]:
                raise RuntimeError(
                    f"stage {state.skey}: device |R''_{x}| = {total} != host "
                    f"{state.host_piece_n[x]} — routing bug"
                )
            state.pieces[x] = (vals, cnts)
            state.piece_salt[x] = salt
            state.piece_n[x] = total

    def _lower_semijoin(self, program, states, op) -> None:
        """Phase x (and fused-route) filters column 0, phase y (and
        fused-filter) column 1."""
        from ..dataplane.exchange import salt_offset
        from ..dataplane.join import batched_sharded_semijoin

        if op.phase in ("x", "fused-route"):
            col = 0
        elif op.phase in ("y", "fused-filter"):
            col = 1
        else:
            raise DataplaneUnsupported(f"SemiJoin phase {op.phase!r}")

        with span("stage"):
            items: List[_WorkItem] = []
            for state in states:
                for idx, (scheme, blocks, cnts, n) in enumerate(state.light):
                    attr = scheme[col]
                    if attr not in state.pieces:
                        continue
                    pv, pc = state.pieces[attr]
                    items.append(_WorkItem(
                        state=state,
                        key=("semijoin", col, tuple(blocks.shape), tuple(pv.shape)),
                        caps={"slot": self._slot_cap(n), "out": self._cap(n)},
                        payload={"idx": idx, "attr": attr, "blocks": blocks,
                                 "cnts": cnts, "pv": pv, "pc": pc},
                        group=("semijoin", state.skey, idx),
                    ))

        def dispatch(bucket):
            s, s_pad = len(bucket), self._pow2_stages(len(bucket))
            rows = self._stack([it.payload["blocks"] for it in bucket], s_pad)
            cnts = self._stack([it.payload["cnts"] for it in bucket], s_pad)
            pv = self._stack([it.payload["pv"] for it in bucket], s_pad)
            pc = self._stack([it.payload["pc"] for it in bucket], s_pad)
            # the exchange salt is pinned to the piece's distribution salt
            # (rows must land where HashPartition put the piece)
            offs = np.asarray(
                [salt_offset(it.state.piece_salt[it.payload["attr"]]) for it in bucket]
                + [0] * (s_pad - s),
                np.int32,
            )
            caps = bucket[0].caps
            fn, args = batched_sharded_semijoin(
                rows, cnts, col, offs, pv, pc, cap_slot=caps["slot"], cap_out=caps["out"],
                device=self.device, invoke=False,
            )
            return fn, args, partial(self._rows_counts_post, s=s)

        for it in self._run_buckets(op.round, items, dispatch):
            state, idx = it.state, it.payload["idx"]
            scheme = state.light[idx][0]
            blocks, cnts = it.result
            n2 = int(cnts.sum())
            state.light[idx] = (scheme, blocks, cnts, n2)
            if n2 == 0:
                state.empty = True

    def _lower_broadcast_sizes(self, program, states, op) -> None:
        """The O(p²) size round: the per-machine piece counts crossed to the
        host with the HashPartition readback; `stage_geometry` turns them
        into the stage's CP grid × HyperCube shape and the global-id offsets."""
        with span("stage"):
            for state in states:
                entries: Dict[Attr, List[Tuple[int, int]]] = {
                    x: list(enumerate(int(c) for c in state.pieces[x][1].tolist()))
                    for x in state.stage.plan.isolated
                }
                state.geo = stage_geometry(state.program, state.stage, entries)
                if state.geo.skip:
                    state.empty, state.skip_count = True, True

    def _lower_grid_route(self, program, states, op) -> None:
        """The binary route's output routing, over each stage's CP grid ×
        HyperCube (`_route_to_cells`): the light fragments to their HyperCube
        shares, all of a stage's in one retry group, then the isolated
        pieces to their CP cells by global id (no salts), each its own
        group — the chain's parts in that order."""
        from ..dataplane.grid import cp_batch_params

        with span("stage"):
            frags = []
            for state in states:
                geo = state.geo
                if geo is None:
                    raise DataplaneUnsupported("GridRoute before BroadcastSizes")
                if geo.cp_size * geo.hc_size >= 1 << 31:
                    raise RuntimeError(f"stage {state.skey}: virtual grid exceeds int32")
                light = state.light or []
                state.routed = [None] * (len(light) + len(geo.iso_order))
                for pos, (scheme, blocks, cnts, n) in enumerate(light):
                    frags.append((state, pos, {
                        "kind": "hc", "tag": "hc", "group": ("hc", state.skey),
                        "grid": geo.hc_grid, "cp_size": geo.cp_size,
                        "scheme": scheme, "blocks": blocks, "cnts": cnts, "n": n,
                    }))
                for li, x in enumerate(geo.iso_order):
                    vals, cnts = state.pieces[x]
                    dim, scale, table = cp_batch_params(geo.grid, li, geo.hc_size)
                    offsets = np.asarray([geo.offsets[(x, dev)] for dev in range(self.p)],
                                         dtype=np.int64)
                    frags.append((state, len(light) + li, {
                        "kind": "cp", "tag": "cp", "group": ("cp", state.skey, x),
                        "scheme": [x], "vals": vals, "cnts": cnts, "offsets": offsets,
                        "dim": dim, "scale": scale, "table": table, "n": state.piece_n[x],
                    }))
        self._route_to_cells(op, frags)

    def _route_to_cells(self, op, frags) -> None:
        """Route fragments to their virtual cells through
        `batched_sharded_grid_route`, the routed blocks left on the device.

        ``frags`` is [(state, pos, fragment)]; a fragment is a dict of its
        ``kind`` — "hc", a relation's rows (``scheme``, ``blocks``)
        replicated to the cells of a HyperCube ``grid`` laid over
        ``cp_size`` CP cells that agree with their hashed coordinates, or
        "cp", an isolated piece's values (``scheme`` [x], ``vals``) sent to
        their cartesian cells by global id (``offsets``, ``dim``, ``scale``, ``table``) —
        its ``tag`` (the hashes' salt input and the bucket key's), its retry
        ``group``, ``cnts`` and ``n``.  Within a (query, kind, columns)
        group a fanout within ``fanout_merge_ratio`` of the group's largest
        pads to it (sentinel copies are ghosted), so the fragments share
        buckets; with ``exact_caps`` a count pass sizes the emit.  Sets
        ``state.routed[pos]`` to (scheme incl. the cell column, blocks on the
        device, counts on the host, valid rows)."""
        from ..dataplane.grid import (
            CPBatchSig,
            HCBatchSig,
            _pad_table,
            batched_sharded_grid_route,
            batched_sharded_grid_route_count,
            hc_batch_params,
        )

        with span("stage"):
            for _, _, fr in frags:
                if fr["kind"] == "hc":
                    fr["cols"], fr["shares"], fr["strides"], fr["table"] = hc_batch_params(
                        fr["grid"], fr["scheme"], fr["cp_size"])
            group_fanout: Dict[Tuple, int] = {}
            for state, _, fr in frags:
                gk = (state.qi, fr["kind"], fr.get("cols"))
                group_fanout[gk] = max(group_fanout.get(gk, 1), len(fr["table"]))

            items: List[_WorkItem] = []
            for state, pos, fr in frags:
                f_max = _pow2(group_fanout[(state.qi, fr["kind"], fr.get("cols"))])
                own = _pow2(len(fr["table"]))
                fanout = f_max if own * self.fanout_merge_ratio >= f_max else own
                copies = fr["n"] * len(fr["table"])
                # replicating routes are lumpier than hash exchanges: start the
                # slot channel at double slack
                caps = {"slot": 2 * self._slot_cap(copies), "out": self._cap(copies)}
                if fr["kind"] == "hc":
                    sig, shape = HCBatchSig(cols=fr["cols"], fanout=fanout), fr["blocks"].shape
                else:
                    sig, shape = CPBatchSig(fanout=fanout), fr["vals"].shape
                items.append(_WorkItem(
                    state=state, key=(fr["tag"], sig, tuple(shape)), caps=caps,
                    payload={"pos": pos, "sig": sig, **fr}, group=fr["group"],
                ))

        def make_dispatch(count: bool):
            def dispatch(bucket):
                s, s_pad = len(bucket), self._pow2_stages(len(bucket))
                sig = bucket[0].payload["sig"]
                caps = bucket[0].caps
                pad = s_pad - s
                cnts = self._stack([it.payload["cnts"] for it in bucket], s_pad)
                table = np.stack(
                    [_pad_table(it.payload["table"], sig.fanout) for it in bucket]
                    + [np.full((sig.fanout,), -1, np.int32)] * pad
                )
                route = batched_sharded_grid_route_count if count else batched_sharded_grid_route
                kw = {} if count else {"cap_slot": caps["slot"], "cap_out": caps["out"]}
                if bucket[0].payload["kind"] == "hc":
                    rows = self._stack([it.payload["blocks"] for it in bucket], s_pad)
                    nf = len(sig.cols)
                    salts = np.ones((s_pad, nf), dtype=np.uint32)
                    shares = np.ones((s_pad, nf), dtype=np.uint32)
                    strides = np.zeros((s_pad, nf), dtype=np.int32)
                    for i, it in enumerate(bucket):
                        scheme = it.payload["scheme"]
                        salts[i] = [
                            _salt(it.state.skey, it.payload["tag"], scheme[c], attempt=it.attempt)
                            for c in sig.cols
                        ]
                        shares[i] = it.payload["shares"]
                        strides[i] = it.payload["strides"]
                    fn, args = route(
                        rows, cnts, sig, salts=salts, shares=shares, strides=strides,
                        table=table, device=self.device, invoke=False, **kw,
                    )
                else:
                    rows = self._stack([it.payload["vals"][:, :, None] for it in bucket], s_pad)
                    offsets = self._stack(
                        [np.asarray(it.payload["offsets"], np.int32) for it in bucket], s_pad
                    )
                    dims = np.asarray([it.payload["dim"] for it in bucket] + [1] * pad, np.int32)
                    scales = np.asarray(
                        [it.payload["scale"] for it in bucket] + [0] * pad, np.int32
                    )
                    fn, args = route(
                        rows, cnts, sig, offsets=offsets, dims=dims, scales=scales,
                        table=table, device=self.device, invoke=False, **kw,
                    )
                if count:
                    return fn, args, partial(self._hist_post, s=s)
                return fn, args, partial(self._device_rows_post, s=s)
            return dispatch

        if self.exact_caps:
            self._apply_exact_caps(
                op.round, items, make_dispatch(count=True),
                caps_from_count=lambda h: {
                    "slot": _quant(max(1, int(h.max()))),
                    "out": _quant(max(1, int(h.sum(axis=0).max()))),
                },
                floor={"slot": 16, "out": 16},
            )

        for it in self._run_buckets(op.round, items, make_dispatch(count=False)):
            rows, _, cnts = it.result
            it.state.routed[it.payload["pos"]] = (["#cell"] + list(it.payload["scheme"]),
                                                  rows, cnts, int(cnts.sum()))

    def _make_colocated_dispatch(self, count: bool):
        """Bucket dispatch for one level of in-cell colocated joins: the
        count pass, or the emit, whose rows stay on the device (only counts
        and overflow are read back)."""
        from ..dataplane.join import (
            batched_sharded_colocated_join,
            batched_sharded_colocated_join_count,
        )

        def dispatch(bucket):
            s, s_pad = len(bucket), self._pow2_stages(len(bucket))
            a = self._stack([it.payload["a"][0] for it in bucket], s_pad)
            ac = self._stack([it.payload["a"][1] for it in bucket], s_pad)
            b = self._stack([it.payload["b"][0] for it in bucket], s_pad)
            bc = self._stack([it.payload["b"][1] for it in bucket], s_pad)
            km = None
            if bucket[0].key[4]:
                # padded stages carry radix 1: their rows are all zeros, so
                # the packed key stays 0 and in bounds
                km = np.stack(
                    [it.payload["mults"] for it in bucket]
                    + [np.ones_like(bucket[0].payload["mults"])] * (s_pad - s)
                )
            dup_pairs = bucket[0].payload["dup_pairs"]
            if count:
                fn, args = batched_sharded_colocated_join_count(
                    a, ac, b, bc, 0, 0, dup_pairs=dup_pairs, key_mults=km,
                    device=self.device, invoke=False,
                )
                return fn, args, partial(self._count_post, s=s)
            fn, args = batched_sharded_colocated_join(
                a, ac, b, bc, 0, 0, cap_out=bucket[0].caps["out"], dup_pairs=dup_pairs,
                key_mults=km, device=self.device, invoke=False,
            )
            return fn, args, partial(self._device_rows_post, s=s)
        return dispatch

    def _lower_local_join(self, program, states, op) -> None:
        """The binary route's output: all fragments of a virtual cell live on
        machine cell % p, so the per-cell join is a chain of colocated joins
        on the cell column (`_run_chains`) — attributes shared beyond the
        cell folded into the join key, disconnected components and CP lists
        combined as in-cell cartesian factors.  The parts are ordered once,
        greedily by shared attributes (`_greedy_order`)."""
        chains = []
        for state in states:
            if state.routed is None:
                raise DataplaneUnsupported("LocalJoin before GridRoute")
            chains.append(_Chain(state=state, parts=self._greedy_order(state.routed),
                                 tag="join", group=("join", state.skey)))
            state.routed = None             # the chain holds the fragments now
        self._run_chains(op, chains)

    @staticmethod
    def _greedy_order(parts) -> List:
        """The binary route's chain order: after the first part, each next
        one the remaining part sharing the most attributes with the parts
        before it (ties → the earliest), swapped into place.  It reads the
        schemes alone, so every slice of a chain keeps it."""
        parts = list(parts)
        joined = set(parts[0][0][1:])
        for i in range(1, len(parts)):
            j = max(range(i, len(parts)),
                    key=lambda j: (len(joined.intersection(parts[j][0])), -j))
            parts[i], parts[j] = parts[j], parts[i]
            joined.update(parts[i][0][1:])
        return parts

    def _run_chains(self, op, chains) -> None:
        """Run the output ``chains`` (`_join_chain`) and pull each stage's
        answer to the host.

        Where rows cross to the host: the routed fragments are on the device,
        and every level's rows stay there as the next level's input (only
        each level's counts and overflow flags are read back, and the
        packing radices' minima and maxima).  When a stage's chain has one
        part left, its valid rows are compacted on the device into the
        output column order, and only those rows are pulled, once per stage,
        in the ``assemble`` span, and widened to int64.

        Counters: ``level_rows_max``, the most valid rows one level held on
        the device at once (a slice's, where sliced); ``pulled_rows``, the
        rows pulled to the host."""
        count("level_rows_max", self._join_chain(op, chains))

        with span("assemble"):
            for chain in chains:
                state = chain.state
                state.n_out = sum(n for n, _ in chain.done)
                pieces = [rows for n, rows in chain.done if n and rows is not None]
                chain.done = []
                if not pieces:
                    continue
                rows = to_host(pieces[0] if len(pieces) == 1 else torch.cat(pieces))
                del pieces
                count("d2h_row_bytes", rows.nbytes)
                count("pulled_rows", rows.shape[0])
                # widened on the host by torch, which spreads it over the cores
                state.rows = torch.from_numpy(rows).to(torch.int64).numpy()

    def _join_chain(self, op, chains) -> int:
        """Run ``chains`` to their last level, every chain still joining
        batched into each level; a level joins each chain's first two parts
        and leaves their rows on the device.  Each chain ends with its
        compacted rows in ``done``.  → the most valid rows one level held.

        When a level is sliced: once its capacities are known (counted, or
        learned), a level whose working bytes (`_level_bytes`) pass
        `_level_budget` — half of what the device's allocator can still hand
        out — runs over contiguous ranges of machines instead, each range
        taking the rest of the chain (further sliced where needed) before
        the next, in a ``slice`` span.  A machine's rows do not depend on the
        other machines, so the rows and their order are those of the
        unsliced chain."""
        most = 0
        while True:
            active = [chain for chain in chains if len(chain.parts) >= 2]
            if not active:
                break
            with span("stage"):
                items = [self._chain_item(chain) for chain in active]
            if self.exact_caps:
                self._apply_exact_caps(
                    op.round, items, self._make_colocated_dispatch(count=True),
                    caps_from_count=lambda c: {"out": _quant(max(1, int(c.max())))},
                    floor={"out": 16},
                )
            per = self._slice_width(items)
            if per is None:
                most = max(most, self._chain_level(op, items))
                del items
                continue
            del items
            width = active[0].parts[0][1].shape[0]
            for lo in range(0, width, per):
                with span("slice"):
                    subs = [chain.machines(lo, min(width, lo + per)) for chain in active]
                    most = max(most, self._join_chain(op, subs))
                    for chain, sub in zip(active, subs):
                        chain.done += sub.done
                    del subs
            for chain in active:
                chain.parts = []
        with span("assemble"):
            for chain in chains:
                if len(chain.parts) == 1:
                    self._finish_chain(chain)
        return most

    def _chain_item(self, chain) -> _WorkItem:
        """The work item of a chain's next level: its first two parts (scheme
        incl. the cell column, blocks, counts, valid rows) joined on the cell
        column, attributes shared beyond the cell folded into the key via
        ``dup_pairs``; the output scheme is the first's followed by the
        second's new attributes."""
        (a_scheme, a_blocks, a_cnts, n_a), (b_scheme, b_blocks, b_cnts, n_b) = chain.parts[:2]
        common = [a for a in a_scheme[1:] if a in b_scheme]
        dup_pairs = tuple((a_scheme.index(a), b_scheme.index(a)) for a in common)
        out_scheme = a_scheme + [a for i, a in enumerate(b_scheme) if i != 0 and a not in common]
        mults = _pack_radices(a_blocks, b_blocks, dup_pairs)
        return _WorkItem(
            state=chain.state,
            key=(chain.tag, tuple(a_blocks.shape), tuple(b_blocks.shape), dup_pairs,
                 mults is not None),
            caps={"out": self._cap(4 * (n_a + n_b))},
            payload={"a": (a_blocks, a_cnts), "b": (b_blocks, b_cnts), "dup_pairs": dup_pairs,
                     "scheme": out_scheme, "mults": mults, "chain": chain},
            group=chain.group + (chain.machine_range or ()),
        )

    def _chain_level(self, op, items) -> int:
        """Run one chain level; each chain's first two parts become the
        level's rows, left on the device.  → the level's valid rows."""
        rows = 0
        for it in self._run_buckets(op.round, items, self._make_colocated_dispatch(count=False)):
            blocks, _, cnts = it.result
            n = int(cnts.sum())
            rows += n
            it.payload["chain"].parts[0:2] = [(it.payload["scheme"], blocks, cnts, n)]
            it.payload = it.result = None     # drop the level's inputs
        return rows

    #: working bytes of a chain level, per slot of each input block (its
    #: folded key, sorted with its order, and match bounds) and per output slot
    #: (the pair indices and their gathers) beside the output rows, twice
    _KEY_SLOT_BYTES = 48
    _PAIR_SLOT_BYTES = 40

    def _level_bytes(self, it) -> int:
        """Device bytes a chain level's work item takes while it runs, beyond
        its inputs: from the blocks' shapes and the emit capacity."""
        (a, _), (b, _) = it.payload["a"], it.payload["b"]
        k, cap_a, _ = a.shape
        cap_b = b.shape[1]
        row = 2 * a.element_size() * len(it.payload["scheme"])
        return k * ((cap_a + cap_b) * self._KEY_SLOT_BYTES
                    + it.caps["out"] * (self._PAIR_SLOT_BYTES + row))

    def _level_budget(self) -> Optional[int]:
        """Bytes one chain level may take on the device: half of what the
        allocator can still hand out (the device's free memory and what the
        allocator caches unused).  None off a CUDA device: no slicing."""
        if self.device.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(self.device)
        cached = torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        return (free + cached) // 2

    def _slice_width(self, items) -> Optional[int]:
        """Machines per slice of a chain level whose working bytes pass the
        budget, or None where it fits (or cannot be cut finer than the whole
        level)."""
        budget = self._level_budget()
        if budget is None:
            return None
        need = sum(self._level_bytes(it) for it in items)
        if need <= budget:
            return None
        width = items[0].payload["a"][0].shape[0]
        per = max(1, width * budget // need)
        return per if per < width else None

    def _finish_chain(self, chain) -> None:
        """A chain's last part: its valid rows compacted on the device in the
        program's output column order (η constants for the stage's heavy
        attributes), kept in ``done`` until the assembly pulls them."""
        from ..dataplane.exchange import valid_mask
        from ..dataplane.join import to_dev

        state = chain.state
        scheme, blocks, cnts, n = chain.parts[0]
        chain.parts = []
        if not self._materialize or n == 0:
            chain.done.append((n, None))
            return
        k, cap, _ = blocks.shape
        valid = valid_mask(cap, to_dev(cnts, blocks.device)).reshape(-1)
        flat = blocks.reshape(k * cap, -1)[valid]
        cols = [flat[:, scheme.index(a)] if a in scheme[1:]
                else torch.full((n,), state.stage.cfg.eta.value(a), dtype=flat.dtype,
                                device=flat.device)
                for a in state.program.out_cols]
        chain.done.append((n, torch.stack(cols, dim=1)))

    # -- general-route lowering rules (arbitrary-arity programs) --------------

    def _ensure_general_staged(self, states) -> None:
        """Stage every general program's base relations on the device.

        The general route has no residual carving: the whole input is the
        working set, so staging happens lazily at the first general op that
        needs device data (TreeSemiJoin for acyclic programs, ShareRoute for
        cyclic ones).  Each relation's rows are checked against the int32
        device word contract on the host, cross once as int32 and are spread
        over the machines there as `blockify` spreads them; the fragments
        stay on the device until ShareRoute has routed them.  An empty base
        relation empties the join outright — the state keeps its per-H count
        entry at 0 (``skip_count`` stays False), matching the simulator."""
        from ..dataplane.exchange import INT32, spread_rows

        for state in states:
            if state.gparts is not None or state.empty:
                continue
            query = state.program.query
            if any(len(rel) == 0 for rel in query.relations):
                state.empty = True
                continue
            state.gparts = []
            for rel in query.relations:
                data = torch.from_numpy(rel.data)
                lo, hi = torch.aminmax(data)
                if hi >= INT32.max or lo < INT32.min:
                    raise ValueError("values exceed the int32 device word contract")
                # narrowed into page-locked memory (cached by torch's host
                # allocator), whose copy to the card runs at the link's rate
                rows = torch.empty(data.shape, dtype=torch.int32,
                                   pin_memory=self.device.type == "cuda")
                rows.copy_(data)
                count("h2d_bytes", rows.nbytes)
                rows = rows.to(self.device, non_blocking=True)
                blocks, cnts = spread_rows(rows, self.p, self._block_cap(len(rel)))
                state.gparts.append((list(rel.scheme), blocks, cnts, len(rel)))

    @staticmethod
    def _general_key_cols(tgt_scheme, tgt_rows, src_scheme, src_rows, shared):
        """One int64 join-key column per side over the ``shared`` attributes,
        computed where the rows (n, w) live → (target keys, source keys,
        whether the keys are ranks).

        Mixed-radix packs (``key = key·radix_j + v_j``) when every value is
        non-negative and the radix product fits int32 — the shared columns'
        minima and maxima over both sides are read back once to decide;
        otherwise both sides' key tuples are densely ranked together in
        lexicographic order (the ranks ``np.unique(axis=0)`` gives; the key
        only needs to *agree* across sides, but the rank also routes the
        rows).  An empty ``shared`` — the cartesian stitch edge between
        disconnected components — keys every row 0, degenerating the
        semijoin to a non-emptiness filter."""
        dev = tgt_rows.device
        if not shared:
            return (torch.zeros(len(tgt_rows), dtype=torch.int64, device=dev),
                    torch.zeros(len(src_rows), dtype=torch.int64, device=dev), False)
        both = torch.cat([tgt_rows[:, [tgt_scheme.index(a) for a in shared]],
                          src_rows[:, [src_scheme.index(a) for a in shared]]]).to(torch.int64)
        n_t = len(tgt_rows)
        lo, hi = to_host(torch.stack([both.amin(dim=0), both.amax(dim=0)])).tolist()
        if min(lo) >= 0 and math.prod(h + 1 for h in hi) <= np.iinfo(np.int32).max:
            key = both[:, 0]
            for j in range(1, len(shared)):
                key = key * (hi[j] + 1) + both[:, j]
            return key[:n_t], key[n_t:], False
        _, inv = torch.unique(both, dim=0, return_inverse=True)
        return inv[:n_t], inv[n_t:], True

    def _sweep_item(self, state, ei: int, op):
        """Stage ``state``'s work item for edge ``ei`` of a sweep, on the
        device → (item, whether its keys are ranks), or None where the
        stage's tree has fewer edges.  The target's and the source's valid
        rows are gathered in machine order, keyed (`_general_key_cols`), the
        source's distinct keys and the keyed target spread over the machines
        as `blockify` spreads them; the target's old fragment is dropped, as
        is every temporary, before a round runs."""
        from ..dataplane.exchange import spread_rows, valid_rows

        edges = state.program.general.tree_edges
        if ei >= len(edges):
            return None
        child, par, shared = edges[ei] if op.phase == "up" else edges[len(edges) - 1 - ei]
        tgt, src = (par, child) if op.phase == "up" else (child, par)
        tgt_scheme, tgt_blocks, tgt_cnts, n_tgt = state.gparts[tgt]
        src_scheme, src_blocks, src_cnts, n_src = state.gparts[src]
        state.gparts[tgt] = None                 # the filter round rebuilds it
        tgt_rows = valid_rows(tgt_blocks, tgt_cnts, n_tgt)
        del tgt_blocks, tgt_cnts
        tk, sk, ranked = self._general_key_cols(
            tgt_scheme, tgt_rows, src_scheme, valid_rows(src_blocks, src_cnts, n_src), shared
        )
        piece = torch.unique(sk, sorted=True)
        del sk
        m = len(piece)
        pv, pc = spread_rows(piece[:, None], self.p, self._block_cap(m))
        del piece
        keyed = torch.cat([tgt_rows, tk.to(torch.int32)[:, None]], dim=1)
        del tgt_rows, tk
        kb, kc = spread_rows(keyed, self.p, self._block_cap(n_tgt))
        return _WorkItem(
            state=state,
            key=("gsj-intersect", tuple(pv.shape[:2])),
            caps={"slot": self._slot_cap(m), "out": self._cap(m)},
            payload={"pv": pv[:, :, 0], "pc": pc, "rows": kb, "cnts": kc, "n": n_tgt,
                     "tgt": tgt, "scheme": tgt_scheme, "col": len(tgt_scheme)},
            group=("gsj-intersect", state.qi, ei),
        ), ranked

    def _lower_tree_semijoin(self, program, states, op) -> None:
        """One Yannakakis sweep over the GYO join tree, on the device.

        For each tree edge — removal order for the up sweep, reversed for the
        down sweep — the filtering side's distinct key values are hash-
        partitioned and deduped on-device (`batched_sharded_intersect`, one
        piece), then the filtered side's rows, with the packed key appended
        as a trailing column, are exchanged under the same salt and semijoined
        (`batched_sharded_semijoin` on that column).  Edges run sequentially
        (edge i+1 filters against edge i's output) but every live stage
        batches per edge.  Retry groups carry the query index: every general
        stage shares the query-unqualified skey, and one query's re-salt must
        not reorder another's rows.

        Where rows cross to the host: nowhere.  The fragments (``gparts``)
        stay on the device from the base staging to ShareRoute; each edge's
        inputs are built there (`_sweep_item`), the intersect's piece feeds
        the filter round where it lies, and the filter's rows become the
        target's fragment, the key column stripped by a copy.  Read back: the
        shared columns' minima and maxima per edge, the overflow flags, and
        the filter's counts.

        Counters: ``edges``, the (stage, tree edge) pairs run; ``ranked_edges``,
        those whose keys took the dense-rank fallback."""
        from ..dataplane.exchange import salt_offset
        from ..dataplane.join import (
            batched_sharded_intersect,
            batched_sharded_semijoin,
        )

        with span("stage"):
            self._ensure_general_staged(states)
            n_edges = max(
                (len(state.program.general.tree_edges)
                 for state in states if not state.empty),
                default=0,
            )
        for ei in range(n_edges):
            with span("stage"):
                built = [self._sweep_item(state, ei, op) for state in states if not state.empty]
                prep = [it for it, _ in filter(None, built)]
                ranked = sum(rk for _, rk in filter(None, built))
                del built
            count("edges", len(prep))
            count("ranked_edges", ranked)

            if not prep:
                continue

            def i_dispatch(bucket):
                s, s_pad = len(bucket), self._pow2_stages(len(bucket))
                pieces = [(
                    self._stack([it.payload["pv"] for it in bucket], s_pad),
                    self._stack([it.payload["pc"] for it in bucket], s_pad),
                )]
                salts = [
                    _salt(it.state.skey, "gsj", op.phase, ei, attempt=it.attempt)
                    for it in bucket
                ]
                offs = np.asarray(
                    [salt_offset(v) for v in salts] + [0] * (s_pad - s), np.int32
                )
                caps = bucket[0].caps
                fn, args = batched_sharded_intersect(
                    pieces, offs, cap_slot=caps["slot"], cap_out=caps["out"],
                    device=self.device, invoke=False,
                )

                def post(outs, salts=salts, s=s):
                    vals, cnts, ovf = outs

                    def finalize(vals=vals, cnts=cnts):
                        return [(vals[i], cnts[i], salts[i]) for i in range(s)]

                    return finalize, ovf[:s]

                return fn, args, post

            pieces = self._run_buckets(op.round, prep, i_dispatch)
            with span("stage"):
                sj_items: List[_WorkItem] = []
                for it in pieces:
                    vals, cnts, salt = it.result
                    pl = dict(it.payload)
                    pl["piece"], pl["salt"] = (vals, cnts), salt
                    sj_items.append(_WorkItem(
                        state=it.state,
                        key=("gsj-filter", pl["col"], tuple(pl["rows"].shape),
                             tuple(vals.shape)),
                        caps={"slot": self._slot_cap(pl["n"]),
                              "out": self._cap(pl["n"])},
                        payload=pl,
                        group=("gsj-filter", it.state.qi, ei),
                    ))
                    it.payload = it.result = None
                del prep, pieces

            def f_dispatch(bucket):
                s, s_pad = len(bucket), self._pow2_stages(len(bucket))
                rows = self._stack([it.payload["rows"] for it in bucket], s_pad)
                cnts = self._stack([it.payload["cnts"] for it in bucket], s_pad)
                pv = self._stack([it.payload["piece"][0] for it in bucket], s_pad)
                pc = self._stack([it.payload["piece"][1] for it in bucket], s_pad)
                col = bucket[0].payload["col"]
                # pinned to the intersect pass's distribution salt: rows must
                # land where the piece landed, so retries only grow caps.
                offs = np.asarray(
                    [salt_offset(it.payload["salt"]) for it in bucket]
                    + [0] * (s_pad - s),
                    np.int32,
                )
                caps = bucket[0].caps
                fn, args = batched_sharded_semijoin(
                    rows, cnts, col, offs, pv, pc, cap_slot=caps["slot"],
                    cap_out=caps["out"], device=self.device, invoke=False,
                )
                return fn, args, partial(self._device_rows_post, s=s)

            for it in self._run_buckets(op.round, sj_items, f_dispatch):
                blocks, cnts, host_cnts = it.result
                it.result = None
                n2 = int(host_cnts.sum())
                # the appended key column stripped by a copy: a view would
                # keep the column's bytes alive up to ShareRoute's peak
                it.state.gparts[it.payload["tgt"]] = (it.payload["scheme"],
                                                      blocks[:, :, :-1].contiguous(), cnts, n2)
                del blocks
                if n2 == 0:
                    it.state.empty = True
                it.payload = None
            del sj_items

    def _lower_share_route(self, program, states, op) -> None:
        """Generalized HyperCube route: every output attribute is a grid
        dimension (shares from the fractional edge cover LP, Π ≤ p), every
        relation's rows are replicated to the cells agreeing with their
        hashed coordinates — share-1 attributes pin coordinate 0, attributes
        absent from a relation fan out across that dimension.  Routed as
        GridRoute's HyperCube side (`_route_to_cells`, one CP cell), with
        per-attribute salts shared across relations (same attribute ⇒ same
        hash) and one qi-scoped retry group per stage so a re-salt re-routes
        every relation of the query together.  The routed blocks stay on the
        device in the compiler's join order, for CellJoin.

        Counters: ``input_rows``, the relations' rows before replication;
        ``routed_rows``, the valid copies the route delivered; ``grid_cells``,
        Π shares; ``live_cells``, the cells that received a row of every
        relation, so the only ones that can emit, read off the per-machine
        counts the route reads back (Π shares ≤ p puts each cell on a
        machine of its own)."""
        with span("stage"):
            self._ensure_general_staged(states)
            frags, grids = [], []
            for state in states:
                if state.empty:
                    continue
                gen = state.program.general
                grid = HyperCubeGrid(list(state.program.out_cols), gen.shares_dict)
                if grid.size >= 1 << 31:
                    raise RuntimeError(f"stage {state.skey}: share grid exceeds int32")
                grids.append((state, grid.size))
                state.routed = [None] * len(state.gparts)
                for pos, ri in enumerate(gen.join_order):
                    scheme, blocks, cnts, n = state.gparts[ri]
                    frags.append((state, pos, {
                        "kind": "hc", "tag": "ghc", "group": ("ghc", state.qi),
                        "grid": grid, "cp_size": 1,
                        "scheme": scheme, "blocks": blocks, "cnts": cnts, "n": n,
                    }))
                # the work items hold the fragments now: their device bytes
                # go with this op, before CellJoin's
                state.gparts = None
        self._route_to_cells(op, frags)
        count("input_rows", sum(fr["n"] for _, _, fr in frags))
        for state, size in grids:
            count("grid_cells", size)
            count("routed_rows", sum(n for _, _, _, n in state.routed))
            count("live_cells", np.logical_and.reduce([c > 0 for _, _, c, _ in state.routed]).sum())

    def _lower_cell_join(self, program, states, op) -> None:
        """The general route's output: the colocated-join chain of
        `_run_chains` over ShareRoute's routed blocks, in the compiler's
        fixed join order (tree pre-order for acyclic, greedy connected for
        cyclic) — no reordering, so the chain's shape is a pure function of
        the plan."""
        chains = []
        for state in states:
            if state.routed is None:
                raise DataplaneUnsupported("CellJoin before ShareRoute")
            chains.append(_Chain(state=state, parts=list(state.routed),
                                 tag="gjoin", group=("gjoin", state.qi)))
            state.routed = None             # the chain holds the fragments now
        self._run_chains(op, chains)
