"""End-to-end subgraph enumeration on the port's MPC join.

``enumerate_subgraphs`` runs the full pipeline — compile the pattern against
the graph, execute the Theorem 6.2 join on the torch data plane, then apply
the two row-level corrections the reduction owes (injectivity filter,
automorphic canonical dedup) — and returns every occurrence exactly once.

Backends:

  * ``"dataplane"`` — ``compile_plan`` + :class:`DataplaneExecutor` (stage-
    batched by default; pass ``executor=DataplaneExecutor(p,
    batch_stages=False)`` for the per-stage schedule), on ``device`` (the
    card unless the caller names another);
  * ``"simulator"`` — :func:`repro_torch.mpc.engine.mpc_join` on the host:
    shared-input Scatter, the 3-round distributed histogram, exact load
    metering.  The reference package defaults to this backend; this package
    defaults to ``"dataplane"``, so the entry point runs on the card unless
    the caller asks otherwise.

Passing ``session=`` (a :class:`repro_torch.mpc.service.JoinSession`) routes
the join through the persistent service instead: repeated patterns over the
same graph hit the session's plan cache and warm executor
(``JoinSession.submit_pattern`` is the method form of the same path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.hypergraph import fractional_edge_cover
from ..core.planner import heavy_parameter
from ..core.taxonomy import compute_stats
from .compile import CompiledPattern, compile_pattern
from .graphs import Graph
from .patterns import Pattern, automorphisms, canonical_rows


@dataclass
class EnumerationResult:
    """Occurrences (each exactly once) + the engine run behind them.

    ``occurrences``: (count, k) int64, row = G-vertices bound to pattern
    vertices 0..k-1, canonicalized (lex-min automorphic image) and sorted.
    ``embeddings``: raw Join(Q) rows before injectivity/dedup — the
    homomorphism count the engine actually materialized."""

    pattern: Pattern
    backend: str
    occurrences: np.ndarray
    count: int
    embeddings: int
    compiled: CompiledPattern
    engine: object


def postprocess_rows(compiled: CompiledPattern, rows: np.ndarray) -> np.ndarray:
    """Join rows → exactly-once occurrence set.

    Injectivity: drop rows collapsing two pattern vertices (skipped when the
    orientation already separates every pair).  Dedup: canonicalize through
    Aut(P) and unique — when the orientation is complete this is a no-op on
    the row *set* but still normalizes each row to its canonical image (the
    oriented row order follows the degree order, not the value order)."""
    k = compiled.pattern.n_vertices
    rows = np.asarray(rows, dtype=np.int64).reshape(-1, k)
    if rows.shape[0] and compiled.orientation.needs_injectivity:
        keep = np.ones(rows.shape[0], dtype=bool)
        for i in range(k):
            for j in range(i + 1, k):
                keep &= rows[:, i] != rows[:, j]
        rows = rows[keep]
    canon = canonical_rows(rows, automorphisms(compiled.pattern))
    if canon.shape[0] == 0:
        return canon.reshape(0, k)
    return np.unique(canon, axis=0)


def enumerate_subgraphs(
    graph: Graph,
    pattern: Pattern,
    p: int = 8,
    backend: str = "dataplane",
    lam: Optional[int] = None,
    orientation: str = "degree",
    executor=None,
    fuse_semijoin: bool = False,
    session=None,
    device=None,
    seed: int = 0,
) -> EnumerationResult:
    """Enumerate every occurrence of ``pattern`` in ``graph`` via the join.

    Args:
        graph: the data graph (its edge set becomes the shared physical table).
        pattern: the pattern to enumerate (≤ 8 vertices).
        p: the plan's machine count (the executor's leading tensor axis).
        backend: ``"dataplane"`` (the default, on ``device``) or
            ``"simulator"`` (the metered host simulator; the reference
            package's default).  Ignored when ``session`` is given — the
            session's backend is used.
        lam: heavy parameter; defaults to the paper's λ = Θ(p^{1/(2ρ)}).
        orientation: vertex order behind the oriented table (``"degree"``/``"id"``).
        executor: inject a configured :class:`DataplaneExecutor` (one-shot
            dataplane path only; its own ``p`` and device then rule).
        fuse_semijoin: enable the beyond-paper semi-join fusion rewrite.
        session: a :class:`repro_torch.mpc.service.JoinSession` to submit
            through — the persistent-service path with plan reuse.
        device: where a one-shot dataplane run without ``executor``
            executes (``cuda`` unless named; ``"cpu"`` runs the plain PyTorch
            path).
        seed: shared-randomness seed (one-shot simulator path only).

    Returns:
        An :class:`EnumerationResult`: exactly-once ``occurrences`` plus the
        engine run behind them.
    """
    if session is None and backend not in ("dataplane", "simulator"):
        raise ValueError(f"unknown backend {backend!r}")
    compiled = compile_pattern(graph, pattern, orientation)
    q = compiled.query
    if session is not None:
        p, backend = session.p, session.backend    # the session's plans rule
    if lam is None:
        rho_val = float(fractional_edge_cover(q.hypergraph)[0])
        lam = heavy_parameter(p, rho_val)

    if session is not None:
        res = session.submit(q, lam=lam, fuse_semijoin=fuse_semijoin).result
    elif backend == "simulator":
        from ..mpc.engine import mpc_join

        res = mpc_join(q, p=p, seed=seed, lam=lam, fuse_semijoin=fuse_semijoin)
    else:
        from ..mpc.executors import DataplaneExecutor
        from ..mpc.program import compile_plan, fuse_semijoin_pass

        stats = compute_stats(q, lam)
        program = compile_plan(q, stats, p)
        if fuse_semijoin:
            program = fuse_semijoin_pass(program)
        ex = executor if executor is not None else DataplaneExecutor(p, device=device)
        res = ex.run(program)

    occ = postprocess_rows(compiled, res.rows)
    return EnumerationResult(
        pattern=pattern,
        backend=backend,
        occurrences=occ,
        count=int(occ.shape[0]),
        embeddings=int(res.count),
        compiled=compiled,
        engine=res,
    )
