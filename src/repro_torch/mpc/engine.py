"""The MPC join algorithm of Theorem 6.2: compile to the round-program IR,
then execute on the exact-cost simulator.

The round structure (constant, independent of the query — paper Sec. 6; all
H ⊆ attset(Q) and all configurations η are processed inside the *same*
physical rounds) now lives in two places:

  * ``repro_torch.mpc.program``   — what the rounds are and who routes what
                                    (``compile_plan`` → :class:`RoundProgram`);
  * ``repro_torch.mpc.executors`` — who executes them (:class:`SimulatorExecutor`
                                    for exact load metering on the host,
                                    :class:`DataplaneExecutor` for the card).

``mpc_join`` is the historical entry point and is now a one-shot
:class:`~repro_torch.mpc.service.JoinSession`: scatter inputs, run the 3-round
statistics protocol, compile, execute, discard the session.  Long-lived
callers should hold a ``JoinSession`` instead — it caches compiled plans and
executor state across queries (docs/design/09-service.md).  Engine-level
choices the paper leaves open are documented in docs/design/06-engine-choices.md.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.query import Attr, JoinQuery
from ..core.taxonomy import HeavyStats
from .executors import MPCJoinResult
from .service import JoinSession


def mpc_join(
    query: JoinQuery,
    p: int,
    seed: int = 0,
    lam: Optional[int] = None,
    materialize: bool = True,
    h_subsets: Optional[Sequence[Sequence[Attr]]] = None,
    fuse_semijoin: bool = False,
    stats: Optional[HeavyStats] = None,
) -> MPCJoinResult:
    """Run the full Theorem 6.2 algorithm once on p simulated machines.

    Args:
        query: the join query (concrete relations attached).
        p: number of simulated MPC machines.
        seed: shared-randomness seed (scatter + routing hash family).
        lam: heavy parameter λ; default Θ(p^{1/(2ρ)}) per the paper.
        materialize: materialize result rows (False: counts/load only).
        h_subsets: restrict the taxonomy to specific H sets (testing);
            default = all subsets of attset(Q).
        fuse_semijoin: enable the beyond-paper round fusion (a program-rewrite
            pass; see :func:`repro_torch.mpc.program.fuse_semijoin_pass`).
        stats: inject a precomputed histogram (e.g. the centralized
            ``compute_stats`` oracle, or one shared across repeated runs); by
            default the 3 metered rounds of the distributed protocol produce
            it.  Relations sharing a physical ``Relation.table`` are placed
            once by the shared-input Scatter path.

    Returns:
        An :class:`~repro_torch.mpc.executors.MPCJoinResult` with the exact join
        count, per-H counts, materialized rows, and the metered simulator
        (``result.load`` vs ``result.bound`` is the paper's claim).

    This is the *one-shot* path: every artifact (plan, simulator ledger) is
    per-call.  Repeated workloads should use
    :class:`~repro_torch.mpc.service.JoinSession`, which produces row-identical
    results while caching plans across calls.
    """
    session = JoinSession(p=p, backend="simulator", seed=seed)
    return session.submit(
        query,
        lam=lam,
        stats=stats,
        materialize=materialize,
        h_subsets=h_subsets,
        fuse_semijoin=fuse_semijoin,
    ).result
