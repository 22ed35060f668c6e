"""External-memory (EM) model adapter — the paper's second concluding remark (Sec. 7).

The reduction of [13] converts a p-machine MPC algorithm with load L into an EM
algorithm: simulate the p machines on one host with M words of memory, p = Θ(m/M)
so each "machine"'s state fits in memory; every MPC round costs O(p · (L/B + 1))
I/Os of block size B (spill + reload each machine's received words).

With our engine's load L = Õ(m/p^{1/ρ}) and p = Θ(m/M) this gives

    I/Os  =  Õ( (m/M)^ρ · M / B )  =  Õ( m^ρ / (B · M^{ρ-1}) )

(matching the paper's stated bound, optimal up to polylog by [11, 18]).
``em_cost_from_run`` instantiates the reduction on an actual metered simulator run,
giving *concrete* I/O counts rather than asymptotics — usable to size a single-host
spill-to-disk join. Validated in tests/test_em_model.py against the closed form.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .hypergraph import rho
from .query import JoinQuery


@dataclass(frozen=True)
class EMCost:
    m: int
    memory_words: int          # M
    block_words: int           # B
    p_simulated: int           # Θ(m/M) machines simulated
    rounds: int
    total_load_words: int      # Σ per-round max loads of the MPC run
    io_blocks: int             # concrete I/O count from the reduction
    io_bound_closed_form: float  # m^ρ / (B · M^{ρ-1})

    @property
    def ratio(self) -> float:
        return self.io_blocks / max(1.0, self.io_bound_closed_form)


def simulated_p(m: int, memory_words: int, safety: float = 4.0) -> int:
    """p = Θ(m/M): each simulated machine's Θ(m/p) input + received load must fit in
    M with `safety` headroom."""
    return max(2, math.ceil(safety * m / memory_words))


def em_cost_from_run(query: JoinQuery, result, memory_words: int, block_words: int) -> EMCost:
    """Instantiate the MPC→EM reduction on a metered run (`result` = MPCJoinResult
    whose simulator ran with p ≈ simulated_p(m, M))."""
    sim = result.sim
    p = result.p
    io = 0
    for name, load in sim.merged_round_loads().items():
        # write + read each machine's received words in blocks, one pass per round
        io += 2 * p * (math.ceil(load / block_words) + 1)
    rho_val = float(rho(query))
    bound = query.m ** rho_val / (block_words * memory_words ** (rho_val - 1))
    return EMCost(
        m=query.m,
        memory_words=memory_words,
        block_words=block_words,
        p_simulated=p,
        rounds=len(sim.merged_round_loads()),
        total_load_words=result.load,
        io_blocks=io,
        io_bound_closed_form=bound,
    )
