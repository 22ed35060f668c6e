"""Symbolic per-round load model for compiled RoundPrograms (Theorem 6.2).

Derives, *without executing anything*, a closed-form bound on the per-machine
load of every metered round of a compiled
:class:`~repro_torch.mpc.program.RoundProgram`.  Inputs are exactly the compile-time
quantities — the query structure (ρ via :func:`repro_torch.core.hypergraph.rho`),
the histogram essentials (m), and p — so the model is a pure function of the
same key that makes :func:`~repro_torch.mpc.program.compile_plan` cacheable.

The shape of every data-round bound is the paper's headline with explicit
lower-order terms:

    bound  =  C · ( L* + F + √L*·lg + lg² )          [words per machine]

      L*  = m / p^{1/ρ}          the Theorem 6.2 ideal load
      lg  = log₂(p) + 1          one polylog factor (Õ hides it)
      √L*·lg                     binomial deviation of hashed routing
      F                          round-specific skew term, see below

Round-specific F:

  * ``step1`` / ``step2-unary`` — F = 0.  Residual routing and unary hashing
    spread uniformly at random; only the deviation terms apply.
  * ``step2-bx`` / ``step2-by`` / ``step2-fused`` — F = m/λ*, with
    λ* = Θ(p^{1/(2ρ)}) the *canonical* heavy parameter
    (:func:`~repro_torch.core.planner.heavy_parameter`).  Semi-join rounds hash
    light edges by attribute value, so a single light value may land its full
    frequency — up to the taxonomy threshold m/λ — on one machine.  A program
    compiled with the canonical λ keeps this term at m/p^{1/(2ρ)}·polylog and
    the total within Õ(m/p^{1/ρ}); a mis-planned λ (heavy values left
    untagged) blows straight through it — which is exactly what the
    ``load-bound`` verifier rule catches.
  * ``step3-route`` — F = m/λ*.  The Lemma 6.1 CP×HyperCube route replicates
    residual tuples across grid slices; the replication the allocator (6.1)
    admits is bounded by the same λ-threshold.

``step3-sizes`` is metadata, not data: each of a stage's ≤ p'_η piece holders
broadcasts t_η = |I(η)| piece sizes to the stage's step-3 group, so the bound
is the static  C·(max_η t_η·p'_η + lg·Σ_η t_η·p'_η / p + lg²).

General-route rounds (arbitrary-arity programs, ``program.general`` set)
swap m for an explicit volume V: the Yannakakis sweeps ``yan-up``/
``yan-down`` merge one semijoin per join-tree edge (V = edges·(w+2)·m, w the
widest arity), and ``hc-route`` replicates each relation across the share
grid (V = Σ_e m_e·w_e·rep_e over g = Π shares cells) — with LP-optimal
shares the skew-free per-cell volume collapses to the AGM form
O(m/p^{1/ρ}).  Both keep the V/λ* skew term: the general route does no
heavy/light splitting, so its Õ(·) promise assumes λ-bounded frequencies.

The multiplicative constant C (:data:`MODEL_CONSTANT`) is calibrated once
against the simulator battery (docs/design/11-verification.md has the table):
well-planned programs across {uniform, zipf} × {triangle, 4-cycle, star} ×
p ∈ 8…256 measure ≤ 0.6× of each bound, while a deliberately mis-planned
program (λ = 2 hub triangle) exceeds the step2-bx bound by ≥ 1.7× at p = 256.

Everything here is host-side numpy/stdlib; no jax, no execution.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

from ..core.planner import heavy_parameter

#: Calibrated multiplicative constant of every bound (see module docstring).
MODEL_CONSTANT = 4.0

#: Rounds that move relation data (and therefore follow the m/p^{1/ρ} form).
DATA_ROUNDS = (
    "step1",
    "step2-unary",
    "step2-bx",
    "step2-by",
    "step2-fused",
    "step3-route",
    "yan-up",
    "yan-down",
    "hc-route",
)

#: Rounds the simulator meters at zero load (host-side placement / local work).
FREE_ROUNDS = ("scatter", "output")


@dataclass(frozen=True)
class RoundBound:
    """One round's symbolic bound: ``words`` plus the formula it came from."""

    round: str
    words: float
    formula: str


def ideal_load(m: int, p: int, rho_val: float) -> float:
    """L* = m / p^{1/ρ}: the Theorem 6.2 per-round target."""
    return float(m) / float(p) ** (1.0 / float(rho_val))


def round_bounds(program, constant: float = MODEL_CONSTANT) -> List[RoundBound]:
    """Symbolic per-round load bounds for ``program``, in round order.

    Pure metadata work — reads (m, p, ρ, stage allocation) off the compiled
    program and never touches relation data.  Rounds in :data:`FREE_ROUNDS`
    are omitted (the simulator meters them at zero)."""
    m = int(program.stats.m)
    p = int(program.p)
    rho_val = float(program.rho_val)
    lstar = ideal_load(m, p, rho_val)
    lg = math.log2(p) + 1.0
    lam_star = heavy_parameter(p, rho_val)
    freq = float(m) / float(lam_star)
    dev = math.sqrt(max(lstar, 1.0)) * lg
    base = lstar + dev + lg * lg

    # step3-sizes metadata volume, statically from the step-1 allocation
    # (binary route only — general programs have no step-3 size round and
    # their GeneralStage carries no step-1 allocation).
    gen = getattr(program, "general", None)
    s_max, s_tot = 0.0, 0.0
    if gen is None:
        for st in program.stages:
            t = len(st.plan.isolated)
            holders = st.cfg.step1_group.size
            s_max = max(s_max, float(t * holders))
            s_tot += float(t * holders)

    # General-route volumes (metadata only: arities, row counts, shares).
    # ``yan-up``/``yan-down`` merge one hash-partitioned semijoin per tree
    # edge into a single logical round, so the sweep bound scales with the
    # edge count and the widest relation (+1 for the appended key column).
    # ``hc-route`` replicates each relation Π_{a∉e} share_a times over the
    # share grid g = Π shares ≤ p; with LP-optimal shares the skew-free
    # per-cell volume is Σ_e m_e·w_e / Π_{a∈e} share_a — the AGM form
    # k·w·m/p^{1/ρ} of the Theorem 6.2 headline.
    sweep_vol = route_vol = 0.0
    gsize = 1
    if gen is not None:
        q = program.query
        wmax = max(len(rel.scheme) for rel in q.relations) + 1
        n_edges = max(1, len(gen.tree_edges))
        shares = dict(gen.shares)
        for s in shares.values():
            gsize *= int(s)
        sweep_vol = float(n_edges) * float(wmax + 1) * float(m)
        for rel in q.relations:
            rep = 1
            for a, s in shares.items():
                if a not in rel.scheme:
                    rep *= int(s)
            route_vol += float(len(rel)) * float(len(rel.scheme) + 1) * float(rep)
    gdenom = float(max(1, min(p, gsize)))

    out: List[RoundBound] = []
    seen = set()
    for name in program.round_names:
        if name in seen or name in FREE_ROUNDS:
            continue
        seen.add(name)
        if name == "step3-sizes":
            words = constant * (s_max + lg * s_tot / p + lg * lg)
            formula = (
                f"{constant:g}*(max t*p' + lg*sum(t*p')/p + lg^2)"
                f"  [max={s_max:.0f}, sum={s_tot:.0f}]"
            )
        elif name in ("step2-bx", "step2-by", "step2-fused", "step3-route"):
            words = constant * (base + freq)
            formula = (
                f"{constant:g}*(L* + m/lam* + sqrt(L*)*lg + lg^2)"
                f"  [L*={lstar:.0f}, m/lam*={freq:.0f}, lam*={lam_star}]"
            )
        elif name in ("yan-up", "yan-down"):
            v = sweep_vol
            words = constant * (
                v / p + v / lam_star + math.sqrt(max(v / p, 1.0)) * lg + lg * lg
            )
            formula = (
                f"{constant:g}*(V/p + V/lam* + sqrt(V/p)*lg + lg^2)"
                f"  [V={v:.0f} = edges*(w+2)*m, lam*={lam_star}]"
            )
        elif name == "hc-route":
            v = route_vol
            words = constant * (
                v / gdenom + v / lam_star
                + math.sqrt(max(v / gdenom, 1.0)) * lg + lg * lg
            )
            formula = (
                f"{constant:g}*(V/g + V/lam* + sqrt(V/g)*lg + lg^2)"
                f"  [V={v:.0f} = sum_e m_e*w_e*rep_e, g={gdenom:.0f}, "
                f"skew-free ideal m/p^(1/rho)={lstar:.0f}]"
            )
        elif name in ("step1", "step2-unary"):
            words = constant * base
            formula = f"{constant:g}*(L* + sqrt(L*)*lg + lg^2)  [L*={lstar:.0f}]"
        else:  # pragma: no cover - unknown custom round: fall back to base
            words = constant * base
            formula = f"{constant:g}*(L* + sqrt(L*)*lg + lg^2)  [L*={lstar:.0f}]"
        out.append(RoundBound(round=name, words=words, formula=formula))
    return out


def round_bounds_by_name(program, constant: float = MODEL_CONSTANT) -> Dict[str, RoundBound]:
    """:func:`round_bounds` keyed by round name (what ``check_load`` joins on)."""
    return {b.round: b for b in round_bounds(program, constant=constant)}


def predicted_load(program, constant: float = MODEL_CONSTANT) -> float:
    """Σ of the per-round bounds: the symbolic analogue of the simulator's
    ``parallel_total_load`` (an upper envelope, not an estimate)."""
    return sum(b.words for b in round_bounds(program, constant=constant))
