"""Typed errors of the join service.

Every failure a :class:`~repro_torch.mpc.service.JoinSession` surfaces is a
:class:`JoinServiceError` that names the query it belongs to and chains the
original traceback (``__cause__`` is always the root failure).

:class:`FaultPlan` is the deterministic, seeded fault-injection layer
threaded through :class:`~repro_torch.mpc.executors.DataplaneExecutor` and
the session, so every failure path (overflow exhaustion, dispatch
exceptions, first-build failures, stragglers, drainer crashes) is reachable
from a test with a fixed seed.  Injection decisions are counter-based: each
site keeps an event counter and each (seed, site, event index, rule index)
hashes to an independent uniform draw, so replaying the same workload under
the same plan seed injects the same faults at the same events.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


def describe_query(query) -> str:
    """A short, stable human-readable name for a join query: its relation
    schemes in order (``Q[(A,B) (B,C)]``).  Used by every typed service error
    so a failure inside a coalesced batch still names *which* query died."""
    try:
        schemes = " ".join(
            "(" + ",".join(str(a) for a in rel.scheme) + ")"
            for rel in query.relations
        )
        return f"Q[{schemes}]"
    except Exception:
        return repr(query)


class JoinServiceError(RuntimeError):
    """Base of every typed join-service failure.

    Subclasses ``RuntimeError`` so pre-taxonomy callers catching the old bare
    ``RuntimeError`` keep working; new callers should catch this (or a
    specific subclass) instead."""


class RetryExhaustedError(JoinServiceError):
    """A stage still overflowed after ``max_retries`` capacity doublings.

    The deterministic-retry replacement of the paper's 1/p^c failure
    probability ran out of attempts: the capacity model is badly wrong for
    this data.  ``attempt_log`` carries the (stage, round, channel) retry
    entries of the failed run, so the exhaustion is attributable per
    channel."""

    def __init__(self, message: str, stage=None, op_round: Optional[str] = None,
                 attempts: int = 0, attempt_log: Tuple = ()):
        super().__init__(message)
        self.stage = stage
        self.op_round = op_round
        self.attempts = attempts
        self.attempt_log = tuple(attempt_log)


class DeadlineExceededError(JoinServiceError):
    """A request's monotonic-clock budget expired.

    Raised by the executor *between* dispatches (a dispatch already
    enqueued on the device runs to its end) or by the session before a
    request that is already past its deadline executes at all.  ``query`` is
    filled in by the service layer."""

    def __init__(self, message: str, query=None, op_round: Optional[str] = None,
                 deadline_s: Optional[float] = None):
        super().__init__(message)
        self.query = query
        self.op_round = op_round
        self.deadline_s = deadline_s


class QueryFailedError(JoinServiceError):
    """One query of a session failed; ``cause`` is the root exception.

    The generic per-query wrapper of the taxonomy: whatever died inside the
    executor (a routing-invariant violation, a CUDA error), the service
    resolves *this* — naming the query — with the original exception
    chained on ``__cause__`` so the executor frames stay in the traceback."""

    def __init__(self, query, cause: BaseException, attempt_log: Tuple = ()):
        super().__init__(f"query {describe_query(query)} failed: {cause!r}")
        self.query = query
        self.cause = cause
        self.attempt_log = tuple(attempt_log)
        # the raise-from chain, attached at construction so the error carries
        # its provenance through Future.set_exception / cross-thread hops
        self.__cause__ = cause


class DegradedSessionError(JoinServiceError):
    """The session's drainer thread crashed.

    Every future pending at crash time resolves with this (nothing hangs),
    and subsequent :meth:`~repro_torch.mpc.service.JoinSession.submit_async` calls
    raise it immediately until :meth:`~repro_torch.mpc.service.JoinSession.restart`
    clears the degraded state."""

    def __init__(self, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.cause = cause
        if cause is not None:
            self.__cause__ = cause


class ProgramVerificationError(JoinServiceError):
    """A compiled :class:`~repro_torch.mpc.program.RoundProgram` failed static
    verification (docs/design/11-verification.md).

    Raised by :mod:`repro_torch.mpc.verify` *before* any kernel runs: the
    program's structure (op stream, machine allocations, grid geometry,
    capacity grid, packed-key eligibility) or its measured load violated an
    invariant the planner is supposed to guarantee.

    Attributes:
        op_round: the logical round the violation belongs to (``"step1"``,
            ``"step3-route"``, …) or None for program-wide rules.
        rule: the verifier rule name (one of
            :data:`repro_torch.mpc.verify.RULES`).
        detail: human-readable specifics (offending stage, measured vs
            predicted numbers, …).
    """

    def __init__(self, message: str, op_round: Optional[str] = None,
                 rule: Optional[str] = None, detail: str = ""):
        super().__init__(message)
        self.op_round = op_round
        self.rule = rule
        self.detail = detail


# -- injected-fault exceptions (what a FaultPlan raises) ---------------------


class InjectedFault(RuntimeError):
    """Base of every exception a :class:`FaultPlan` raises on purpose.

    Deliberately NOT a :class:`JoinServiceError`: injected faults model
    *arbitrary* infrastructure failures, and the service must translate them
    into typed errors exactly like it would a real one — tests asserting
    "every failure surfaces as a JoinServiceError" would be vacuous if the
    injection were already typed."""


class InjectedDispatchError(InjectedFault):
    """A fused dispatch launch was failed by the fault plan."""


class InjectedCompileError(InjectedFault):
    """An AOT trace+compile was failed by the fault plan."""


class InjectedDrainerError(InjectedFault):
    """The session drainer thread was crashed by the fault plan."""


# ---------------------------------------------------------------------------
# Fault plan
# ---------------------------------------------------------------------------

#: sites a FaultRule can attach to.
SITES = ("dispatch", "compile", "overflow", "latency", "drainer")


@dataclass(frozen=True)
class FaultRule:
    """One injection rule of a :class:`FaultPlan`.

    Args:
        site: where the rule fires — ``"dispatch"`` (raise
            :class:`InjectedDispatchError` at a bucket launch), ``"compile"``
            (raise :class:`InjectedCompileError` where the executor builds a
            bucket of a (round, key, caps) it has not built before — the
            port has no executable cache, so that first build stands for the
            reference's compile),
            ``"overflow"`` (force the listed ``channels`` to read as
            overflowed at an item's readback — drives the real retry
            machinery, fresh salts and all), ``"latency"`` (sleep
            ``delay_s`` before a bucket launch — an artificial straggler),
            or ``"drainer"`` (raise :class:`InjectedDrainerError` inside the
            session drain loop, between dequeue and demux).
        rate: per-event probability in [0, 1] (1.0 = every matching event).
        count: cap on total injections from this rule (None = unlimited);
            a drained rule never fires again — how tests model *transient*
            faults.
        after: skip the first ``after`` matching events (lets a test warm a
            session cleanly, then fault it).
        rounds: restrict to these op-round names (e.g. ``("output",)``;
            count passes are separate rounds named ``"<round>/count"``).
            None matches every round.  Ignored by the ``drainer`` site.
        channels: which overflow channels to force (``overflow`` site only);
            channels the work item does not carry are ignored.
        delay_s: sleep duration (``latency`` site only).
    """

    site: str
    rate: float = 1.0
    count: Optional[int] = None
    after: int = 0
    rounds: Optional[Tuple[str, ...]] = None
    channels: Tuple[str, ...] = ("slot",)
    delay_s: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} (want one of {SITES})")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")


class FaultPlan:
    """A deterministic, seeded schedule of injected faults.

    Thread through the stack as ``DataplaneExecutor(p, fault_plan=...)`` /
    ``JoinSession(fault_plan=...)`` (or per run via
    :class:`~repro_torch.mpc.program.RunConfig`).  The plan is consulted at fixed
    sites; each consultation advances that site's event counter, and each
    (seed, site, event, rule) tuple hashes to an independent uniform draw —
    so two runs of the same workload under the same plan inject identically,
    and removing one rule never shifts another rule's decisions.

    Observability: ``injected`` counts injections per site, ``log`` records
    every injection as ``(site, round, detail, event_index)`` — what the
    chaos suite reconciles the service's failure counters against.

    All methods are thread-safe (the drainer consults the plan
    concurrently with the submitting thread)."""

    def __init__(self, rules, seed: int = 0):
        self.rules: Tuple[FaultRule, ...] = tuple(rules)
        self.seed = seed
        self._events: Dict[str, int] = defaultdict(int)
        self._matched: Dict[int, int] = defaultdict(int)   # per-rule match count
        self._fired: Dict[int, int] = defaultdict(int)     # per-rule injections
        self.injected: Dict[str, int] = defaultdict(int)
        self.log: List[Tuple[str, Optional[str], str, int]] = []
        self._lock = threading.Lock()

    # -- convenience constructors --------------------------------------------

    @classmethod
    def none(cls) -> "FaultPlan":
        """An empty plan (injects nothing) — the explicit no-faults value."""
        return cls((), seed=0)

    @classmethod
    def dispatch_failures(cls, rate: float, seed: int = 0,
                          count: Optional[int] = None,
                          after: int = 0) -> "FaultPlan":
        """Fail a ``rate`` fraction of fused dispatch launches."""
        return cls(
            [FaultRule(site="dispatch", rate=rate, count=count, after=after)],
            seed=seed,
        )

    @classmethod
    def persistent_overflow(cls, rounds: Optional[Tuple[str, ...]] = None,
                            channels: Tuple[str, ...] = ("slot",),
                            seed: int = 0) -> "FaultPlan":
        """Force the given channels to overflow on every matching readback —
        drives the capacity-doubling retry to :class:`RetryExhaustedError`."""
        return cls(
            [FaultRule(site="overflow", rate=1.0, rounds=rounds, channels=channels)],
            seed=seed,
        )

    # -- decision core --------------------------------------------------------

    def _uniform(self, site: str, event: int, rule_idx: int) -> float:
        h = hashlib.blake2b(
            repr((self.seed, site, event, rule_idx)).encode(), digest_size=8
        ).digest()
        return int.from_bytes(h, "little") / float(1 << 64)

    def _firing_rules(self, site: str, rnd: Optional[str]) -> List[FaultRule]:
        """Advance ``site``'s event counter and return the rules that fire."""
        with self._lock:
            event = self._events[site]
            self._events[site] = event + 1
            fired: List[FaultRule] = []
            for ri, rule in enumerate(self.rules):
                if rule.site != site:
                    continue
                if rule.rounds is not None and site != "drainer" and rnd not in rule.rounds:
                    continue
                matched = self._matched[ri]
                self._matched[ri] = matched + 1
                if matched < rule.after:
                    continue
                if rule.count is not None and self._fired[ri] >= rule.count:
                    continue
                if self._uniform(site, event, ri) >= rule.rate:
                    continue
                self._fired[ri] += 1
                self.injected[site] += 1
                detail = (
                    "+".join(rule.channels) if site == "overflow"
                    else f"{rule.delay_s}s" if site == "latency"
                    else "fail"
                )
                self.log.append((site, rnd, detail, event))
                fired.append(rule)
            return fired

    # -- sites ----------------------------------------------------------------

    def at_dispatch(self, rnd: str) -> None:
        """Consulted once per fused bucket launch: latency rules sleep (the
        artificial straggler), dispatch rules raise."""
        for rule in self._firing_rules("latency", rnd):
            time.sleep(rule.delay_s)
        if self._firing_rules("dispatch", rnd):
            raise InjectedDispatchError(
                f"injected dispatch failure in op round {rnd!r}"
            )

    def at_compile(self, rnd: str) -> None:
        """Consulted once per bucket of a fresh (round, key, caps)
        signature — the port's counterpart of a compile."""
        if self._firing_rules("compile", rnd):
            raise InjectedCompileError(
                f"injected compile failure in op round {rnd!r}"
            )

    def at_drainer(self) -> None:
        """Consulted once per drain batch, between dequeue and demux —
        exactly the window the shutdown-race satellite tests."""
        if self._firing_rules("drainer", None):
            raise InjectedDrainerError("injected drainer crash")

    def overflow(self, rnd: str) -> Tuple[str, ...]:
        """Consulted once per work-item readback: the union of channels the
        firing overflow rules force.  The executor treats a forced channel
        exactly like a real overflow (doubled caps, fresh salts for slot) —
        and quarantines the item's learned caps, so the injected doubling
        never poisons the fault-free steady state."""
        channels: set = set()
        for rule in self._firing_rules("overflow", rnd):
            channels.update(rule.channels)
        return tuple(sorted(channels))

    # -- observability --------------------------------------------------------

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def drained(self) -> bool:
        """True when every rule has a ``count`` and has exhausted it — the
        plan can no longer inject anything (the recovery phase of a chaos
        test starts here)."""
        if not self.rules:
            return True
        with self._lock:
            return all(
                r.count is not None and self._fired[i] >= r.count
                for i, r in enumerate(self.rules)
            )
