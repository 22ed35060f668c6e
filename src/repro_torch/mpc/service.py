"""Persistent join service: one long-lived session, many queries, cross-query reuse.

The Theorem 6.2 plan is a pure function of the query's hypergraph and the
histogram, never of the concrete tuples, so a session that answers the same
shapes over and over can reuse it.  :class:`JoinSession` keeps:

  * **a plan cache** — compiled programs in an LRU keyed by
    :func:`~repro_torch.mpc.program.plan_cache_key` (query structure plus the
    full histogram signature).  A hit skips the planner LPs and the taxonomy
    sweep; the cached program is rebound onto the submitted data.
  * **one executor** — a :class:`DataplaneExecutor` living as long as the
    session, whose learned capacities make a warm repeat of a query run with
    zero overflow retries.
  * **batch submission** — :meth:`JoinSession.submit_batch` shares the
    histogram's per-table unique-count pass across queries binding the same
    physical ``Relation.table``.

Every submit returns a :class:`SessionResult` with per-phase latency and
cache provenance; :attr:`JoinSession.stats` accumulates the session-wide
:class:`ServiceStats`.  Submissions are synchronous; asynchronous submission
with cross-query coalescing is not part of this package yet.
"""

from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field, replace
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from ..core.hypergraph import rho
from ..core.planner import heavy_parameter
from ..core.query import Attr, JoinQuery
from ..core.taxonomy import HeavyStats, compute_stats
from .executors import DataplaneExecutor, DataplaneJoinResult
from .faults import DeadlineExceededError, JoinServiceError, QueryFailedError, describe_query
from .program import RunConfig, compile_plan, plan_cache_key

#: sliding-window size of the ServiceStats latency samples.
LATENCY_WINDOW = 512


@dataclass
class ServiceStats:
    """Session-wide service counters (live object on :attr:`JoinSession.stats`).

    ``plan_hits``/``plan_misses``/``plan_evictions`` meter the plan LRU;
    ``caps_hits``/``caps_misses``/``caps_evictions`` the executor's learned
    capacities; ``retries`` the scheduler's overflow retries.  ``cold_us``/
    ``warm_us`` collect per-submit latencies split by plan-cache outcome over
    a sliding window; ``slo_ok``/``slo_violations`` count submits against the
    session's ``slo_target_us``.  ``failed`` counts submits that raised a
    typed :class:`~repro_torch.mpc.faults.JoinServiceError`."""

    submits: int = 0
    plan_hits: int = 0
    plan_misses: int = 0
    plan_evictions: int = 0
    cached_plans: int = 0
    retries: int = 0
    caps_hits: int = 0
    caps_misses: int = 0
    caps_evictions: int = 0
    failed: int = 0
    deadline_exceeded: int = 0
    quarantined_caps: int = 0
    quarantined_plans: int = 0
    slo_ok: int = 0
    slo_violations: int = 0
    cold_us: Deque[float] = field(default_factory=lambda: deque(maxlen=LATENCY_WINDOW))
    warm_us: Deque[float] = field(default_factory=lambda: deque(maxlen=LATENCY_WINDOW))

    @property
    def mean_cold_us(self) -> float:
        return sum(self.cold_us) / len(self.cold_us) if self.cold_us else 0.0

    @property
    def mean_warm_us(self) -> float:
        return sum(self.warm_us) / len(self.warm_us) if self.warm_us else 0.0

    def percentile(self, q: float, window: str = "warm") -> float:
        """Latency percentile over one sliding window (``warm``/``cold``),
        linearly interpolated; 0.0 on an empty window."""
        if window not in ("warm", "cold"):
            raise ValueError(f"unknown latency window {window!r}")
        samples = sorted(getattr(self, f"{window}_us"))
        if not samples:
            return 0.0
        rank = (q / 100.0) * (len(samples) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(samples) - 1)
        frac = rank - lo
        return samples[lo] * (1.0 - frac) + samples[hi] * frac


@dataclass
class SessionResult:
    """One submit's answer plus its service provenance: ``result`` is the
    executor's :class:`DataplaneJoinResult`, ``plan_cache_hit`` says whether
    the plan LRU served the compiled program, and the ``*_us`` fields break
    the submit's wall clock into statistics / compile / execute phases."""

    result: DataplaneJoinResult
    plan_key: Tuple
    plan_cache_hit: bool
    stats_us: float
    compile_us: float
    execute_us: float
    total_us: float

    @property
    def count(self) -> int:
        return self.result.count

    @property
    def rows(self):
        return self.result.rows

    @property
    def per_h_counts(self):
        return self.result.per_h_counts

    @property
    def retries(self) -> int:
        return self.result.retries

    @property
    def retry_log(self) -> list:
        return self.result.retry_log

    @property
    def caps_hits(self) -> int:
        return self.result.caps_hits

    @property
    def caps_misses(self) -> int:
        return self.result.caps_misses


class JoinSession:
    """A persistent join service over one executor: repeated ``submit`` calls
    with cross-query plan reuse.

    Args:
        p: machine count every submitted plan is compiled for (the
            executor's p as well).
        device: where the data plane runs — ``cuda`` by default (raises when
            CUDA is absent); ``"cpu"`` runs the plain PyTorch path.
        executor: optionally inject a configured :class:`DataplaneExecutor`
            (e.g. ``batch_stages=False``); ``device`` is then ignored.
        plan_cache_size: LRU bound on cached compiled programs.
        fuse_semijoin: default fusion flag for submits that don't pass one.
        slo_target_us: per-query latency SLO counted into ``stats``.

    Thread-safety: submits are serialized under one lock."""

    def __init__(
        self,
        p: int,
        device=None,
        executor: Optional[DataplaneExecutor] = None,
        plan_cache_size: int = 64,
        fuse_semijoin: bool = False,
        slo_target_us: Optional[float] = None,
    ):
        self.p = p
        self.executor = executor if executor is not None else DataplaneExecutor(p, device=device)
        self.fuse_semijoin = fuse_semijoin
        self.plan_cache_size = plan_cache_size
        self.slo_target_us = slo_target_us
        self._plans: "OrderedDict[Tuple, object]" = OrderedDict()
        self.stats = ServiceStats()
        self._lock = threading.RLock()

    def submit(
        self,
        query: JoinQuery,
        lam: Optional[int] = None,
        stats: Optional[HeavyStats] = None,
        materialize: bool = True,
        h_subsets: Optional[Sequence[Sequence[Attr]]] = None,
        fuse_semijoin: Optional[bool] = None,
        deadline_s: Optional[float] = None,
        _unique_memo: Optional[Dict] = None,
    ) -> SessionResult:
        """Answer one join query, reusing every cached artifact that applies.

        Args:
            query: the join query (concrete relations attached).
            lam: heavy parameter λ; default Θ(p^{1/(2ρ)}) per the paper.
            stats: inject a precomputed histogram (default: computed).
            materialize: return result rows (False: counts only).
            h_subsets: restrict the H-taxonomy (testing).
            fuse_semijoin: override the session's default fusion flag.
            deadline_s: monotonic-clock budget in seconds, checked between
                dispatches.

        Raises:
            A typed :class:`~repro_torch.mpc.faults.JoinServiceError` naming
            the query on any failure, with the root cause on ``__cause__``.
        """
        with self._lock:
            deadline = None if deadline_s is None else time.monotonic() + deadline_s
            plan_key = None
            try:
                fuse = self.fuse_semijoin if fuse_semijoin is None else fuse_semijoin
                if lam is None:
                    lam = stats.lam if stats is not None else heavy_parameter(
                        self.p, float(rho(query))
                    )
                t0 = time.perf_counter()
                if stats is None:
                    stats = compute_stats(query, lam, unique_memo=_unique_memo)
                stats_us = (time.perf_counter() - t0) * 1e6

                plan_key = plan_cache_key(query, stats, self.p, h_subsets, fuse)
                cached = self._plans.get(plan_key)
                compile_us = 0.0
                if cached is not None:
                    self._plans.move_to_end(plan_key)
                    program = cached.rebind(query)
                    self.stats.plan_hits += 1
                else:
                    t0 = time.perf_counter()
                    program = compile_plan(query, stats, self.p, h_subsets=h_subsets,
                                           fuse_semijoin=fuse)
                    compile_us = (time.perf_counter() - t0) * 1e6
                    # cache plan metadata only: data is rebound on every hit
                    self._plans[plan_key] = replace(program, query=None)
                    self.stats.plan_misses += 1
                    while len(self._plans) > self.plan_cache_size:
                        self._plans.popitem(last=False)
                        self.stats.plan_evictions += 1
                self.stats.cached_plans = len(self._plans)

                if deadline is not None and time.monotonic() > deadline:
                    raise DeadlineExceededError(
                        f"query {describe_query(query)} exceeded its deadline "
                        "before execution", query=query, deadline_s=deadline,
                    )
                t0 = time.perf_counter()
                results, batch = self.executor.run_many(
                    [program], config=RunConfig(materialize=materialize, deadline=deadline)
                )
                execute_us = (time.perf_counter() - t0) * 1e6
            except Exception as e:
                err = self._fail(query, plan_key, e)
                if err is e:
                    raise
                raise err from e
            finally:
                self.stats.quarantined_caps = self.executor.caps_quarantined

            self.stats.retries += batch.retries
            self.stats.caps_hits += batch.caps_hits
            self.stats.caps_misses += batch.caps_misses
            self.stats.caps_evictions += batch.caps_evictions
            total_us = stats_us + compile_us + execute_us
            self.stats.submits += 1
            (self.stats.warm_us if cached is not None else self.stats.cold_us).append(total_us)
            if self.slo_target_us is not None:
                if total_us <= self.slo_target_us:
                    self.stats.slo_ok += 1
                else:
                    self.stats.slo_violations += 1
            return SessionResult(
                result=results[0], plan_key=plan_key, plan_cache_hit=cached is not None,
                stats_us=stats_us, compile_us=compile_us, execute_us=execute_us,
                total_us=total_us,
            )

    def _fail(self, query: JoinQuery, plan_key, e: Exception) -> JoinServiceError:
        """Map a failure onto the typed taxonomy and quarantine the plan it
        used (the next submit recompiles instead of re-failing forever)."""
        self.stats.failed += 1
        if plan_key is not None and self._plans.pop(plan_key, None) is not None:
            self.stats.quarantined_plans += 1
            self.stats.cached_plans = len(self._plans)
        if isinstance(e, DeadlineExceededError):
            self.stats.deadline_exceeded += 1
            if e.query is None:
                return DeadlineExceededError(
                    f"query {describe_query(query)}: {e}", query=query,
                    op_round=e.op_round, deadline_s=e.deadline_s,
                )
            return e
        if isinstance(e, QueryFailedError):
            return e
        return QueryFailedError(query, e, attempt_log=getattr(e, "attempt_log", ()))

    def submit_batch(
        self,
        queries: Sequence[JoinQuery],
        lam: Optional[int] = None,
        materialize: bool = True,
        fuse_semijoin: Optional[bool] = None,
    ) -> List[SessionResult]:
        """Answer a batch of queries serially, sharing per-table work: queries
        binding the same physical ``Relation.table`` compute the histogram's
        per-(table, column) unique-count pass once.  Results are identical to
        one :meth:`submit` per query, in order."""
        memo: Dict = {}
        return [
            self.submit(q, lam=lam, materialize=materialize, fuse_semijoin=fuse_semijoin,
                        _unique_memo=memo)
            for q in queries
        ]

    def clear_plans(self) -> None:
        """Drop every cached compiled program (executor state is kept)."""
        self._plans.clear()
        self.stats.cached_plans = 0

    @property
    def cached_plan_keys(self) -> List[Tuple]:
        """Plan-LRU keys, oldest first."""
        return list(self._plans.keys())
