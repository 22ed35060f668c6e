"""Persistent join service: one long-lived session, many queries, cross-query reuse.

The Theorem 6.2 plan is a pure function of the query's hypergraph and the
histogram, never of the concrete tuples, so a session that answers the same
shapes over and over can reuse it.  :class:`JoinSession` keeps:

  * **a plan cache** — compiled programs in an LRU keyed by
    :func:`~repro_torch.mpc.program.plan_cache_key` (query structure plus the
    full histogram signature).  A hit skips the planner LPs and the taxonomy
    sweep; the cached program is rebound onto the submitted data.
  * **a statistics memo** — the histogram of each (λ, bound tables' content)
    in an LRU of the same size, keyed by a digest of every bound table taken
    once per submit (on the card for a CUDA session's large tables; handed
    on to the executor's learned-caps key), so a resubmit over unchanged
    tables skips ``compute_stats``.
  * **one executor** — a :class:`DataplaneExecutor` living as long as the
    session, whose learned capacities make a warm repeat of a query run with
    zero overflow retries.  ``backend="simulator"`` runs each submit instead
    on a fresh metered :class:`~repro_torch.mpc.simulator.MPCSimulator`
    (host numpy): exact per-round loads, the statistics from the three
    metered rounds of ``distributed_stats``.
  * **batch submission** — :meth:`JoinSession.submit_batch` shares the
    histogram's per-table unique-count pass across queries binding the same
    physical ``Relation.table`` (on the simulator: the first query's scatter
    placement).
  * **cross-query coalescing** — :meth:`JoinSession.submit_async` enqueues
    requests into a bounded submission queue; a drainer thread groups queued
    queries whose compiled programs share a
    :func:`~repro_torch.mpc.program.coalesce_signature` and runs each group
    through ONE pass of the stage-batched scheduler
    (:meth:`DataplaneExecutor.run_many`), so stages of different queries in
    one geometry bucket share a kernel launch.  Identical submissions (same
    plan key, same bound tables) run once and share the result.  Results are
    byte-identical to serial :meth:`JoinSession.submit`;
    :meth:`JoinSession.submit_coalesced` is the synchronous door.  A full
    queue rejects with :class:`AdmissionError`.
  * **failure semantics** — every failed request resolves exactly once with
    a typed :class:`~repro_torch.mpc.faults.JoinServiceError` naming its
    query; a failed coalesced group falls back to per-member serial runs so
    a poisoned member fails alone; a crashed drainer resolves everything
    pending with :class:`~repro_torch.mpc.faults.DegradedSessionError` and
    leaves the session degraded until :meth:`JoinSession.restart`.

Every submit returns a :class:`SessionResult` with per-phase latency and
cache provenance; :attr:`JoinSession.stats` accumulates the session-wide
:class:`ServiceStats`.  With ``verify`` on (the ``REPRO_VERIFY`` env var by
default) a plan-cache miss runs the full static verifier
(:mod:`repro_torch.mpc.verify`) before its first kernel, and a hit re-checks
the fresh bindings.  Each request's phases are spans
(:mod:`repro_torch.spans`) under the request's own id: ``stats``
(``digest``), ``plan`` (``compile``, ``verify``) and ``execute``, with the
executor's spans below it.
"""

from __future__ import annotations

import itertools
import math
import queue as queue_mod
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core.hypergraph import rho
from ..core.planner import heavy_parameter
from ..core.query import Attr, JoinQuery, relation_digests
from ..core.taxonomy import HeavyStats, compute_stats
from ..kernels.digest import chunk_digests
from ..spans import Trace, activate, count, span
from ..train.fault import Heartbeat, StragglerMonitor
from .executors import DataplaneExecutor, DataplaneJoinResult, MPCJoinResult, SimulatorExecutor
from .faults import (
    DeadlineExceededError,
    DegradedSessionError,
    JoinServiceError,
    ProgramVerificationError,
    QueryFailedError,
    describe_query,
)
from .program import (
    RoundProgram,
    RunConfig,
    _verify_default,
    coalesce_signature,
    compile_plan,
    plan_cache_key,
)
from .simulator import MPCSimulator
from .statistics import distributed_stats
from .verify import verify_bindings, verify_program

#: sliding-window size of the ServiceStats latency samples.
LATENCY_WINDOW = 512


class AdmissionError(RuntimeError):
    """The submission queue is full — the request was rejected, not queued.

    Backpressure signal of the bounded async queue: callers should retry
    later or shed load; ``ServiceStats.rejected`` counts these."""


@dataclass
class ServiceStats:
    """Session-wide service counters (live object on :attr:`JoinSession.stats`).

    ``plan_hits``/``plan_misses``/``plan_evictions`` meter the plan LRU;
    ``caps_hits``/``caps_misses``/``caps_evictions`` the executor's learned
    capacities; ``retries`` the scheduler's overflow retries.  ``cold_us``/
    ``warm_us`` collect per-submit latencies split by plan-cache outcome over
    a sliding window, and ``e2e_us`` the queue-inclusive latencies of async
    submits; ``slo_ok``/``slo_violations`` count submits against the
    session's ``slo_target_us`` (e2e when queued, service time otherwise).
    ``failed`` counts requests resolved with a typed
    :class:`~repro_torch.mpc.faults.JoinServiceError`, ``deadline_exceeded``
    the subset that hit their budget.

    The coalescing layer adds ``async_submits`` (requests entering the
    queue), ``rejected`` (admission-control bounces), ``coalesced_batches``/
    ``coalesced_queries``/``max_coalesced_batch`` (multi-query batches) and
    ``deduped`` (requests served by an identical member's execution).  The
    robustness layer adds ``degraded_fallbacks`` (coalesced groups whose
    fused run failed and fell back to per-member serial runs),
    ``drainer_crashes``, ``slow_batches`` (drain batches the
    :class:`~repro_torch.train.fault.StragglerMonitor` flagged) and
    ``quarantined_caps``/``quarantined_plans`` (cache entries dropped because
    a failed attempt touched them).

    The verification layer adds ``verified`` (submits whose compiled program
    passed the *full* static verifier — plan-cache misses only) and
    ``verify_us`` (all time spent verifying, full or bindings-only)."""

    submits: int = 0
    plan_hits: int = 0
    plan_misses: int = 0
    plan_evictions: int = 0
    cached_plans: int = 0
    retries: int = 0
    caps_hits: int = 0
    caps_misses: int = 0
    caps_evictions: int = 0
    async_submits: int = 0
    rejected: int = 0
    coalesced_batches: int = 0
    coalesced_queries: int = 0
    max_coalesced_batch: int = 0
    deduped: int = 0
    failed: int = 0
    deadline_exceeded: int = 0
    degraded_fallbacks: int = 0
    drainer_crashes: int = 0
    slow_batches: int = 0
    quarantined_caps: int = 0
    quarantined_plans: int = 0
    slo_ok: int = 0
    slo_violations: int = 0
    verified: int = 0
    verify_us: float = 0.0
    cold_us: Deque[float] = field(default_factory=lambda: deque(maxlen=LATENCY_WINDOW))
    warm_us: Deque[float] = field(default_factory=lambda: deque(maxlen=LATENCY_WINDOW))
    e2e_us: Deque[float] = field(default_factory=lambda: deque(maxlen=LATENCY_WINDOW))

    @property
    def mean_cold_us(self) -> float:
        return sum(self.cold_us) / len(self.cold_us) if self.cold_us else 0.0

    @property
    def mean_warm_us(self) -> float:
        return sum(self.warm_us) / len(self.warm_us) if self.warm_us else 0.0

    def percentile(self, q: float, window: str = "warm") -> float:
        """Latency percentile over one sliding window (``warm``/``cold``/
        ``e2e``), linearly interpolated; 0.0 on an empty window."""
        if window not in ("warm", "cold", "e2e"):
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
    backend's result (:class:`DataplaneJoinResult`, or
    :class:`MPCJoinResult` on the simulator), ``plan_cache_hit`` says whether
    the plan LRU served the compiled program, and the ``*_us`` fields break
    the submit's wall clock into statistics / compile / verify / execute
    phases.  ``verified`` is True when the full static verifier ran
    (plan-cache miss); a hit re-checks bindings only and reports False.

    ``spans_us`` holds the request's inclusive µs by span path (``stats``,
    ``stats/digest``, ``plan``, ``plan/compile``, ``execute``,
    ``execute/op.LocalJoin/stage``, ...) and ``counters`` its counts by
    ``<span path>:<name>`` (``stats:memo_hits``, ``stats:memo_misses``,
    ``stats/digest:card_bytes``, ``stats/digest:host_bytes``, ``h2d_bytes``,
    ``d2h_bytes``, ``d2h_row_bytes``): every span its execution ran, a
    shared coalesced execution included.

    Coalescing provenance: ``coalesced`` is True when the request ran inside
    a multi-query scheduler pass (its ``execute_us`` is then the pass's
    shared wall), ``batch_size`` is the size of its batch, ``deduplicated``
    says an identical submission executed and this request shares its
    result object; ``queue_us``/``e2e_us`` are nonzero only for
    :meth:`JoinSession.submit_async` requests (time queued, and enqueue to
    resolution)."""

    result: Union[DataplaneJoinResult, MPCJoinResult]
    plan_key: Tuple
    plan_cache_hit: bool
    stats_us: float
    compile_us: float
    execute_us: float
    total_us: float
    coalesced: bool = False
    batch_size: int = 1
    deduplicated: bool = False
    queue_us: float = 0.0
    e2e_us: float = 0.0
    verified: bool = False
    verify_us: float = 0.0
    spans_us: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)

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
        return getattr(self.result, "retries", 0)

    @property
    def retry_log(self) -> list:
        return getattr(self.result, "retry_log", [])

    @property
    def caps_hits(self) -> int:
        return getattr(self.result, "caps_hits", 0)

    @property
    def caps_misses(self) -> int:
        return getattr(self.result, "caps_misses", 0)

    @property
    def caps_evictions(self) -> int:
        return getattr(self.result, "caps_evictions", 0)


@dataclass
class _Request:
    """One queued (or inline) submission flowing through ``_execute_batch``."""

    query: JoinQuery
    lam: Optional[int] = None
    stats: Optional[HeavyStats] = None
    materialize: bool = True
    h_subsets: Optional[Sequence[Sequence[Attr]]] = None
    fuse_semijoin: Optional[bool] = None
    batch: Optional[Dict] = None          # shared per-table memos of one batch
    future: Optional[Future] = None       # async submits resolve through this
    t_enqueue: Optional[float] = None     # perf_counter at queue admission
    deadline: Optional[float] = None      # absolute monotonic budget (or None)
    trace: Optional[Trace] = None         # the request's spans, from _execute_batch on
    # filled by _prepare:
    digests: Tuple[bytes, ...] = ()       # relation_digests of the bound tables
    executor: object = None
    program: Optional[RoundProgram] = None
    plan_key: Optional[Tuple] = None
    plan_cache_hit: bool = False
    stats_us: float = 0.0
    compile_us: float = 0.0
    verified: bool = False
    verify_us: float = 0.0
    error: Optional[BaseException] = None


#: drainer shutdown sentinel (enqueued by :meth:`JoinSession.close`).
_SHUTDOWN = object()


class JoinSession:
    """A persistent join service over one executor: repeated ``submit`` calls
    with cross-query plan reuse, and an asynchronous, coalescing queue.

    Args:
        p: machine count every submitted plan is compiled for (the
            executor's p as well).
        device: where the data plane runs — ``cuda`` by default (raises when
            CUDA is absent); ``"cpu"`` runs the plain PyTorch path.  Unused
            on the simulator backend.
        executor: optionally inject a configured :class:`DataplaneExecutor`
            (e.g. ``batch_stages=False``); ``device`` is then ignored.
            Ignored on the simulator backend.
        plan_cache_size: LRU bound on cached compiled programs, and on
            memoised statistics.
        fuse_semijoin: default fusion flag for submits that don't pass one.
        slo_target_us: per-query latency SLO counted into ``stats`` (async
            submits judged on queue-inclusive latency).
        max_queue: admission bound of the async submission queue — a full
            queue rejects :meth:`submit_async` with :class:`AdmissionError`.
        max_coalesce: most requests one drain batch may coalesce.
        async_autostart: start the drainer thread lazily on the first
            :meth:`submit_async` (disable to drive the queue deterministically
            through :meth:`close`).
        fault_plan: a :class:`~repro_torch.mpc.faults.FaultPlan` consulted at
            the executor's sites and the drainer (None = no injection).
        heartbeat_path: when set, the drainer writes a
            :class:`~repro_torch.train.fault.Heartbeat` file before every
            drain batch.
        straggler_factor: drain batches slower than ``factor ×`` the running
            EMA count into ``stats.slow_batches``.
        backend: ``"dataplane"`` (default — the long-lived
            :class:`DataplaneExecutor`) or ``"simulator"`` (a fresh metered
            :class:`~repro_torch.mpc.simulator.MPCSimulator` per submit, host
            numpy, so each query gets its own load ledger; plans are still
            cached across submits, and coalesced submits run serially).
        seed: shared-randomness seed of the simulator (scatter + routing
            hashes).
        verify: run the static verifier on every submit — the full pass on a
            plan-cache miss (with the executor's learned capacities), the
            bindings re-check on a hit.  None defers to the ``REPRO_VERIFY``
            env var (off unless set).

    Thread-safety: all executor access is serialized under one re-entrant
    lock; the drainer runs its batches on the session's device and the
    current stream of that device, as a submit from any other thread does."""

    def __init__(
        self,
        p: int,
        device=None,
        executor: Optional[DataplaneExecutor] = None,
        plan_cache_size: int = 64,
        fuse_semijoin: bool = False,
        slo_target_us: Optional[float] = None,
        max_queue: int = 256,
        max_coalesce: int = 32,
        async_autostart: bool = True,
        fault_plan=None,
        heartbeat_path=None,
        straggler_factor: float = 2.5,
        backend: str = "dataplane",
        seed: int = 0,
        verify: Optional[bool] = None,
    ):
        if backend not in ("dataplane", "simulator"):
            raise ValueError(f"unknown backend {backend!r}")
        if max_coalesce < 1:
            raise ValueError("max_coalesce must be >= 1")
        self.p = p
        self.backend = backend
        self.seed = seed
        self.verify = _verify_default() if verify is None else bool(verify)
        self.executor: Optional[DataplaneExecutor] = None
        if backend == "dataplane":
            self.executor = (
                executor if executor is not None else DataplaneExecutor(p, device=device)
            )
        self.fuse_semijoin = fuse_semijoin
        self.plan_cache_size = plan_cache_size
        self.slo_target_us = slo_target_us
        self.max_coalesce = max_coalesce
        self.async_autostart = async_autostart
        self.fault_plan = fault_plan
        #: the card the drainer thread runs on (None on the CPU)
        self._cuda_index: Optional[int] = None
        dev = self.executor.device if self.executor is not None else None
        if dev is not None and dev.type == "cuda":
            self._cuda_index = dev.index if dev.index is not None else torch.cuda.current_device()
        self._plans: "OrderedDict[Tuple, RoundProgram]" = OrderedDict()
        self._stats_memo: "OrderedDict[Tuple, HeavyStats]" = OrderedDict()
        self.stats = ServiceStats()
        self._lock = threading.RLock()
        self._queue: "queue_mod.Queue" = queue_mod.Queue(maxsize=max_queue)
        self._drainer: Optional[threading.Thread] = None
        # guards the drainer's start and the counters client threads update
        self._admit_lock = threading.Lock()
        self._closed = False
        self._degraded_cause: Optional[BaseException] = None
        self._monitor = StragglerMonitor(factor=straggler_factor, warmup=1)
        self._heartbeat = Heartbeat(heartbeat_path) if heartbeat_path is not None else None
        self._batch_seq = 0
        self._request_ids = itertools.count()

    # -- single-query entry ---------------------------------------------------

    def submit(
        self,
        query: JoinQuery,
        lam: Optional[int] = None,
        stats: Optional[HeavyStats] = None,
        materialize: bool = True,
        h_subsets: Optional[Sequence[Sequence[Attr]]] = None,
        fuse_semijoin: Optional[bool] = None,
        deadline_s: Optional[float] = None,
        _batch: Optional[Dict] = None,
    ) -> SessionResult:
        """Answer one join query, reusing every cached artifact that applies.

        Args:
            query: the join query (concrete relations attached).
            lam: heavy parameter λ; default Θ(p^{1/(2ρ)}) per the paper.
            stats: inject a precomputed histogram; by default the simulator
                backend runs the 3 metered rounds of the distributed protocol
                and the dataplane backend computes the centralized oracle.
            materialize: return result rows (False: counts only).
            h_subsets: restrict the H-taxonomy (testing).
            fuse_semijoin: override the session's default fusion flag.
            deadline_s: monotonic-clock budget in seconds, checked between
                dispatches.

        Raises:
            A typed :class:`~repro_torch.mpc.faults.JoinServiceError` naming
            the query on any failure, with the root cause (executor frames
            included) on ``__cause__``.
        """
        req = _Request(
            query=query, lam=lam, stats=stats, materialize=materialize,
            h_subsets=h_subsets, fuse_semijoin=fuse_semijoin, batch=_batch,
            deadline=self._abs_deadline(deadline_s),
        )
        out = self._execute_batch([req])[0]
        if isinstance(out, BaseException):
            # re-raise with the stored traceback intact
            raise out.with_traceback(out.__traceback__)
        return out

    # -- async / coalescing entry ---------------------------------------------

    def submit_async(
        self,
        query: JoinQuery,
        lam: Optional[int] = None,
        stats: Optional[HeavyStats] = None,
        materialize: bool = True,
        h_subsets: Optional[Sequence[Sequence[Attr]]] = None,
        fuse_semijoin: Optional[bool] = None,
        block: bool = True,
        timeout: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> "Future[SessionResult]":
        """Enqueue one query; a drainer coalesces concurrent requests.

        Returns a :class:`concurrent.futures.Future` resolving to the same
        :class:`SessionResult` a serial :meth:`submit` would produce (byte-
        identical rows), with ``queue_us``/``e2e_us`` filled in.

        Admission control: the queue is bounded at ``max_queue``; with
        ``block=False`` (or when ``timeout`` elapses) a full queue raises
        :class:`AdmissionError` and increments ``stats.rejected``.
        ``deadline_s`` starts at admission, so time spent queued counts.
        A closed session raises ``RuntimeError``; a degraded one (drainer
        crashed) raises :class:`~repro_torch.mpc.faults.DegradedSessionError`
        until :meth:`restart`."""
        if self._closed:
            raise RuntimeError("session is closed")
        if self._degraded_cause is not None:
            raise DegradedSessionError(
                "session is degraded (drainer crashed); call restart()",
                cause=self._degraded_cause,
            )
        req = _Request(
            query=query, lam=lam, stats=stats, materialize=materialize,
            h_subsets=h_subsets, fuse_semijoin=fuse_semijoin,
            future=Future(), t_enqueue=time.perf_counter(),
            deadline=self._abs_deadline(deadline_s),
        )
        try:
            self._queue.put(req, block=block, timeout=timeout)
        except queue_mod.Full:
            with self._admit_lock:
                self.stats.rejected += 1
            raise AdmissionError(
                f"submission queue full ({self._queue.maxsize} pending)"
            ) from None
        with self._admit_lock:
            self.stats.async_submits += 1
        if self.async_autostart:
            self.start()
        return req.future

    def submit_coalesced(
        self,
        queries: Sequence[JoinQuery],
        lam: Optional[int] = None,
        materialize: bool = True,
        fuse_semijoin: Optional[bool] = None,
        deadline_s: Optional[float] = None,
    ) -> List[SessionResult]:
        """Answer several queries through ONE coalesced scheduler pass.

        The synchronous twin of draining ``len(queries)`` concurrent
        :meth:`submit_async` requests in one batch: same grouping by
        :func:`~repro_torch.mpc.program.coalesce_signature`, same identical-
        submission dedup, same demux.  Results are in submission order and
        byte-identical to one :meth:`submit` per query.  The first failing
        member's error raises (traceback preserved)."""
        share: Dict = {"scatter": {}, "unique": {}, "digest": {}}
        reqs = [
            _Request(
                query=q, lam=lam, materialize=materialize,
                fuse_semijoin=fuse_semijoin, batch=share,
                deadline=self._abs_deadline(deadline_s),
            )
            for q in queries
        ]
        outs = self._execute_batch(reqs)
        for out in outs:
            if isinstance(out, BaseException):
                raise out.with_traceback(out.__traceback__)
        return outs

    @staticmethod
    def _abs_deadline(deadline_s: Optional[float]) -> Optional[float]:
        """Relative budget (seconds) → absolute ``time.monotonic`` instant."""
        return None if deadline_s is None else time.monotonic() + deadline_s

    def start(self) -> None:
        """Start the drainer thread (idempotent; ``submit_async`` autostarts
        unless the session was built with ``async_autostart=False``).  A
        degraded session refuses — :meth:`restart` is the way back."""
        if self._degraded_cause is not None:
            raise DegradedSessionError(
                "session is degraded (drainer crashed); call restart()",
                cause=self._degraded_cause,
            )
        with self._admit_lock:      # concurrent first submits start one drainer
            if self._drainer is None or not self._drainer.is_alive():
                self._drainer = threading.Thread(
                    target=self._drain_loop, name="join-session-drainer", daemon=True
                )
                self._drainer.start()

    @property
    def degraded(self) -> bool:
        """True after a drainer crash, until :meth:`restart`."""
        return self._degraded_cause is not None

    def restart(self) -> None:
        """Recover from a drainer crash: clear the degraded state, reset the
        straggler monitor's latency model and start a fresh drainer.  The
        executor's caches are kept: what a failed attempt touched was
        quarantined when it failed."""
        if self._closed:
            raise JoinServiceError("cannot restart a closed session")
        self._degraded_cause = None
        self._monitor.reset()
        self.start()

    def close(self, wait: bool = True) -> None:
        """Stop accepting async submits and drain what is already queued.

        With a live drainer the shutdown sentinel is enqueued and (when
        ``wait``) joined; then any request still queued is swept, so every
        admitted request resolves exactly once: executed inline on a healthy
        session, failed with :class:`~repro_torch.mpc.faults.DegradedSessionError`
        on a degraded one."""
        if self._closed:
            return
        self._closed = True
        if self._drainer is not None and self._drainer.is_alive():
            self._queue.put(_SHUTDOWN)
            if not wait:
                return
            self._drainer.join()
        pending: List[_Request] = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue_mod.Empty:
                break
            if item is not _SHUTDOWN:
                pending.append(item)
        if self._degraded_cause is not None:
            err = DegradedSessionError(
                "session closed while degraded (drainer crashed)",
                cause=self._degraded_cause,
            )
            for req in pending:
                if self._resolve(req, err):
                    self.stats.failed += 1
            return
        while pending:
            batch, pending = pending[: self.max_coalesce], pending[self.max_coalesce:]
            self._process(batch)

    def __enter__(self) -> "JoinSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _drain_loop(self) -> None:
        """Drainer: block on the queue, then coalesce everything already
        waiting (up to ``max_coalesce``) into one batch.

        The loop body is guarded: an exception escaping it (``_process``
        itself never raises; this is the heartbeat/injection window between
        dequeue and demux) degrades the session through
        :meth:`_enter_degraded` instead of leaving a dead thread with hung
        futures."""
        if self._cuda_index is not None:
            try:
                # the session's card, whose current stream a submit uses too
                torch.cuda.set_device(self._cuda_index)
            except BaseException as e:
                self._enter_degraded(e, [])
                return
        while True:
            item = self._queue.get()
            if item is _SHUTDOWN:
                return
            batch = [item]
            stop = False
            while len(batch) < self.max_coalesce:
                try:
                    nxt = self._queue.get_nowait()
                except queue_mod.Empty:
                    break
                if nxt is _SHUTDOWN:
                    stop = True
                    break
                batch.append(nxt)
            try:
                seq = self._batch_seq
                self._batch_seq = seq + 1
                if self._heartbeat is not None:
                    self._heartbeat.beat(seq)
                if self.fault_plan is not None:
                    self.fault_plan.at_drainer()
                t0 = time.perf_counter()
                self._process(batch)
                if self._monitor.record(seq, time.perf_counter() - t0):
                    self.stats.slow_batches += 1
            except BaseException as e:
                self._enter_degraded(e, batch)
                return
            if stop:
                return

    def _enter_degraded(self, cause: BaseException, inflight: List[_Request]) -> None:
        """Drainer-crash path: resolve the in-flight batch AND everything
        still queued with :class:`~repro_torch.mpc.faults.DegradedSessionError`
        (zero hung futures), then flip the session degraded so new
        :meth:`submit_async` calls fail fast until :meth:`restart`."""
        self._degraded_cause = cause
        self.stats.drainer_crashes += 1
        err = DegradedSessionError(f"session drainer crashed: {cause!r}", cause=cause)
        pending = list(inflight)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue_mod.Empty:
                break
            if item is not _SHUTDOWN:
                pending.append(item)
        for req in pending:
            if self._resolve(req, err):
                self.stats.failed += 1

    @staticmethod
    def _resolve(req: _Request, out) -> bool:
        """Resolve a request's future exactly once; True if this call did it.

        The done() guard (plus the InvalidStateError backstop for the racing
        case) lets the crash paths run concurrently with the normal demux: a
        future only ever carries one outcome."""
        fut = req.future
        if fut is None or fut.done():
            return False
        try:
            if isinstance(out, BaseException):
                fut.set_exception(out)
            else:
                fut.set_result(out)
        except Exception:       # InvalidStateError: someone else won the race
            return False
        return True

    def _process(self, batch: List[_Request]) -> None:
        """Execute one drain batch and resolve its futures (never raises —
        a drainer must survive any single request's failure).  Whatever
        escapes ``_execute_batch`` (a card error outside any one request's
        run) still resolves each request with a typed error."""
        try:
            outs = self._execute_batch(batch)
        except BaseException as e:
            outs = []
            for req in batch:
                req.error = e
                outs.append(self._typed_error(req))
                self.stats.failed += 1
        for req, out in zip(batch, outs):
            self._resolve(req, out)

    # -- the shared execution path --------------------------------------------

    def _prepare(self, req: _Request, share: Dict) -> None:
        """Phase 1 of a submit: table digests, histogram (memoised on the
        dataplane), plan-cache lookup, compile on miss.

        Fills the request in place; any failure lands in ``req.error`` so one
        bad query never poisons the rest of a coalesced batch."""
        try:
            fuse = self.fuse_semijoin if req.fuse_semijoin is None else req.fuse_semijoin
            lam, stats = req.lam, req.stats
            if lam is None:
                lam = stats.lam if stats is not None else heavy_parameter(
                    self.p, float(rho(req.query))
                )
            with span("stats") as sp:
                if self.backend == "simulator":
                    sim = MPCSimulator(self.p, seed=self.seed)
                    executor: object = SimulatorExecutor(sim, seed=self.seed)
                    executor.place_inputs(req.query, scatter_cache=share.get("scatter"))
                    if stats is None:
                        stats = distributed_stats(sim, req.query, lam)
                else:
                    executor = self.executor
                    with span("digest"):
                        req.digests = relation_digests(
                            req.query, share["digest"],
                            partial(chunk_digests, device=executor.device))
                    if stats is None:
                        stats = self._memo_stats(req, lam, share)
            req.stats_us = sp.us

            with span("plan"):
                key = plan_cache_key(req.query, stats, self.p, req.h_subsets, fuse)
                cached = self._plans.get(key)
                if cached is not None:
                    self._plans.move_to_end(key)
                    req.program = cached.rebind(req.query)
                    self.stats.plan_hits += 1
                    if self.verify:
                        # warm path: the cached plan was verified when it was
                        # compiled; only the fresh bindings need re-checking
                        with span("verify") as sp:
                            verify_bindings(req.program)
                        req.verify_us = sp.us
                else:
                    with span("compile") as sp:
                        req.program = compile_plan(req.query, stats, self.p,
                                                   h_subsets=req.h_subsets, fuse_semijoin=fuse,
                                                   verify=False)  # timed separately below
                    req.compile_us = sp.us
                    if self.verify:
                        with span("verify") as sp:
                            verify_program(req.program,
                                           caps=getattr(executor, "_learned_caps", None))
                        req.verify_us = sp.us
                        req.verified = True
                    # cache plan metadata only: data is rebound on every hit
                    self._plans[key] = replace(req.program, query=None)
                    self.stats.plan_misses += 1
                    while len(self._plans) > self.plan_cache_size:
                        self._plans.popitem(last=False)
                        self.stats.plan_evictions += 1
            req.executor = executor
            req.plan_key = key
            req.plan_cache_hit = cached is not None
        except BaseException as e:
            req.error = e

    def _memo_stats(self, req: _Request, lam: int, share: Dict) -> HeavyStats:
        """``compute_stats`` through the session's statistics memo.

        The statistics are a pure function of λ and each relation's scheme
        and rows, so the key is λ and each relation's (scheme, content
        digest, length): a resubmit over unchanged tables reuses the
        histogram, and a table written in place misses.  The memo holds
        digests and histograms, never the tables, LRU-bounded by
        ``plan_cache_size``; the histograms it hands out are read-only."""
        key = (lam, tuple((rel.scheme, d, len(rel))
                          for rel, d in zip(req.query.relations, req.digests)))
        stats = self._stats_memo.get(key)
        count("memo_hits", stats is not None)
        count("memo_misses", stats is None)
        if stats is not None:
            self._stats_memo.move_to_end(key)
            return stats
        stats = compute_stats(req.query, lam, unique_memo=share.get("unique"))
        self._stats_memo[key] = stats
        while len(self._stats_memo) > self.plan_cache_size:
            self._stats_memo.popitem(last=False)
        return stats

    def _execute_batch(self, reqs: List[_Request]) -> List[Union[SessionResult, BaseException]]:
        """Prepare, group, run and demux one batch of requests.

          1. requests group by ``(coalesce_signature(program), materialize)``:
             equal signatures mean identical op sequences and matching stage
             geometry, so the group shares one ``run_many`` pass;
          2. within a group, requests with identical executions — equal plan
             key AND the same bound table objects — run once and share the
             result (the ``deduped`` counter; results are read-only).

        The simulator backend runs the requests serially instead, each on its
        own metered simulator.  Scheduler counters aggregate into
        :attr:`stats` once per ``run_many`` call."""
        with self._lock:
            t_batch = time.perf_counter()
            # per-table memos of requests without their own
            share: Dict = {"scatter": {}, "unique": {}, "digest": {}}
            for req in reqs:
                req.trace = Trace(next(self._request_ids))
                with activate(req.trace):
                    self._prepare(req, req.batch if req.batch is not None else share)

            # deadline admission: a request already past its budget (e.g. it
            # queued behind a slow batch) fails before any dispatch
            now = time.monotonic()
            for req in reqs:
                if req.error is None and req.deadline is not None and now > req.deadline:
                    req.error = DeadlineExceededError(
                        f"query {describe_query(req.query)} exceeded its deadline "
                        "before execution", query=req.query, deadline_s=req.deadline,
                    )

            outs: Dict[int, SessionResult] = {}
            groups: "OrderedDict[Tuple, List[_Request]]" = OrderedDict()
            for req in reqs:
                if req.error is not None:
                    continue
                if self.backend == "simulator":
                    try:
                        with activate(req.trace), span("execute") as sp:
                            res = req.executor.run(req.program, materialize=req.materialize)
                    except BaseException as e:
                        req.error = e
                        continue
                    outs[id(req)] = self._wrap(
                        req, res, sp.us, len(reqs), coalesced=False, deduplicated=False,
                    )
                    continue
                gkey = (coalesce_signature(req.program), req.materialize)
                groups.setdefault(gkey, []).append(req)
            for members in groups.values():
                # identical-submission dedup: same plan key + same bound
                # table objects ⇒ same bytes out, so run once and share
                reps: List[_Request] = []
                assign: List[int] = []
                seen: Dict[Tuple, int] = {}
                for req in members:
                    dk = (req.plan_key, tuple(id(r.data) for r in req.query.relations))
                    if dk in seen:
                        assign.append(seen[dk])
                        self.stats.deduped += 1
                    else:
                        seen[dk] = len(reps)
                        assign.append(len(reps))
                        reps.append(req)
                deadlines = [r.deadline for r in reps if r.deadline is not None]
                try:
                    with activate(*(r.trace for r in members)), span("execute") as sp:
                        results, bstats = self.executor.run_many(
                            [r.program for r in reps],
                            config=RunConfig(
                                materialize=members[0].materialize,
                                deadline=min(deadlines) if deadlines else None,
                                fault_plan=self.fault_plan,
                                table_digests=tuple(r.digests for r in reps),
                            ),
                        )
                except BaseException as e:
                    if len(reps) == 1:
                        for req in members:
                            req.error = e
                    else:
                        # group isolation: the fused run is all-or-nothing,
                        # so fall back to per-member serial runs — the
                        # poisoned member fails alone and its batchmates get
                        # the bytes a serial submit gives (salts never depend
                        # on coalescing)
                        self.stats.degraded_fallbacks += 1
                        self._run_serial_fallback(members, reps, assign, outs, len(reqs))
                    continue
                execute_us = sp.us
                self._absorb(bstats)
                coalesced = len(members) > 1
                for req, ri in zip(members, assign):
                    outs[id(req)] = self._wrap(
                        req, results[ri], execute_us, len(reqs), coalesced=coalesced,
                        deduplicated=(req is not reps[ri]),
                    )

            if len(reqs) > 1:
                self.stats.coalesced_batches += 1
                self.stats.coalesced_queries += len(reqs)
                self.stats.max_coalesced_batch = max(self.stats.max_coalesced_batch, len(reqs))
            self.stats.cached_plans = len(self._plans)
            if self.executor is not None:
                # mirror of the executor's lifetime quarantine counter
                self.stats.quarantined_caps = self.executor.caps_quarantined

            t_done = time.perf_counter()
            final: List[Union[SessionResult, BaseException]] = []
            for req in reqs:
                if req.error is not None:
                    err = self._typed_error(req)
                    req.error = err
                    self.stats.failed += 1
                    if isinstance(err, DeadlineExceededError):
                        self.stats.deadline_exceeded += 1
                    # plan quarantine: the next submit recompiles instead of
                    # re-failing forever on a bad plan
                    if req.plan_key is not None and self._plans.pop(req.plan_key, None) is not None:
                        self.stats.quarantined_plans += 1
                        self.stats.cached_plans = len(self._plans)
                    final.append(err)
                    continue
                out = outs[id(req)]
                if req.t_enqueue is not None:
                    out.queue_us = max(0.0, (t_batch - req.t_enqueue) * 1e6)
                    out.e2e_us = (t_done - req.t_enqueue) * 1e6
                    self.stats.e2e_us.append(out.e2e_us)
                if self.slo_target_us is not None:
                    lat = out.e2e_us if req.t_enqueue is not None else out.total_us
                    if lat <= self.slo_target_us:
                        self.stats.slo_ok += 1
                    else:
                        self.stats.slo_violations += 1
                final.append(out)
            return final

    def _absorb(self, bstats) -> None:
        """Aggregate one ``run_many`` call's batch-level counters into
        :attr:`stats` (exactly once per scheduler pass)."""
        self.stats.retries += bstats.retries
        self.stats.caps_hits += bstats.caps_hits
        self.stats.caps_misses += bstats.caps_misses
        self.stats.caps_evictions += bstats.caps_evictions

    def _run_serial_fallback(self, members: List[_Request], reps: List[_Request],
                             assign: List[int], outs: Dict, batch_size: int) -> None:
        """After a fused coalesced run failed, run each deduplicated
        representative as its own scheduler pass (own deadline, fault plan
        still active).  Only the members whose representative fails get an
        error; every other result is byte-identical to a fault-free serial
        submit, because routing salts come from the query-unqualified stage
        key, never from the batch's shape."""
        rep_out: List = []
        for ri, rep in enumerate(reps):
            traces = [req.trace for req, a in zip(members, assign) if a == ri]
            try:
                with activate(*traces), span("execute") as sp:
                    res_list, bstats = self.executor.run_many(
                        [rep.program],
                        config=RunConfig(materialize=rep.materialize, deadline=rep.deadline,
                                         fault_plan=self.fault_plan,
                                         table_digests=(rep.digests,)),
                    )
            except BaseException as e:
                rep_out.append(e)
                continue
            self._absorb(bstats)
            rep_out.append((res_list[0], sp.us))
        for req, ri in zip(members, assign):
            o = rep_out[ri]
            if isinstance(o, BaseException):
                req.error = o
            else:
                res, ex_us = o
                outs[id(req)] = self._wrap(req, res, ex_us, batch_size, coalesced=False,
                                           deduplicated=(req is not reps[ri]))

    def _typed_error(self, req: _Request) -> JoinServiceError:
        """Map a request's raw failure onto the taxonomy, always naming the
        query and always chaining the root cause's traceback."""
        e = req.error
        if isinstance(e, DeadlineExceededError):
            if e.query is None:
                out = DeadlineExceededError(
                    f"query {describe_query(req.query)}: {e}", query=req.query,
                    op_round=e.op_round, deadline_s=e.deadline_s,
                )
                out.__cause__ = e
                return out
            return e
        if isinstance(e, (QueryFailedError, DegradedSessionError, AdmissionError,
                          ProgramVerificationError)):
            return e
        return QueryFailedError(req.query, e, attempt_log=getattr(e, "attempt_log", ()))

    def _wrap(self, req: _Request, res: Union[DataplaneJoinResult, MPCJoinResult],
              execute_us: float, batch_size: int, coalesced: bool,
              deduplicated: bool) -> SessionResult:
        total_us = req.stats_us + req.compile_us + req.verify_us + execute_us
        self.stats.submits += 1
        if req.verified:
            self.stats.verified += 1
        self.stats.verify_us += req.verify_us
        (self.stats.warm_us if req.plan_cache_hit else self.stats.cold_us).append(total_us)
        return SessionResult(
            result=res, plan_key=req.plan_key, plan_cache_hit=req.plan_cache_hit,
            stats_us=req.stats_us, compile_us=req.compile_us, execute_us=execute_us,
            total_us=total_us, coalesced=coalesced, batch_size=batch_size,
            deduplicated=deduplicated, verified=req.verified, verify_us=req.verify_us,
            spans_us=dict(req.trace.spans_us), counters=dict(req.trace.counters),
        )

    # -- batch entry ----------------------------------------------------------

    def submit_batch(
        self,
        queries: Sequence[JoinQuery],
        lam: Optional[int] = None,
        materialize: bool = True,
        fuse_semijoin: Optional[bool] = None,
    ) -> List[SessionResult]:
        """Answer a batch of queries serially, sharing per-table work: queries
        binding the same physical ``Relation.table`` compute the histogram's
        per-(table, column) unique-count pass once on the dataplane, and on
        the simulator install the first query's seeded scatter placement into
        every later query's simulator (bit-identical to re-scattering).
        Results are identical to one :meth:`submit` per query, in order (for
        one coalesced scheduler pass over the set, see
        :meth:`submit_coalesced`)."""
        batch: Dict = {"scatter": {}, "unique": {}, "digest": {}}
        return [
            self.submit(q, lam=lam, materialize=materialize, fuse_semijoin=fuse_semijoin,
                        _batch=batch)
            for q in queries
        ]

    # -- pattern entry (subgraph enumeration) ---------------------------------

    def submit_pattern(
        self,
        pattern,
        graph,
        lam: Optional[int] = None,
        orientation: str = "degree",
        fuse_semijoin: Optional[bool] = None,
    ):
        """Enumerate ``pattern`` in ``graph`` through this session.

        The session-backed twin of
        :func:`repro_torch.graph.enumerate.enumerate_subgraphs`: the pattern
        is compiled to a shared-table :class:`JoinQuery`, submitted (hitting
        the plan cache when the graph's histogram signature is unchanged),
        and post-processed into exactly-once occurrences.

        Returns: a :class:`repro_torch.graph.enumerate.EnumerationResult`.
        """
        from ..graph.enumerate import enumerate_subgraphs

        return enumerate_subgraphs(
            graph, pattern, p=self.p, lam=lam, orientation=orientation,
            fuse_semijoin=self.fuse_semijoin if fuse_semijoin is None else fuse_semijoin,
            session=self,
        )

    # -- cache control --------------------------------------------------------

    def clear_plans(self) -> None:
        """Drop every cached compiled program (executor state is kept)."""
        self._plans.clear()
        self.stats.cached_plans = 0

    @property
    def cached_plan_keys(self) -> List[Tuple]:
        """Plan-LRU keys, oldest first."""
        return list(self._plans.keys())
