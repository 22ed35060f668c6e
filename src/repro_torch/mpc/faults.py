"""Typed errors of the join service.

Every failure a :class:`~repro_torch.mpc.service.JoinSession` surfaces is a
:class:`JoinServiceError` that names the query it belongs to and chains the
original traceback (``__cause__`` is always the root failure).  Deterministic
fault injection is not part of this package yet.
"""

from __future__ import annotations

from typing import Optional, Tuple


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
