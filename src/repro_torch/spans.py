"""Named host spans and copy counters of the join service's requests.

``span(name)`` times a stretch of host work on ``time.perf_counter_ns`` and
nests per thread: a span opened inside another gets the path
``<outer path>/<name>`` (``execute/op.TreeSemiJoin/stage``).  On exit it adds
its inclusive µs, under its path, to every :class:`Trace` active on the
thread, and keeps them on its own ``us`` for the caller.  While a
``torch.profiler`` records, it also opens
``torch.profiler.record_function("repro_torch.<path>")``, so the spans sit
on the timeline the card's kernels and copies are traced on, each inside a
``repro_torch.request:<ids>`` event that :func:`activate` opens with the
request ids of the traces it activates (a coalesced execution names all of
its members).  The profiler keeps no ``record_function`` argument without
``record_shapes``, so the ids travel in that event's name.

``count(name, n)`` adds ``n`` to every active trace under
``<innermost open span's path>:<name>`` (``<name>`` outside every span).

:class:`~repro_torch.mpc.service.JoinSession` activates one trace per
request (:func:`activate`) and hands its totals back on
``SessionResult.spans_us`` and ``SessionResult.counters``.  Outside an
activated trace a span still times itself and a count does nothing.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import torch

#: prefix of the spans' names on the profiler's timeline
PREFIX = "repro_torch."


class Trace:
    """One request's totals: inclusive µs by span path (``spans_us``) and
    counters by ``<span path>:<name>`` (``counters``)."""

    __slots__ = ("rid", "spans_us", "counters")

    def __init__(self, rid):
        self.rid = str(rid)
        self.spans_us = defaultdict(float)
        self.counters = defaultdict(int)


class _Thread(threading.local):
    def __init__(self):
        self.path = ""        # the innermost open span's path
        self.traces = ()      # the traces the thread's spans add to


_local = _Thread()


def _record(name: str):
    """An entered ``record_function`` while a profiler records, else None."""
    if not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(PREFIX + name)
    rf.__enter__()
    return rf


class activate:
    """``with activate(*traces):`` the thread's spans and counts add to
    ``traces``, with paths rooted afresh; the previous state comes back on
    exit."""

    __slots__ = ("traces", "_saved", "_rf")

    def __init__(self, *traces: Trace):
        self.traces = traces

    def __enter__(self):
        self._saved = (_local.path, _local.traces)
        _local.path, _local.traces = "", self.traces
        self._rf = _record("request:" + ",".join(t.rid for t in self.traces))
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _local.path, _local.traces = self._saved
        return False


class span:
    """``with span(name) as s:`` times the block; ``s.us`` holds its
    inclusive µs after the block, and ``s.path`` its path."""

    __slots__ = ("name", "path", "us", "_parent", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.us = 0.0

    def __enter__(self):
        self._parent = parent = _local.path
        self.path = path = f"{parent}/{self.name}" if parent else self.name
        _local.path = path
        self._rf = _record(path)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.us = (time.perf_counter_ns() - self._t0) / 1e3
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _local.path = self._parent
        for t in _local.traces:
            t.spans_us[self.path] += self.us
        return False


def count(name: str, n: int) -> None:
    """Add ``n`` to ``<innermost open span's path>:<name>`` in every active
    trace (``<name>`` outside every span)."""
    traces = _local.traces
    if traces:
        key = f"{_local.path}:{name}" if _local.path else name
        for t in traces:
            t.counters[key] += int(n)
