"""What the traced run (``--trace 1``) records, and its reduction.

The benchmark installs, for the traced window only:

* a wrapper around each join kernel op (``kernel_bytes.DEVICE_KERNELS``) in
  every program module that imported it, which adds the bytes the call must
  move (``kernel_bytes``) to that op's total;
* ``torch.profiler.record_function`` spans, named ``portbench.*``, around the
  window, each submit, and the service's calls into the statistics pass
  (``compute_stats``), the compiler (``compile_plan``), the executor
  (``run_many``) and each of the executor's op lowerings.

``profile_events`` and ``reduce_events`` turn the profiler's events into the device's busy time,
each join kernel's device time, the longest device operations and the idle
time by the innermost span the host was in.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from contextlib import contextmanager

from . import kernel_bytes

SPAN = "portbench."


class KernelBytes:
    """Wraps the join kernel ops wherever the program imported them and sums
    the bytes each call must move; device-side counts stay on the device
    until ``totals``."""

    def __init__(self):
        self.bytes = defaultdict(int)
        self.calls = defaultdict(int)
        self._restore = []

    def install(self):
        from repro_torch.kernels import ops

        for name in kernel_bytes.DEVICE_KERNELS:
            orig = getattr(ops, name)
            need = getattr(kernel_bytes, name)

            def wrapped(*args, _orig=orig, _need=need, _name=name, **kwargs):
                out = _orig(*args, **kwargs)
                self.bytes[_name] = self.bytes[_name] + _need(*args, **kwargs, out=out)
                self.calls[_name] += 1
                return out

            for mod in list(sys.modules.values()):
                if (getattr(mod, "__name__", "").startswith("repro_torch")
                        and getattr(mod, name, None) is orig):
                    setattr(mod, name, wrapped)
                    self._restore.append((mod, name, orig))

    def remove(self):
        for mod, name, orig in reversed(self._restore):
            setattr(mod, name, orig)
        self._restore = []

    def totals(self) -> dict:
        return {name: {"calls": self.calls[name], "bytes": int(self.bytes[name])}
                for name in kernel_bytes.DEVICE_KERNELS if self.calls[name]}


class Spans:
    """``portbench.*`` spans around the service's calls into each layer."""

    def __init__(self, session):
        self.session = session
        self._restore = []

    def _wrap(self, owner, attr, span):
        import torch

        orig = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(SPAN + span):
                return orig(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._restore.append((owner, attr, orig))

    def install(self):
        from repro_torch.mpc import service

        self._wrap(service, "compute_stats", "stats")
        self._wrap(service, "compile_plan", "compile")
        ex = self.session.executor
        self._wrap(ex, "run_many", "execute")
        for op, rule in type(ex)._LOWERING.items():
            self._wrap(ex, rule, "op." + op.__name__)

    def remove(self):
        for owner, attr, orig in reversed(self._restore):
            if owner is self.session.executor:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)
        self._restore = []


@contextmanager
def span(name: str):
    import torch

    with torch.profiler.record_function(SPAN + name):
        yield


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans, t):
    """Name of the shortest span that holds time ``t`` ("" if none)."""
    best, best_len = "", None
    for name, s, e in spans:
        if s <= t <= e and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best


def reduce_events(device, spans, window, top: int = 10) -> dict:
    """``device``: [(name, start_us, end_us)] of the card's operations;
    ``spans``: [(name, start_us, end_us)] of the ``portbench.*`` spans;
    ``window``: (start_us, end_us).  → busy and window µs, device µs per join
    kernel op, the ``top`` longest device operations by summed time, and the
    idle µs by innermost span."""
    w0, w1 = window
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    merged = _merge([(s, e) for _, s, e in inside])
    busy = sum(e - s for s, e in merged)
    kernel_us = defaultdict(float)
    by_name = defaultdict(float)
    for n, s, e in inside:
        by_name[n] += e - s
        for op, pattern in kernel_bytes.DEVICE_KERNELS.items():
            if pattern.search(n):
                kernel_us[op] += e - s
    # idle gaps: the stretches of the window no device operation covers
    gaps, t = [], w0
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    ordered = sorted(spans, key=lambda x: x[1])
    begins = [x[1] for x in ordered]
    idle = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) / 2
        held = ordered[:bisect.bisect_right(begins, mid)]
        idle[_innermost(held, mid) or "window"] += e - s
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_us": busy, "window_us": w1 - w0, "kernel_us": dict(kernel_us),
            "device_ops": rank(by_name), "idle_by_span": rank(idle)}


def profile_events(prof):
    """(device operations, portbench spans, window) from a finished
    ``torch.profiler.profile``, times in µs on the profiler's clock."""
    from torch.autograd import DeviceType

    device, spans, window = [], [], None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        # a span also shows on the device's timeline (a user annotation
        # stretched over the work launched inside it): not device work
        annotation = getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN)
        if e.device_type == DeviceType.CUDA:
            if not annotation:
                device.append((e.name, s, t))
        elif e.name.startswith(SPAN):
            if e.name == SPAN + "window":
                window = (s, t)
            else:
                spans.append((e.name[len(SPAN):], s, t))
    if window is None:
        raise RuntimeError("the profiler recorded no portbench.window span")
    return device, spans, window
