#!/usr/bin/env python3
"""The program's own spans and copy counters in a traced run of a cell.

The port names its host work itself (``repro_torch.spans``): every submit's
``SessionResult`` carries ``spans_us`` (inclusive µs by span path) and
``counters`` (``h2d_bytes``, ``d2h_bytes``, ``d2h_row_bytes`` by
``<span path>:<name>``), and under ``torch.profiler`` each span is a
``repro_torch.<path>`` event.  ``run.py`` records neither yet, so this file
holds what reads them, beside the benchmark's own reduction:

* ``submit_record(res)``: ``run.submit_record`` plus ``spans_us`` and
  ``counters`` (empty where the program keeps none);
* ``profile_events(prof)``: ``trace.profile_events`` plus the program's
  ``repro_torch.*`` host events as spans named by their path;
* ``split_idle``: each idle gap of the card split over the spans that cover
  it, each piece to its innermost span (``reduce_events`` gives a whole gap
  to the span at its midpoint);
* ``span_ms`` / ``counter_mib``: per warm query of the window, for the
  readers ``metrics/executor.{fingerprint,residual,staging,assemble}_ms`` and
  ``metrics/dataplane.{readback_ms,h2d_mib,d2h_mib,d2h_useful_pct}``.

    python3 portbench/program_spans.py --workload <cell> --seed <n> --seconds <s> [--record 0]

runs one traced run of the cell (``run.run_cell``, ``--trace 1``) with the
two records above and prints one JSON object: the run's line, the readers'
values, the host work they cover, the self time of every span, the copy
bytes of each query of the mix at each window repeat, and both idle
splits.  ``--record 0`` keeps the program's spans off the profiler's
timeline, to price them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = "repro_torch."
#: span names whose own time counts as unattributed host work
COARSE = ("submit", "window", "execute")
#: the readers of the program's records (``metrics/<name>.py``)
READERS = ("executor.fingerprint_ms", "executor.residual_ms", "executor.staging_ms",
           "executor.assemble_ms", "dataplane.readback_ms", "dataplane.h2d_mib",
           "dataplane.d2h_mib", "dataplane.d2h_useful_pct")


def submit_record(res, base) -> dict:
    """``base(res)`` (``run.submit_record``) with the program's spans and
    counters."""
    return {**base(res), "spans_us": dict(getattr(res, "spans_us", None) or {}),
            "counters": dict(getattr(res, "counters", None) or {})}


def profile_events(prof, base):
    """``base(prof)`` (``trace.profile_events``) with the program's
    ``repro_torch.*`` host events added to the spans, named by their path
    (the per-request events ``repro_torch.request:<ids>`` left out)."""
    from torch.autograd import DeviceType

    device, spans, window = base(prof)
    for e in prof.events():
        name = e.name
        if (e.device_type != DeviceType.CUDA and name.startswith(PROGRAM)
                and not name.startswith(PROGRAM + "request:")):
            spans.append((name[len(PROGRAM):], e.time_range.start, e.time_range.end))
    return device, spans, window


def _gaps(device, window):
    w0, w1 = window
    busy = sorted((max(s, w0), min(e, w1)) for _, s, e in device if e > w0 and s < w1)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    return gaps


def split_idle(device, spans, window, top: int = 10):
    """``device``, ``spans``: [(name, start_us, end_us)]; ``window``: (start,
    end).  → [(span, idle µs)], the ``top`` largest: every stretch of the
    window with no device operation, cut at every span boundary inside it,
    each piece given to the shortest span that holds it ("window" if
    none)."""
    points = []
    for i, (_, s, e) in enumerate(spans):
        points += [(s, 1, i), (e, -1, i)]
    for s, e in _gaps(device, window):
        points += [(s, 2, None), (e, -2, None)]
    points.sort(key=lambda x: x[0])
    active, idle, in_gap, t_prev = set(), defaultdict(float), 0, None
    for t, kind, i in points:
        if in_gap and t_prev is not None and t > t_prev:
            inner = min(active, key=lambda j: spans[j][2] - spans[j][1], default=None)
            idle["window" if inner is None else spans[inner][0]] += t - t_prev
        if kind == 1:
            active.add(i)
        elif kind == -1:
            active.discard(i)
        else:
            in_gap += kind // 2
        t_prev = t
    return sorted(idle.items(), key=lambda kv: -kv[1])[:top]


def coarse(name: str) -> bool:
    """A span whose own time names no host work: the window, a submit, an
    execution or an op lowering as a whole."""
    leaf = name.rsplit("/", 1)[-1]
    return leaf in COARSE or leaf.startswith("op.")


def span_ms(record, match):
    """Mean over the window's warm submits of the summed µs of the span
    paths ``match`` accepts, in ms; None where no submit has such a span."""
    warm = [s.get("spans_us") or {} for s in record["warm"]]
    if not any(match(k) for sp in warm for k in sp):
        return None
    return sum(v for sp in warm for k, v in sp.items() if match(k)) / len(warm) / 1e3


def counter_sums(record, name):
    """Each warm submit's summed ``name`` counter; None where none has one."""
    warm = [s.get("counters") or {} for s in record["warm"]]
    if not any(k.rsplit(":", 1)[-1] == name for c in warm for k in c):
        return None
    return [sum(v for k, v in c.items() if k.rsplit(":", 1)[-1] == name) for c in warm]


def counter_mib(record, name):
    """Mean over the window's warm submits of the ``name`` counter, in MiB."""
    sums = counter_sums(record, name)
    return None if sums is None else sum(sums) / len(sums) / 2**20


def self_us(spans_us: dict) -> dict:
    """Each span path's µs less its child spans' (a round's self time is its
    scheduling and retry bookkeeping, an op's its lowering's Python)."""
    own = dict(spans_us)
    for path, us in spans_us.items():
        if "/" in path:
            parent = path.rsplit("/", 1)[0]
            if parent in own:
                own[parent] -= us
    return own


def summarize(record, device_events, per_query: int, readers) -> dict:
    """What a traced run with the program's records shows: the readers'
    values, the host work they cover, mean self time per span, copy bytes
    of each query of the mix at each window repeat, and the idle splits."""
    from portbench.trace import reduce_events

    warm = record["warm"]
    values = {name: readers[name](record) for name in READERS}
    named = [values.get(k) or 0.0 for k in ("executor.fingerprint_ms", "executor.residual_ms",
                                             "executor.staging_ms", "executor.assemble_ms")]
    host = readers["executor.host_ms"](record)
    selfs = defaultdict(float)
    for s in warm:
        for path, us in self_us(s.get("spans_us") or {}).items():
            selfs[path] += us / len(warm) / 1e3
    copies = defaultdict(list)
    for k, s in enumerate(warm):
        c = s.get("counters") or {}
        copies[k % per_query].append([sum(v for key, v in c.items() if key.endswith(":" + n))
                                      for n in ("h2d_bytes", "d2h_bytes", "d2h_row_bytes")])
    out = {"metrics": values, "host_ms": host,
           "named_share_of_host": sum(named) / host if host else None,
           "self_ms": dict(sorted(selfs.items(), key=lambda kv: -kv[1])),
           "copies_by_query": {q: v for q, v in sorted(copies.items())},
           "copies_repeat": all(all(x == v[0] for x in v) for v in copies.values())}
    if device_events is not None:
        device, spans, window = device_events
        exact = split_idle(device, spans, window, top=len(spans) + 1)
        idle = sum(us for _, us in exact)
        out["idle_midpoint_s"] = [[n, us / 1e6] for n, us in
                                  reduce_events(device, spans, window)["idle_by_span"]]
        out["idle_exact_s"] = [[n, us / 1e6] for n, us in exact[:20]]
        out["idle_s"] = idle / 1e6
        out["idle_coarse_share"] = (sum(us for n, us in exact if coarse(n)) / idle
                                    if idle else None)
    return out


def traced_run(root: Path, cell: str, seed: int, seconds: float, device: str = "cuda",
               overrides=None, t_start=None) -> dict:
    """One ``--trace 1`` run of ``cell`` (``run.run_cell``) with the
    program's spans and counters recorded → its line and ``summarize``."""
    import torch

    from portbench import run, trace

    warm, events, n_program = [], [], []
    base_record, base_events = run.submit_record, trace.profile_events

    def record(res):
        rec = submit_record(res, base_record)
        if torch.autograd._profiler_enabled():     # the traced window's submits
            warm.append(rec)
        return rec

    def reduce(prof):
        base = base_events(prof)
        n_base = len(base[1])
        events.append(profile_events(prof, lambda _: base))
        n_program.append(len(events[-1][1]) - n_base)
        return events[-1]

    run.submit_record, trace.profile_events = record, reduce
    try:
        line = run.run_cell(root, cell, seed, seconds, True, device=device,
                            overrides=overrides, t_start=t_start)
    finally:
        run.submit_record, trace.profile_events = base_record, base_events
    _, _, _, traffic = run.load_cell(root, cell, overrides)
    readers = {name: run.load_module(root / "portbench" / "metrics" / f"{name}.py").read
               for name in READERS + ("executor.host_ms",)}
    out = summarize({"warm": warm, "cold": []}, events[0] if events else None,
                    traffic["variants"], readers)
    if n_program:
        out["program_events_per_query"] = n_program[0] / max(1, len(warm))
    return {"line": line, **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    if not torch.cuda.is_available():
        print("portbench: program_spans needs a CUDA device", file=sys.stderr)
        return 2
    if not args.record:
        from repro_torch import spans

        spans._record = lambda name: None
    out = traced_run(ROOT, args.workload, args.seed, args.seconds, t_start=t_start)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "record": args.record,
                      **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
