#!/usr/bin/env python3
"""The control of ``correct``: a run of a cell with the program's answers
replaced by the plain reference computed with its keys held in a narrower
integer (int16 for the configurations' int32 device words: values wrap, as a
narrowed key column would).  The comparison has to find it wrong.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 5

runs the whole harness (inputs, set-up, window, comparison) once per seed
and prints each run's line; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def _answer(rows, us):
    """What the harness reads of a ``SessionResult``."""
    return SimpleNamespace(result=SimpleNamespace(rows=rows, round_us={}), count=len(rows),
                           total_us=us, execute_us=us, stats_us=0.0, compile_us=0.0,
                           verify_us=0.0, retries=0, plan_cache_hit=False)


class NarrowKeys:
    """Within the ``with`` block every ``JoinSession.submit`` answers with
    ``reference.join`` at ``dtype`` instead of running the program."""

    def __init__(self, reference, device, dtype):
        self.reference, self.device, self.dtype = reference, device, dtype

    def __enter__(self):
        from repro_torch.mpc import service

        self._orig = service.JoinSession.submit
        ref, dev, dtype = self.reference, self.device, self.dtype

        def submit(session, query, **kwargs):
            t0 = time.perf_counter()
            rels = [(r.scheme, r.data) for r in query.relations]
            _, rows = ref.join(rels, dev, dtype=dtype)
            return _answer(rows.cpu().numpy(), (time.perf_counter() - t0) * 1e6)

        service.JoinSession.submit = submit
        return self

    def __exit__(self, *exc):
        from repro_torch.mpc import service

        service.JoinSession.submit = self._orig
        return False


def control_run(root: Path, cell: str, seed: int, seconds: float, device: str = "cuda",
                overrides=None, dtype=None) -> dict:
    import torch

    from portbench.run import load_module, run_cell

    reference = load_module(root / "portbench" / "reference" / "natural_join.py")
    with NarrowKeys(reference, torch.device(device), dtype or torch.int16):
        return run_cell(root, cell, seed, seconds, False, device=device, overrides=overrides)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for seed in (int(s) for s in args.seeds.split(",")):
        line = control_run(ROOT, args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"], "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
