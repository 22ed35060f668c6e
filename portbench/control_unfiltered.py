#!/usr/bin/env python3
"""A control of ``correct`` that breaks the exact guarantee: a run of a graph
cell with the program's answers replaced by the plain reference over the
query without its last closing filter, the last relation whose every
attribute another relation also binds (W(B,D) of the 4-clique, T(A,C) of the
triangle).  The answer keeps the query's columns but also holds candidate
rows the dropped relation rules out, as a chain that skipped a filter would;
the comparison has to find it wrong.  Keys keep the reference's own int64,
so this control does not rest on a key width the graph may never reach.

    python3 portbench/control_unfiltered.py --workload <cell> --seeds 11,12,13 --seconds 5

runs the whole harness (inputs, set-up, window, comparison) once per seed
and prints each run's line; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def unfiltered(relations: list) -> list:
    """``relations`` [(scheme, rows)] without the last relation whose
    attributes all appear in the others."""
    for i in reversed(range(len(relations))):
        others = {a for j, (scheme, _) in enumerate(relations) if j != i for a in scheme}
        if set(relations[i][0]) <= others:
            return relations[:i] + relations[i + 1:]
    raise ValueError("the query has no closing filter to drop")


class _Unfiltered:
    """The reference, joining the query without its last closing filter."""

    def __init__(self, reference):
        self.reference = reference

    def join(self, relations, device, dtype=None):
        return self.reference.join(unfiltered(relations), device, dtype=dtype)


def control_run(root: Path, cell: str, seed: int, seconds: float, device: str = "cuda",
                overrides=None) -> dict:
    import torch

    from portbench.control import NarrowKeys
    from portbench.run import load_module, run_cell

    reference = load_module(root / "portbench" / "reference" / "natural_join.py")
    # int64 is the reference's own key width: nothing is narrowed
    with NarrowKeys(_Unfiltered(reference), torch.device(device), torch.int64):
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
                          "attempted": line["attempted"], "checks": line["checks"],
                          "device": line["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
