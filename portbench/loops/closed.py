"""Closed loop, one client: each query is submitted as soon as the previous
one returned its rows in host memory, the mix's queries in turn, until the
window's seconds have passed; the last query runs to its end.

``query_s`` is the window's wall time, from the first submit to the return of
the last, over the number of queries submitted."""

from __future__ import annotations

import sys
import time


def run(submit, n_queries: int, seconds: float, sync) -> dict:
    """``submit(i)`` answers query ``i`` of the mix (raising on failure);
    ``sync()`` waits for the card.  → answers [(i, result)], attempted,
    failed, the loop's end-to-end metrics and the window's bounds."""
    answers, failed, attempted, walls = [], 0, 0, []
    sync()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        i = attempted % n_queries
        attempted += 1
        t1 = time.perf_counter()
        try:
            answers.append((i, submit(i)))
        except Exception as e:       # counted against the run, which goes on
            failed += 1
            print(f"portbench: query {i} failed: {type(e).__name__}: {e}", file=sys.stderr,
                  flush=True)
        t2 = time.perf_counter()
        walls.append(t2 - t1)
        if t2 >= deadline:
            break
    sync()
    wall = time.perf_counter() - t0
    print("portbench: window query walls (s): " + " ".join(f"{w:.3f}" for w in walls),
          file=sys.stderr, flush=True)
    return {"answers": answers, "attempted": attempted, "failed": failed,
            "metrics": {"query_s": wall / attempted}, "window_s": wall}
