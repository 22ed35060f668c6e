"""Small CPU versions of the benchmark's cells, for the tests: the same
harness, traffic and reference at sizes a test run holds (p = 8)."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SMALL_SSB = {"fact_rows": 20000, "customers": 3000, "suppliers": 200, "parts": 70000,
             "machines": 8}
SMALL = {"graph500-s17.triangle": {"scale": 11, "machines": 8},
         "ssb-sf1.flat": SMALL_SSB,
         "ssb-sf1.q41-mix": SMALL_SSB}
SECONDS = 0.2


def run_small(cell, seed=2**31 + 11, trace=False):
    from portbench.run import run_cell

    return run_cell(ROOT, cell, seed, SECONDS, trace, device="cpu", overrides=SMALL[cell])
