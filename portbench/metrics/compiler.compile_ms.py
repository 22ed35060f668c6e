"""Compiler layer: ``compile_plan``'s time in each cold submit of the mix,
from ``SessionResult.compile_us`` (host clock); 0 would mean no plan was
compiled, so a run without cold compiles reports nothing."""


def read(record):
    cold = [s["compile_us"] for s in record["cold"] if s["compile_us"] > 0]
    if not cold:
        return None
    return sum(cold) / len(cold) / 1e3
