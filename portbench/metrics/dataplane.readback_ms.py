"""Executor rounds and data plane, per warm query of the window: each round's
deferred pull of its buckets' overflow and results to the host (where the
card's work surfaces on the host clock), every ``*/readback`` span."""

from portbench.program_spans import span_ms


def read(record):
    return span_ms(record, lambda path: path.endswith("/readback"))
