"""Executor layer, per warm query of the window: host staging outside the
rounds (``blockify`` and ``unblockify``, the general route's key columns and
sweep keys, packing radices, the rounds' work items), every ``*/stage``
span."""

from portbench.program_spans import span_ms


def read(record):
    return span_ms(record, lambda path: path.endswith("/stage"))
