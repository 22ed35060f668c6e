"""Executor rounds and data plane, per warm query of the window: the tensors
pulled to the host (``to_host``: results, counts, overflow flags), the
``d2h_bytes`` counters, in MiB."""

from portbench.program_spans import counter_mib


def read(record):
    return counter_mib(record, "d2h_bytes")
