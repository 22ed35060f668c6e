"""Executor rounds and data plane, per warm query of the window: the host
arrays the data plane sends to the device (``to_dev``), the ``h2d_bytes``
counters, in MiB."""

from portbench.program_spans import counter_mib


def read(record):
    return counter_mib(record, "h2d_bytes")
