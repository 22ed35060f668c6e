"""Executor layer, per warm query of the window: ``run_many``'s content digest
of every bound input table (the learned-capacity store's key), the span
``execute/fingerprint``."""

from portbench.program_spans import span_ms


def read(record):
    return span_ms(record, lambda path: path == "execute/fingerprint")
