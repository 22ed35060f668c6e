"""Executor layer, per warm query of the window: row assembly, the tails of
``LocalJoin`` and ``CellJoin`` (``unblockify``, the η columns, the column
order) and ``run_many``'s concatenation of each program's rows, every
``*/assemble`` span."""

from portbench.program_spans import span_ms


def read(record):
    return span_ms(record, lambda path: path.endswith("/assemble"))
