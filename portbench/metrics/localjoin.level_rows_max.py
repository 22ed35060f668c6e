"""LocalJoin chain, per warm query of the window: the most valid rows one
chain level held on the card at once (a slice's, where the level was sliced
over its machines), the ``execute/op.LocalJoin:level_rows_max`` counter; the
binary route only."""

from portbench.program_spans import counter_sums


def read(record):
    sums = counter_sums(record, "level_rows_max")
    return None if sums is None else sum(sums) / len(sums)
