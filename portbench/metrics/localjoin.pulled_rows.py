"""LocalJoin chain, per warm query of the window: the rows the chain pulled
to the host (the answer's rows, once its last level is done), the
``execute/op.LocalJoin/assemble:pulled_rows`` counter; the binary route
only."""

from portbench.program_spans import counter_sums


def read(record):
    sums = counter_sums(record, "pulled_rows")
    return None if sums is None else sum(sums) / len(sums)
