"""ShareRoute, per warm query of the window: the valid copies the route
delivered over the relations' rows before replication, the
``execute/op.ShareRoute:routed_rows`` and ``:input_rows`` counters; the
general route only (1 where no relation is replicated)."""

from portbench.program_spans import counter_sums


def read(record):
    routed, rows = counter_sums(record, "routed_rows"), counter_sums(record, "input_rows")
    if routed is None or rows is None:
        return None
    return sum(r / n for r, n in zip(routed, rows) if n) / len(rows)
