"""Executor rounds and data plane, over the window's warm queries: the share
of the bytes pulled to the host that are valid result rows (the
``d2h_row_bytes`` counters over the ``d2h_bytes``); the rest is capacity
padding, counts and overflow flags."""

from portbench.program_spans import counter_sums


def read(record):
    rows, pulled = counter_sums(record, "d2h_row_bytes"), counter_sums(record, "d2h_bytes")
    if rows is None or not pulled or not sum(pulled):
        return None
    return 100.0 * sum(rows) / sum(pulled)
