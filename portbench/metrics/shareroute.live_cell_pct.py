"""ShareRoute, per warm query of the window: the share of the share grid's
cells that received a row of every relation, so the only cells that can
emit, in %, the ``execute/op.ShareRoute:live_cells`` and ``:grid_cells``
counters; the general route only."""

from portbench.program_spans import counter_sums


def read(record):
    live, cells = counter_sums(record, "live_cells"), counter_sums(record, "grid_cells")
    if live is None or cells is None:
        return None
    return 100.0 * sum(a / c for a, c in zip(live, cells) if c) / len(cells)
