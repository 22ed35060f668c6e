"""Executor layer, per warm query of the window: ``RouteResidual``'s carving of
each stage's residual relations (``residual_relations`` with its
``Relation.make`` dedup, the host pieces' uniques and intersections), the
span ``execute/op.RouteResidual/carve``; the binary route only."""

from portbench.program_spans import span_ms


def read(record):
    return span_ms(record, lambda path: path == "execute/op.RouteResidual/carve")
