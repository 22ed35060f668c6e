"""ShareRoute's counters (``execute/op.ShareRoute:{input_rows, routed_rows,
grid_cells, live_cells}``) on hand-built queries with known shares, on the
CPU: a triangle forced onto the general route at p = 8 has the LP shares
A 2, B 2, C 2, so each relation's rows go to the 2 cells of the dimension
it lacks, and a cell can emit only where all three relations meet."""

import numpy as np
import pytest
import torch

from repro_torch.core.query import query_from_arrays
from repro_torch.mpc import JoinSession

torch.set_num_threads(1)

KEYS = ("input_rows", "routed_rows", "grid_cells", "live_cells")


def triangle(r, s, t):
    return query_from_arrays([(("A", "B"), np.asarray(r), None), (("B", "C"), np.asarray(s), None),
                              (("A", "C"), np.asarray(t), None)], force_general=True)


def route_counters(session, q):
    res = session.submit(q)
    prog = session._plans[res.plan_key]
    assert prog.general.kind == "hypercube"
    assert prog.general.shares_dict == {"A": 2, "B": 2, "C": 2}
    return res, {k: res.counters.get(f"execute/op.ShareRoute:{k}") for k in KEYS}


@pytest.fixture(scope="module")
def session():
    s = JoinSession(p=8, device="cpu")
    yield s
    s.close()


def test_one_triangle_meets_in_one_cell(session):
    """One row a relation: each goes to 2 of the 8 cells, and only the cell
    of the triangle's hashed (A, B, C) holds all three."""
    res, c = route_counters(session, triangle([[1, 2]], [[2, 3]], [[1, 3]]))
    assert res.count == 1
    assert c == {"input_rows": 3, "routed_rows": 6, "grid_cells": 8, "live_cells": 1}


def test_dense_relations_reach_every_cell(session):
    """Every pair over ten values: each relation covers both hash classes of
    both its attributes, so all 8 cells are live and every row is sent
    twice."""
    pairs = np.array([[a, b] for a in range(10) for b in range(10)])
    res, c = route_counters(session, triangle(pairs, pairs, pairs))
    assert res.count == 1000
    assert c == {"input_rows": 300, "routed_rows": 600, "grid_cells": 8, "live_cells": 8}


def test_live_cells_follow_where_the_rows_land(session):
    """T holds one row: only the 2 cells of its hashed (A, C) can be live,
    however many rows R and S send."""
    pairs = np.array([[a, b] for a in range(10) for b in range(10)])
    res, c = route_counters(session, triangle(pairs, pairs, [[4, 7]]))
    assert res.count == 10
    assert c == {"input_rows": 201, "routed_rows": 402, "grid_cells": 8, "live_cells": 2}


def test_the_counters_repeat_on_a_warm_resubmit(session):
    q = triangle([[1, 2], [2, 5]], [[2, 3], [5, 6]], [[1, 3], [2, 6]])
    _, first = route_counters(session, q)
    _, again = route_counters(session, q)
    assert first == again and first["routed_rows"] == 2 * first["input_rows"] == 12


def test_the_binary_route_keeps_no_share_route_counters(session):
    """The same triangle on the binary route (GridRoute) counts none of them."""
    q = query_from_arrays([(("A", "B"), np.array([[1, 2]]), None),
                           (("B", "C"), np.array([[2, 3]]), None),
                           (("A", "C"), np.array([[1, 3]]), None)])
    res = session.submit(q)
    assert res.count == 1
    assert not any(k.rsplit(":", 1)[-1] in KEYS for k in res.counters)
