"""The plain reference join and the multiset comparison that decide ``correct``."""

import itertools

import numpy as np
import pytest
import torch

from portbench import compare
from portbench.reference import natural_join


def brute_join(relations):
    """Nested loops over every combination of one row per relation."""
    attrs = sorted({a for scheme, _ in relations for a in scheme})
    sets = [(scheme, {tuple(r) for r in np.asarray(rows).tolist()}) for scheme, rows in relations]
    out = set()
    for combo in itertools.product(*[sorted(s) for _, s in sets]):
        val = {}
        if all(val.setdefault(a, v) == v for (scheme, _), row in zip(sets, combo)
               for a, v in zip(scheme, row)):
            out.add(tuple(val[a] for a in attrs))
    return attrs, sorted(out)


def triangle(rng, n, dom):
    e = rng.integers(0, dom, (n, 2))
    return [(("A", "B"), e), (("B", "C"), e), (("A", "C"), e)]


def star(rng, n, dom, q41=False):
    fact = rng.integers(1, dom + 1, (n, 3))
    dims = []
    for attr in ("A1", "B1", "C1"):
        keys = np.arange(1, dom + 1)
        vals = rng.integers(0, 4, dom)
        keep = vals < 2 if q41 else np.ones(dom, bool)
        dims.append(np.stack([keys[keep], vals[keep]], axis=1))
    return [(("A", "B", "C"), fact), (("A", "A1"), dims[0]), (("B", "B1"), dims[1]),
            (("C", "C1"), dims[2])]


def star4(rng, n, dom):
    """A 4-ary fact with four dimensions, one of them keyed apart from the others."""
    fact = np.concatenate([rng.integers(1, dom + 1, (n, 3)), rng.integers(100, 100 + dom, (n, 1))],
                          axis=1)
    rels = [(("A", "B", "C", "D"), fact)]
    for attr, lo in (("A", 1), ("B", 1), ("C", 1), ("D", 100)):
        keys = np.arange(lo, lo + dom)
        keep = rng.random(dom) < 0.7
        rels.append(((attr, attr + "1"), np.stack([keys[keep], rng.integers(0, 3, dom)[keep]],
                                                  axis=1)))
    return rels


@pytest.mark.parametrize("make", [
    lambda rng: triangle(rng, 40, 9),
    lambda rng: triangle(rng, 60, 6),                # dense: repeated rows and self-loops
    lambda rng: star(rng, 30, 5),
    lambda rng: star(rng, 30, 5, q41=True),          # dimensions that drop keys
    lambda rng: star4(rng, 25, 4),                   # the SSB shape: 4-ary fact, 4 dimensions
    lambda rng: [(("A", "B"), rng.integers(0, 5, (8, 2))), (("C",), rng.integers(0, 3, (3, 1)))],
    lambda rng: [(("A", "B"), rng.integers(-3, 3, (12, 2))), (("B", "C"), rng.integers(-3, 3, (12, 2))),
                 (("C", "D"), rng.integers(-3, 3, (12, 2)))],
])
@pytest.mark.parametrize("block_rows", [1, 5, 1 << 20])
def test_reference_equals_brute_force(make, block_rows):
    relations = make(np.random.default_rng(3))
    want_attrs, want = brute_join(relations)
    attrs, rows = natural_join.join(relations, "cpu", block_rows=block_rows)
    assert attrs == want_attrs
    assert sorted(map(tuple, rows.tolist())) == want


def test_narrow_keys_wrap():
    """The control's int16 keys alias values 2^16 apart."""
    rel = [(("A", "B"), np.array([[1, 70000], [2, 4464]])), (("B", "C"), np.array([[4464, 9]]))]
    _, wide = natural_join.join(rel, "cpu")
    _, narrow = natural_join.join(rel, "cpu", dtype=torch.int16)
    assert wide.tolist() == [[2, 4464, 9]]
    assert sorted(narrow.tolist()) == [[1, 4464, 9], [2, 4464, 9]]


@pytest.mark.parametrize("got, want, gap", [
    ([[1, 2], [3, 4]], [[3, 4], [1, 2]], 0),          # order is not part of the answer
    ([[1, 2], [3, 4]], [[1, 2], [3, 5]], 2),          # one altered row
    ([[1, 2]], [[1, 2], [3, 4]], 1),                  # a missing row
    ([[1, 2], [1, 2]], [[1, 2]], 1),                  # a repeated row
    ([], [[1, 2]], 1),
    ([[1, 2, 3]], [[1, 2]], 2),                       # another width
    ([[0, -(1 << 62)], [1, 1 << 62]], [[1, 1 << 62], [0, -(1 << 62)]], 0),  # past 2^62
])
def test_rows_gap(got, want, gap):
    t = lambda r: torch.tensor(r, dtype=torch.int64).reshape(len(r), -1 if r else 2)
    assert compare.rows_gap(t(got), t(want)) == gap
