"""The service's statistics memo and table digests on the CPU.

* a memo hit hands back what a fresh ``compute_stats`` gives, field by
  field, on the binary route (a triangle with heavy values, so ``cond`` and
  ``pair`` are filled) and the general route (a 4-ary star), and nothing
  downstream writes to the shared histogram;
* ``stats:memo_hits`` / ``stats:memo_misses`` read 0/1 cold, 1/0 warm, 0/1
  again for another λ, and the memo is LRU-bounded by ``plan_cache_size``;
* a table written in place between two submits misses the memo, gets the
  statistics its new rows have, and answers as a fresh session does;
* a self-join hashes its one table once per submit and once per coalesced
  batch, and the program fingerprint follows every byte of the content.
"""

import copy

import numpy as np
import pytest
import torch

import repro_torch.core.query as query_mod
from repro_torch.core.query import (
    JoinQuery,
    Relation,
    query_from_arrays,
    relation_digests,
    table_digest,
)
from repro_torch.core.taxonomy import compute_stats
from repro_torch.mpc import JoinSession
from repro_torch.mpc.executors import DataplaneExecutor
from repro_torch.mpc.program import compile_plan

torch.set_num_threads(1)


def heavy_triangle(seed=0, n=300, v=40, planted=80):
    """A triangle over one shared edge table with two planted hubs: 100 on
    the first column and 101 on the second, joined by the edge (100, 101),
    so at λ = 24 both are heavy and R(A,B) holds a heavy-heavy pair."""
    rng = np.random.default_rng(seed)
    e = np.concatenate([rng.integers(0, v, (n, 2)),
                        np.stack([np.full(planted, 100), np.arange(planted)], axis=1),
                        np.stack([np.arange(planted), np.full(planted, 101)], axis=1),
                        [[100, 101]]])
    return query_from_arrays([(("A", "B"), e, "E"), (("B", "C"), e, "E"), (("A", "C"), e, "E")])


def star_query(seed=2, n=500):
    """SSB's shape: a 4-ary fact table joined to three keyed dimensions."""
    rng = np.random.default_rng(seed)
    fact = np.stack([rng.integers(0, 30, n), rng.integers(0, 20, n),
                     rng.integers(0, 40, n), rng.integers(0, 10, n)], axis=1)
    dim = lambda k, m: np.stack([np.arange(k), np.arange(k) % m], axis=1)  # noqa: E731
    return query_from_arrays([(("c", "s", "p", "d"), fact, "F"), (("c", "cn"), dim(30, 5), "C"),
                              (("s", "sn"), dim(20, 4), "S"), (("p", "pb"), dim(40, 7), "P")])


ROUTES = {"triangle": (heavy_triangle, 24), "star": (star_query, 16)}


def assert_stats_equal(a, b):
    assert (a.lam, a.m) == (b.lam, b.m)
    assert a.heavy.keys() == b.heavy.keys()
    for attr in a.heavy:
        assert a.heavy[attr].dtype == b.heavy[attr].dtype
        assert np.array_equal(a.heavy[attr], b.heavy[attr])
    assert a.cond == b.cond
    assert a.pair == b.pair
    assert a.light_cnt == b.light_cnt


def memo_counts(res):
    return res.counters["stats:memo_hits"], res.counters["stats:memo_misses"]


def assert_same_answer(a, b):
    assert a.rows.dtype == b.rows.dtype and np.array_equal(a.rows, b.rows)
    assert a.count == b.count and a.per_h_counts == b.per_h_counts
    assert a.retries == b.retries and a.retry_log == b.retry_log


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_memo_hit_equals_fresh_stats(route):
    make, lam = ROUTES[route]
    q = make()
    session = JoinSession(p=8, device="cpu")
    cold = session.submit(q, lam=lam)
    assert memo_counts(cold) == (0, 1)
    (shared,) = session._stats_memo.values()
    before = copy.deepcopy(shared)
    warm = session.submit(q, lam=lam)
    assert memo_counts(warm) == (1, 0)
    assert "stats/digest" in warm.spans_us
    assert_stats_equal(shared, compute_stats(q, lam))
    assert shared.heavy and shared.light_cnt
    if route == "triangle":
        assert shared.cond and shared.pair
    assert_same_answer(warm, cold)
    other = session.submit(q, lam=lam + 1)
    assert memo_counts(other) == (0, 1)
    assert len(session._stats_memo) == 2
    # the runs read the shared histogram and wrote nothing to it
    assert_stats_equal(shared, before)


def test_caller_supplied_stats_bypass_the_memo():
    q = heavy_triangle()
    session = JoinSession(p=8, device="cpu")
    res = session.submit(q, stats=compute_stats(q, 24))
    assert "stats:memo_hits" not in res.counters and "stats:memo_misses" not in res.counters
    assert not session._stats_memo
    assert_same_answer(res, JoinSession(p=8, device="cpu").submit(q, lam=24))


def test_memo_is_bounded_by_the_plan_cache_size():
    qs = [heavy_triangle(seed=s) for s in (0, 1)]
    session = JoinSession(p=8, device="cpu", plan_cache_size=1)
    got = [memo_counts(session.submit(qs[i % 2], lam=24)) for i in range(4)]
    assert got == [(0, 1)] * 4 and len(session._stats_memo) == 1
    session = JoinSession(p=8, device="cpu", plan_cache_size=2)
    got = [memo_counts(session.submit(qs[i % 2], lam=24)) for i in range(4)]
    assert got == [(0, 1), (0, 1), (1, 0), (1, 0)]


def edited_triangle(n=200, k=75):
    """A triangle over three tables of ``n`` rows each where A = 0 has
    ``k - 1`` rows in R(A,B), and R's row (1, 100) sorts right after them:
    writing its 1 to 0 keeps R sorted and unique and gives A = 0 ``k`` rows.
    Every other value has at most 40 rows in any relation."""
    i = np.arange(n - k)
    r = np.concatenate([np.stack([np.zeros(k - 1, int), np.arange(k - 1)], axis=1), [[1, 100]],
                        np.stack([2 + i // 40, i % 40], axis=1)])
    j = np.arange(n)
    s = np.stack([j, j % 7], axis=1)
    t = np.stack([j % 30, j // 30], axis=1)
    return query_from_arrays([(("A", "B"), r, "R"), (("B", "C"), s, "S"), (("A", "C"), t, "T")])


def test_table_written_in_place_misses_and_answers_as_a_fresh_session():
    lam = 8
    q = edited_triangle()
    assert q.m == 600 and -(-q.m // lam) == 75     # A = 0 is one row short of heavy
    r = q.relations[0].data
    (row,) = np.flatnonzero((r[:, 0] == 1) & (r[:, 1] == 100))
    session = JoinSession(p=8, device="cpu")
    first = session.submit(q, lam=lam)
    (stats,) = session._stats_memo.values()
    assert 0 not in stats.heavy.get("A", np.zeros(0, np.int64)).tolist()
    warm = session.submit(q, lam=lam)
    assert memo_counts(warm) == (1, 0)

    r[row, 0] = 0                                   # the write: A = 0 becomes heavy
    edited = session.submit(q, lam=lam)
    assert memo_counts(edited) == (0, 1)
    assert len(session._stats_memo) == 2
    stats = list(session._stats_memo.values())[-1]
    assert 0 in stats.heavy["A"].tolist()
    assert_stats_equal(stats, compute_stats(q, lam))
    assert edited.plan_key != first.plan_key
    # the written row's triangle (1, 100, 2) is now (0, 100, 2)
    assert [0, 100, 2] in edited.rows.tolist() and [0, 100, 2] not in first.rows.tolist()
    assert_same_answer(edited, JoinSession(p=8, device="cpu").submit(q, lam=lam))
    assert memo_counts(session.submit(q, lam=lam)) == (1, 0)


def counting_digest(monkeypatch):
    calls = []
    real = query_mod.table_digest

    def counted(data, chunk_digests=query_mod.host_chunk_digests):
        calls.append(id(data))
        return real(data, chunk_digests)

    monkeypatch.setattr(query_mod, "table_digest", counted)
    return calls


def test_self_join_hashes_its_table_once_per_submit(monkeypatch):
    q = heavy_triangle()
    assert len({id(rel.data) for rel in q.relations}) == 1
    calls = counting_digest(monkeypatch)
    session = JoinSession(p=8, device="cpu")
    for n in (1, 2):
        session.submit(q, lam=24)
        assert len(calls) == n                # the executor reuses the service's digest
    session.submit_coalesced([q, q, heavy_triangle(seed=1)], lam=24)
    assert len(calls) == 4                    # one per distinct table of the batch
    # a direct run without the service's digests hashes each table once
    prog = compile_plan(q, compute_stats(q, 24), 8)
    DataplaneExecutor(8, device="cpu").run_many([prog, prog])
    assert len(calls) == 5


def test_fingerprint_follows_every_byte():
    q = heavy_triangle()
    data = q.relations[0].data
    flipped = data.copy()
    flipped.view(np.uint8)[-8] ^= 1                 # the lowest byte of the last value

    def bind(table, schemes=("AB", "BC", "AC")):
        return JoinQuery.make([Relation(tuple(sc), table, "E") for sc in schemes])

    prog = compile_plan(q, compute_stats(q, 24), 8)

    def fp(query):
        return DataplaneExecutor._program_fingerprint(prog.rebind(query), relation_digests(query))

    assert table_digest(data.copy()) == table_digest(data)
    assert table_digest(flipped) != table_digest(data)
    assert fp(bind(data.copy())) == fp(q)
    assert fp(bind(flipped)) != fp(q)
    # the scheme is part of the key: the same table under another binding
    assert fp(bind(data, ("BA", "BC", "AC"))) != fp(q)
