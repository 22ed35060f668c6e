"""The general route's semijoin sweep (TreeSemiJoin) on the device, on the CPU.

The sweep builds every tree edge's inputs where the fragments live: valid
rows gathered in machine order, key columns packed (or densely ranked), the
source's distinct keys and the keyed target spread over the machines.  Held
here against a copy of the host staging it replaced (``HostSweep``: blocks
built with ``blockify`` / ``unblockify`` and numpy, rounds pulled to the
host), at p = 1 and p = 8, for an SSB-shaped star and a snowflake:

* every edge's intersect and filter inputs (pieces, keyed rows, counts),
  every filter output and the fragments ShareRoute takes are equal, padding,
  machine layout and row order included; so are the answer's bytes, the
  count and the retries;
* the cases: packed keys (one shared attribute, and two), dense-rank keys (a negative attribute value; two
  shared attributes whose radix product passes int32), an edge that empties
  the join, a forced overflow retry (``slack=1``);
* the counters ``edges`` and ``ranked_edges`` count the edges run and those
  ranked; the sweep's rounds send only salt offsets and pull only overflow
  flags and counts; its staging sends each base relation once and reads
  back only each edge's minima and maxima;
* the base staging refuses a value past the int32 device word;
* ShareRoute releases the fragments: no state holds them after its lowering
  and none of their tensors is alive when CellJoin starts (a star, and a
  cyclic program, which reaches ShareRoute without a sweep); the blocks it
  routes stay on the executor's device for CellJoin.
"""

import gc
import weakref
from functools import partial

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import query as tq
from repro_torch.core.taxonomy import compute_stats
from repro_torch.dataplane.exchange import blockify, salt_offset, unblockify
from repro_torch.dataplane.join import batched_sharded_intersect, batched_sharded_semijoin
from repro_torch.mpc import program as tprog
from repro_torch.mpc.executors import DataplaneExecutor, _WorkItem, _pull_rows, _salt

torch.set_num_threads(1)

LAM = 4


# ---------------------------------------------------------------------------
# the host staging the device sweep replaced, kept as its reference
# ---------------------------------------------------------------------------


def host_key_cols(tgt_scheme, tgt_rows, src_scheme, src_rows, shared):
    """The host key columns: (target keys, source keys, ranked)."""
    if not shared:
        return np.zeros(len(tgt_rows), np.int64), np.zeros(len(src_rows), np.int64), False
    t = tgt_rows[:, [tgt_scheme.index(a) for a in shared]]
    s = src_rows[:, [src_scheme.index(a) for a in shared]]
    both = np.concatenate([t, s], axis=0)
    if both.size and both.min() >= 0:
        radices = both.max(axis=0).astype(np.int64) + 1
        if np.prod(radices) <= np.iinfo(np.int32).max:
            tk = np.zeros(len(t), np.int64)
            sk = np.zeros(len(s), np.int64)
            for j in range(len(shared)):
                tk = tk * radices[j] + t[:, j]
                sk = sk * radices[j] + s[:, j]
            return tk, sk, False
    _, inv = np.unique(both, axis=0, return_inverse=True)
    inv = inv.reshape(-1).astype(np.int64)
    return inv[: len(t)], inv[len(t):], True


class HostSweep(DataplaneExecutor):
    """The executor with the host staging and host-pulled sweep rounds."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.edges = self.ranked_edges = 0

    def _ensure_general_staged(self, states):
        for state in states:
            if state.gparts is not None or state.empty:
                continue
            query = state.program.query
            if any(len(rel) == 0 for rel in query.relations):
                state.empty = True
                continue
            state.gparts = []
            for rel in query.relations:
                blocks, cnts = blockify(rel.data, self.p, self._block_cap(len(rel)))
                state.gparts.append((list(rel.scheme), blocks, cnts, len(rel)))

    def _lower_tree_semijoin(self, program, states, op):
        self._ensure_general_staged(states)
        n_edges = max((len(st.program.general.tree_edges) for st in states if not st.empty),
                      default=0)
        for ei in range(n_edges):
            prep = []
            for state in states:
                edges = state.program.general.tree_edges
                if state.empty or ei >= len(edges):
                    continue
                child, par, shared = edges[ei] if op.phase == "up" else edges[len(edges) - 1 - ei]
                tgt, src = (par, child) if op.phase == "up" else (child, par)
                tgt_scheme, tgt_blocks, tgt_cnts, n_tgt = state.gparts[tgt]
                src_scheme, src_blocks, src_cnts, _ = state.gparts[src]
                tgt_rows = unblockify(tgt_blocks, tgt_cnts)
                tk, sk, ranked = host_key_cols(tgt_scheme, tgt_rows, src_scheme,
                                               unblockify(src_blocks, src_cnts), shared)
                self.edges += 1
                self.ranked_edges += ranked
                piece = np.unique(sk)
                pv, pc = blockify(piece, self.p, self._block_cap(piece.size))
                keyed = np.concatenate([tgt_rows, tk[:, None]], axis=1)
                kb, kc = blockify(keyed, self.p, self._block_cap(len(keyed)))
                prep.append(_WorkItem(
                    state=state, key=("gsj-intersect", tuple(pv[:, :, 0].shape)),
                    caps={"slot": self._slot_cap(piece.size), "out": self._cap(piece.size)},
                    payload={"pv": pv[:, :, 0], "pc": pc, "rows": kb, "cnts": kc, "n": n_tgt,
                             "tgt": tgt, "col": len(tgt_scheme)},
                    group=("gsj-intersect", state.qi, ei),
                ))
            if not prep:
                continue

            def i_dispatch(bucket, ei=ei):
                s, s_pad = len(bucket), self._pow2_stages(len(bucket))
                pieces = [(self._stack([it.payload["pv"] for it in bucket], s_pad),
                           self._stack([it.payload["pc"] for it in bucket], s_pad))]
                salts = [_salt(it.state.skey, "gsj", op.phase, ei, attempt=it.attempt)
                         for it in bucket]
                offs = np.asarray([salt_offset(v) for v in salts] + [0] * (s_pad - s), np.int32)
                fn, args = batched_sharded_intersect(
                    pieces, offs, cap_slot=bucket[0].caps["slot"],
                    cap_out=bucket[0].caps["out"], device=self.device, invoke=False)

                def post(outs):
                    vals, cnts, ovf = outs

                    def finalize():
                        v, c = _pull_rows(vals[:s], cnts[:s])
                        return [(v[i], c[i], salts[i]) for i in range(s)]

                    return finalize, ovf[:s]

                return fn, args, post

            sj_items = []
            for it in self._run_buckets(op.round, prep, i_dispatch):
                vals, cnts, salt = it.result
                pl = dict(it.payload, piece=(vals, cnts), salt=salt)
                sj_items.append(_WorkItem(
                    state=it.state,
                    key=("gsj-filter", pl["col"], tuple(pl["rows"].shape), tuple(vals.shape)),
                    caps={"slot": self._slot_cap(pl["n"]), "out": self._cap(pl["n"])},
                    payload=pl, group=("gsj-filter", it.state.qi, ei),
                ))

            def f_dispatch(bucket):
                s, s_pad = len(bucket), self._pow2_stages(len(bucket))
                stack = lambda f: self._stack([f(it.payload) for it in bucket], s_pad)  # noqa: E731
                offs = np.asarray([salt_offset(it.payload["salt"]) for it in bucket]
                                  + [0] * (s_pad - s), np.int32)
                fn, args = batched_sharded_semijoin(
                    stack(lambda p: p["rows"]), stack(lambda p: p["cnts"]),
                    bucket[0].payload["col"], offs, stack(lambda p: p["piece"][0]),
                    stack(lambda p: p["piece"][1]), cap_slot=bucket[0].caps["slot"],
                    cap_out=bucket[0].caps["out"], device=self.device, invoke=False)
                return fn, args, partial(self._rows_counts_post, s=s)

            for it in self._run_buckets(op.round, sj_items, f_dispatch):
                blocks, cnts = it.result
                n2 = int(cnts.sum())
                tgt = it.payload["tgt"]
                it.state.gparts[tgt] = (it.state.gparts[tgt][0], blocks[:, :, :-1], cnts, n2)
                if n2 == 0:
                    it.state.empty = True


# ---------------------------------------------------------------------------
# recording both executors
# ---------------------------------------------------------------------------


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def record(ex):
    """Wrap ``ex`` to log each sweep round's inputs and outputs, the
    fragments ShareRoute takes, and weak references to their tensors."""
    log = {"rounds": [], "share": [], "refs": [], "alive_at_cell_join": None,
           "held_after_share": None, "routed": []}
    run_buckets, share, cell = ex._run_buckets, ex._lower_share_route, ex._lower_cell_join
    staged = ex._ensure_general_staged

    def refs(states):
        for state in states:
            for _, blocks, cnts, _ in state.gparts or ():
                if isinstance(blocks, torch.Tensor):        # not the host staging's
                    for x in (blocks, cnts, blocks._base):
                        if x is not None:
                            log["refs"].append(weakref.ref(x))

    def rec_run(round_name, items, dispatch):
        kind = items[0].key[0] if items else None
        if kind not in ("gsj-intersect", "gsj-filter"):
            return run_buckets(round_name, items, dispatch)
        names = ("pv", "pc", "rows", "cnts") if kind == "gsj-intersect" else ("rows", "cnts")
        ins = [(it.key, dict(it.caps), [host(it.payload[n]) for n in names]) for it in items]
        out = run_buckets(round_name, items, dispatch)
        res = ([host(x) for x in it.result[:2]] if kind == "gsj-filter" else None
               for it in out)
        log["rounds"].append((round_name, kind, ins, list(res)))
        return out

    def rec_staged(states):
        staged(states)
        refs(states)

    def rec_share(program, states, op):
        for state in states:
            for scheme, blocks, cnts, n in state.gparts or ():
                log["share"].append((scheme, host(blocks), host(cnts), n))
        refs(states)
        share(program, states, op)
        log["held_after_share"] = [state.gparts for state in states if state.gparts is not None]
        log["routed"] += [blocks for state in states for _, blocks, _, _ in state.routed]

    def rec_cell(program, states, op):
        gc.collect()
        log["alive_at_cell_join"] = sum(r() is not None for r in log["refs"])
        return cell(program, states, op)

    ex._run_buckets, ex._lower_share_route, ex._lower_cell_join = rec_run, rec_share, rec_cell
    ex._ensure_general_staged = rec_staged
    return log


# ---------------------------------------------------------------------------
# the queries
# ---------------------------------------------------------------------------


def dim(keys, m):
    keys = np.asarray(keys)
    return np.stack([keys, np.abs(keys) % m], axis=1)


def star(seed=2, n=400, c_keys=None, s_keys=None):
    """SSB's shape: a 4-ary fact table joined to three keyed dimensions."""
    rng = np.random.default_rng(seed)
    fact = np.stack([rng.integers(0, 30, n), rng.integers(0, 20, n),
                     rng.integers(0, 40, n), rng.integers(0, 10, n)], axis=1)
    c_keys = np.arange(30) if c_keys is None else c_keys
    s_keys = np.arange(20) if s_keys is None else s_keys
    return [(("c", "s", "p", "d"), fact, "F"), (("c", "cn"), dim(c_keys, 5), "C"),
            (("s", "sn"), dim(s_keys, 4), "S"), (("p", "pb"), dim(np.arange(40), 7), "P")]


def negative_star():
    """A customer key of -1 in the fact and its dimension: ranked keys."""
    rels = star()
    fact = rels[0][1].copy()
    fact[::7, 0] = -1
    return [(rels[0][0], fact, "F"), (("c", "cn"), dim(np.arange(-1, 30), 5), "C")] + rels[2:]


def wide_keys(top=2_000_000_000):
    """Two shared attributes whose radix product passes int32 (ranked keys),
    or, at a small ``top``, packs."""
    rng = np.random.default_rng(4)
    big = rng.integers(0, top, size=(40, 1))
    ab = np.concatenate([big, rng.integers(0, 5, size=(40, 1))], axis=1)
    abc = np.concatenate([ab[::2], rng.integers(0, 5, size=(20, 1))], axis=1)
    cd = np.stack([rng.integers(0, 5, 30), rng.integers(0, 9, 30)], axis=1)
    return [(("A", "B"), ab, None), (("A", "B", "C"), abc, None), (("C", "D"), cd, None)]


def emptying_star():
    """No supplier key of the fact is in its dimension: an edge empties it."""
    return star(s_keys=np.arange(100, 120))


def skewed_star():
    """Most facts on one customer: at p = 8 and ``slack=1`` its filter round
    overflows and retries."""
    rels = star(n=900)
    fact = rels[0][1].copy()
    fact[fact[:, 0] < 25, 0] = 3
    return [(rels[0][0], fact, "F")] + rels[1:]


def snowflake():
    return tq.general_query("snowflake", n=60, dom_size=6, skew=0.6, seed=17)


CASES = {
    # query, executor kwargs, whether some edge ranks its keys
    "star": (lambda: tq.query_from_arrays(star(), force_general=True), {}, False),
    "snowflake": (snowflake, {}, False),
    "negative-key": (lambda: tq.query_from_arrays(negative_star(), force_general=True), {}, True),
    "packed-two-columns": (lambda: tq.query_from_arrays(wide_keys(top=50), force_general=True),
                           {}, False),
    "radix-past-int32": (lambda: tq.query_from_arrays(wide_keys(), force_general=True), {}, True),
    "empties": (lambda: tq.query_from_arrays(emptying_star(), force_general=True), {}, False),
    "overflow-retry": (lambda: tq.query_from_arrays(skewed_star(), force_general=True),
                       {"slack": 1}, False),
}


def compile_general(q, p):
    prog = tprog.compile_plan(q, compute_stats(q, LAM), p)
    assert prog.general is not None
    return prog


def assert_equal_logs(got, want):
    assert len(got) == len(want)
    for (gr, gk, gin, gout), (wr, wk, win, wout) in zip(got, want):
        assert (gr, gk) == (wr, wk)
        assert len(gin) == len(win)
        for (gkey, gcaps, garrs), (wkey, wcaps, warrs) in zip(gin, win):
            assert gkey == wkey and gcaps == wcaps
            for g, w in zip(garrs, warrs):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
        for g, w in zip(gout, wout):
            if w is None:
                assert g is None
                continue
            for ga, wa in zip(g, w):
                assert ga.shape == wa.shape
                np.testing.assert_array_equal(ga, wa)


@pytest.mark.parametrize("p", [1, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_sweep_equals_the_host_staging(case, p):
    make, kw, ranks = CASES[case]
    q = make()
    prog = compile_general(q, p)
    dev, ref = DataplaneExecutor(p, device="cpu", **kw), HostSweep(p, device="cpu", **kw)
    got_log, want_log = record(dev), record(ref)
    trace = spans.Trace(0)
    with spans.activate(trace):
        got = dev.run(prog)
    want = ref.run(prog)

    assert_equal_logs(got_log["rounds"], want_log["rounds"])
    assert len(got_log["share"]) == len(want_log["share"])
    for (gs, gb, gc_, gn), (ws, wb, wc, wn) in zip(got_log["share"], want_log["share"]):
        assert gs == ws and gn == wn and gb.shape == wb.shape
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gc_, wc)
    assert got.rows.tobytes() == want.rows.tobytes()
    assert got.count == want.count == len(tq.reference_join(q))
    assert got.per_h_counts == want.per_h_counts
    assert got.retries == want.retries and got.retry_log == want.retry_log

    c = trace.counters
    assert c.get("op.TreeSemiJoin:edges", 0) == ref.edges > 0
    assert c.get("op.TreeSemiJoin:ranked_edges", 0) == ref.ranked_edges
    assert (ref.ranked_edges > 0) == ranks
    if case == "star":
        assert ref.edges == 6                  # three tree edges, each way
    if case == "empties":
        assert got.count == 0 and ref.edges < 6
    if case == "overflow-retry" and p > 1:      # one machine cannot overflow
        assert any(r in ("yan-up", "yan-down") for _, r, _ in got.retry_log)

    # the sweep's rounds send salt offsets (4 bytes a stage, one stage a
    # dispatch here) and pull overflow flags (8 bytes a machine) and the
    # filter's counts (4 more); no row crosses
    sweep = {k: v for k, v in c.items() if k.startswith("op.TreeSemiJoin/round.")}
    dispatches = sum(len(got.bucket_stage_counts.get(r, [])) for r in ("yan-up", "yan-down"))
    h2d = sum(v for k, v in sweep.items() if k.endswith(":h2d_bytes"))
    d2h = sum(v for k, v in sweep.items() if k.endswith(":d2h_bytes"))
    assert not any(k.endswith(":d2h_row_bytes") for k in sweep)
    assert h2d == 4 * dispatches
    assert 8 * p * dispatches < d2h < 12 * p * dispatches and d2h % (4 * p) == 0
    # the staging sends each base relation once as int32 and reads back two
    # int64 words (a minimum and a maximum) a shared attribute of an edge
    assert c["op.TreeSemiJoin/stage:h2d_bytes"] == sum(r.data.size * 4 for r in q.relations)
    d2h_stage = c.get("op.TreeSemiJoin/stage:d2h_bytes", 0)
    assert d2h_stage % 16 == 0 and 16 * ref.edges <= d2h_stage


@pytest.mark.parametrize("kind", ["star", "cyclic"])
def test_share_route_releases_the_fragments(kind):
    if kind == "star":
        q = tq.query_from_arrays(star(), force_general=True)
    else:
        q = tq.general_query("triangle", n=80, dom_size=7, skew=0.5, seed=3)
    prog = compile_general(q, 8)
    assert (prog.general.kind == "hypercube") == (kind == "cyclic")
    ex = DataplaneExecutor(8, device="cpu")
    log = record(ex)
    res = ex.run(prog)
    assert res.count == len(tq.reference_join(q))
    assert log["held_after_share"] == []
    assert len(log["refs"]) >= 2 * len(q.relations)
    assert log["alive_at_cell_join"] == 0
    assert len(log["routed"]) == len(q.relations)
    assert all(isinstance(b, torch.Tensor) and b.device == ex.device for b in log["routed"])


@pytest.mark.parametrize("bad", [2**31 - 1, -2**31 - 1])
def test_base_staging_checks_the_int32_word_contract(bad):
    """A value past the device word (INT32_MAX is the padding sentinel) is
    refused where the base relations are staged, as `blockify` refused it."""
    q = tq.query_from_arrays([(("A", "B"), np.array([[1, 2], [bad, 3]]), None),
                              (("B", "C"), np.array([[2, 5], [3, 6]]), None)],
                             force_general=True)
    with pytest.raises(ValueError, match="int32 device word contract"):
        DataplaneExecutor(8, device="cpu").run(compile_general(q, 8))
