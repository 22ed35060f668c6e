"""Port's data plane ≡ the JAX package's, exactly, on the CPU.

* ``batched_hash_exchange`` at p=1 against the JAX function inside a
  1-device ``shard_map`` (rows, counts and both overflow channels), and at
  p=8 against a pure-numpy model of the transpose exchange (the port holds
  the p machines as a tensor axis, so its all-to-all is a transpose);
* the local sorted join on both composite-key paths (mixed-radix packing and
  dense ranking, the latter over a key space beyond 2^31), the count-only
  twin, semijoin, unique and the grid's coordinate hash — one segment of the
  port's batch against one call of the JAX function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.dataplane import exchange as jex
from repro.dataplane import grid as jgrid
from repro.dataplane import join as jjoin
from repro_torch.dataplane import exchange as tex
from repro_torch.dataplane import grid as tgrid
from repro_torch.dataplane import join as tjoin

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)

INT32_MAX = 2**31 - 1
MIX_A, MIX_B = 2654435761, 0x9E3779B9


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def blocks(rng, s, cap, w, dom, counts, lo=0):
    """(s, cap, w) int32 blocks with zero padding past each count."""
    x = rng.integers(lo, dom, (s, cap, w)).astype(np.int32)
    for i, c in enumerate(counts):
        x[i, c:] = 0
    return x


# ---------------------------------------------------------------------------
# Hash exchange
# ---------------------------------------------------------------------------


def jax_exchange_p1(rows, counts, key_col, cap_slot, cap_out, offs):
    """The JAX package's batched_hash_exchange on a 1-device mesh."""
    from jax.experimental.shard_map import shard_map

    mesh = jax.make_mesh((1,), ("m",))

    def body(r, c, o):
        out, cnt, ovs, ovo = jex.batched_hash_exchange(
            r[:, 0], c[:, 0], key_col, "m", 1, cap_slot, cap_out, o)
        return out[:, None], cnt[:, None], ovs[:, None], ovo[:, None]

    fn = jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P(None, "m", None, None), P(None, "m"), P(None)),
        out_specs=(P(None, "m", None, None), P(None, "m"), P(None, "m"), P(None, "m")),
        check_rep=False,
    ))
    return [np.asarray(x) for x in fn(jnp.asarray(rows), jnp.asarray(counts),
                                      jnp.asarray(offs, jnp.int32))]


@pytest.mark.parametrize("cap,w,cap_slot,cap_out", [(64, 2, 64, 64), (64, 3, 32, 16),
                                                    (100, 1, 128, 40)])
def test_batched_hash_exchange_p1_matches_jax(cap, w, cap_slot, cap_out):
    rng = np.random.default_rng(cap * w + cap_slot)
    counts = np.array([cap, cap // 2, 0, 7], np.int32)
    rows = blocks(rng, 4, cap, w, 1000, counts)[:, None]          # (s, p=1, cap, w)
    offs = np.array([tex.salt_offset(v) for v in (0, 11, 2**30 + 5, 123_456_789)], np.int64)
    want = jax_exchange_p1(rows, counts[:, None], 0, cap_slot, cap_out, offs)
    got = tex.batched_hash_exchange(t(rows), t(counts[:, None]), 0, cap_slot, cap_out, t(offs))
    for g, wnt in zip(got, want):
        g = g.numpy()
        assert g.dtype == np.int32, g.dtype
        np.testing.assert_array_equal(g, wnt.astype(np.int32))
    # the overflow channels really were exercised where the caps are small
    if cap_slot < cap:
        assert got[2].sum() > 0
    if cap_out < min(cap, cap_slot):
        assert got[3].sum() > 0


def np_hash(keys):
    k = keys.astype(np.uint32)
    h = (k ^ (k >> np.uint32(16))) * np.uint32(MIX_A)
    h = (h ^ (h >> np.uint32(13))) * np.uint32(MIX_B)
    return h ^ (h >> np.uint32(16))


def numpy_exchange(rows, counts, key_col, cap_slot, cap_out, offs):
    """Reference model: machine i sends its valid rows, in order, to machine
    hash(key + off) % p; a destination slot keeps its first cap_slot rows;
    machine j concatenates what it receives in source order and keeps the
    first cap_out rows."""
    s, p, cap, w = rows.shape
    out = np.zeros((s, p, cap_out, w), np.int32)
    cnt = np.zeros((s, p), np.int32)
    ovs = np.zeros((s, p), np.int32)
    ovo = np.zeros((s, p), np.int32)
    for st in range(s):
        recv = [[] for _ in range(p)]
        for i in range(p):
            valid = rows[st, i, : counts[st, i]]
            keys = (valid[:, key_col].astype(np.int64) + int(offs[st]) + 2**31) % 2**32 - 2**31
            dest = (np_hash(keys.astype(np.int32)) % np.uint32(p)).astype(np.int64)
            for j in range(p):
                mine = valid[dest == j]
                ovs[st, i] += max(len(mine) - cap_slot, 0)
                recv[j].append(mine[:cap_slot])
        for j in range(p):
            got = np.concatenate(recv[j]) if recv[j] else np.zeros((0, w), np.int32)
            ovo[st, j] = max(len(got) - cap_out, 0)
            kept = got[:cap_out]
            out[st, j, : len(kept)] = kept
            cnt[st, j] = len(kept)
    return out, cnt, ovs, ovo


@pytest.mark.parametrize("cap_slot,cap_out", [(64, 256), (4, 24)])
def test_batched_hash_exchange_p8_matches_numpy_model(cap_slot, cap_out):
    rng = np.random.default_rng(cap_slot)
    s, p, cap, w = 3, 8, 48, 3
    counts = rng.integers(0, cap + 1, (s, p)).astype(np.int32)
    counts[0, 0], counts[1, :] = cap, 0
    rows = np.stack([blocks(rng, p, cap, w, 60, counts[i], lo=-30) for i in range(s)])
    rows[2, 0, :3, 1] = [INT32_MAX - 1, -(2**31), INT32_MAX - 2]
    offs = np.array([tex.salt_offset(v) for v in (3, 2**31 - 1, 77)], np.int64)
    want = numpy_exchange(rows, counts, 1, cap_slot, cap_out, offs)
    got = tex.batched_hash_exchange(t(rows), t(counts), 1, cap_slot, cap_out, t(offs))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), wnt)
    if cap_slot == 4:
        assert got[2].sum() > 0 and got[3].sum() > 0


def test_blockify_unblockify_round_trip_matches_jax():
    rng = np.random.default_rng(3)
    rows = rng.integers(-50, 50, (101, 3))
    b, c = tex.blockify(rows, 8, 16)
    jb, jc = jex.blockify(rows, 8, 16, to_device=False)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(c, jc)
    back = tex.unblockify(t(b), t(c))
    assert back.dtype == np.int64
    np.testing.assert_array_equal(back, jex.unblockify(jb, jc))
    np.testing.assert_array_equal(back, rows)


# ---------------------------------------------------------------------------
# Local joins, one segment at a time against the JAX functions
# ---------------------------------------------------------------------------


def per_segment(fn, *arrays):
    outs = [fn(*(a[i] for a in arrays)) for i in range(arrays[0].shape[0])]
    return [np.stack([np.asarray(o[j]) for o in outs]) for j in range(len(outs[0]))]


def assert_outputs_equal(got, want):
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.dtype == np.int32, g.dtype
        np.testing.assert_array_equal(g, w.astype(np.int32))


@pytest.mark.parametrize("cap_out", [512, 40])
def test_local_sorted_join_matches_jax(cap_out):
    rng = np.random.default_rng(cap_out)
    ca, cb = np.array([60, 0, 33, 60]), np.array([50, 50, 0, 17])
    a = blocks(rng, 4, 60, 3, 12, ca)
    b = blocks(rng, 4, 50, 2, 12, cb)
    want = per_segment(
        lambda x, xc, y, yc: jjoin.local_sorted_join(
            jnp.asarray(x), jnp.int32(xc), jnp.asarray(y), jnp.int32(yc), 1, 0, cap_out),
        a, ca, b, cb,
    )
    got = tjoin.local_sorted_join(t(a), t(ca.astype(np.int32)), t(b), t(cb.astype(np.int32)),
                                  1, 0, cap_out)
    assert_outputs_equal(got, want)
    if cap_out == 40:
        assert got[2].sum() > 0, "the small output cap must overflow"


@pytest.mark.parametrize("path", ["packed", "ranked"])
def test_local_join_filtered_and_count_match_jax(path):
    """Cell-keyed join (col 0) with one attribute shared beyond the key: the
    packed int32 key on small domains, the dense rank otherwise — here on
    values shifted by 5e7, whose packed key space would exceed 2^31."""
    rng = np.random.default_rng(11)
    ca, cb = np.array([80, 80, 41]), np.array([70, 12, 70])
    shift = 0 if path == "packed" else 50_000_000
    a = blocks(rng, 3, 80, 3, 6, ca)
    b = blocks(rng, 3, 70, 3, 6, cb)
    a[:, :, 1:] += shift
    b[:, :, 1:] += shift
    for i, (x, y) in enumerate(zip(ca, cb)):
        a[i, x:], b[i, y:] = 0, 0
    dup = ((2, 1),)
    mults = None
    if path == "packed":
        hi = int(max(a[:, :, 2].max(), b[:, :, 1].max())) + 1
        mults = np.full((3, 1), hi, np.int32)
    km = lambda i: None if mults is None else jnp.asarray(mults[i])
    want = [np.stack(x) for x in zip(*[
        [np.asarray(v) for v in jjoin.local_join_filtered(
            jnp.asarray(a[i]), jnp.int32(ca[i]), jnp.asarray(b[i]), jnp.int32(cb[i]),
            0, 0, 600, dup, key_mults=km(i))]
        for i in range(3)])]
    tm = None if mults is None else t(mults)
    ta, tca, tb, tcb = t(a), t(ca.astype(np.int32)), t(b), t(cb.astype(np.int32))
    assert_outputs_equal(tjoin.local_join_filtered(ta, tca, tb, tcb, 0, 0, 600, dup, tm), want)
    want_count = np.array([int(jjoin.local_join_count(
        jnp.asarray(a[i]), jnp.int32(ca[i]), jnp.asarray(b[i]), jnp.int32(cb[i]), 0, 0, dup,
        key_mults=km(i))) for i in range(3)])
    got_count = tjoin.local_join_count(ta, tca, tb, tcb, 0, 0, dup, tm)
    np.testing.assert_array_equal(got_count.numpy(), want_count)
    assert want_count.sum() > 0


def test_composite_rank_keys_match_jax():
    rng = np.random.default_rng(2)
    ac = [rng.integers(0, 4, (2, 30)).astype(np.int32) for _ in range(3)]
    bc = [rng.integers(0, 4, (2, 25)).astype(np.int32) for _ in range(3)]
    av, bv = rng.random((2, 30)) < 0.8, rng.random((2, 25)) < 0.8
    for i in range(2):
        want = jjoin._composite_rank_keys(
            [jnp.asarray(c[i]) for c in ac], jnp.asarray(av[i]),
            [jnp.asarray(c[i]) for c in bc], jnp.asarray(bv[i]))
        got = tjoin._composite_rank_keys(
            [t(c[i : i + 1]) for c in ac], t(av[i : i + 1]),
            [t(c[i : i + 1]) for c in bc], t(bv[i : i + 1]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_local_semijoin_and_unique_match_jax():
    rng = np.random.default_rng(9)
    cr, ck = np.array([90, 50, 0]), np.array([30, 0, 30])
    rows = blocks(rng, 3, 90, 2, 25, cr)
    keys = blocks(rng, 3, 30, 1, 25, ck)[:, :, 0]
    want = per_segment(
        lambda r, c, k, kc: jjoin.local_semijoin(
            jnp.asarray(r), jnp.int32(c), 1, jnp.asarray(k), jnp.int32(kc)),
        rows, cr, keys, ck,
    )
    got = tjoin.local_semijoin(t(rows), t(cr.astype(np.int32)), 1, t(keys),
                               t(ck.astype(np.int32)))
    assert_outputs_equal(got, want)
    want_u = per_segment(lambda v, c: jjoin.local_unique(jnp.asarray(v), jnp.int32(c)),
                         keys, ck)
    assert_outputs_equal(tjoin.local_unique(t(keys), t(ck.astype(np.int32))), want_u)


def test_coord_hash_matches_jax():
    rng = np.random.default_rng(4)
    vals = np.concatenate([rng.integers(-(2**31), 2**31, 2000),
                           [0, -1, INT32_MAX, -(2**31)]]).astype(np.int32)
    for salt in (0, 1, 2**31 + 17, 2**32 - 1):
        want = np.asarray(jgrid.coord_hash(jnp.asarray(vals), jnp.uint32(salt)))
        got = tgrid.coord_hash(t(vals), torch.tensor(salt, dtype=torch.int64)).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_unbatched_hash_exchange_is_one_stage_of_the_batch():
    rng = np.random.default_rng(8)
    counts = np.array([40, 0, 17, 40], np.int32)
    rows = np.stack([blocks(rng, 4, 40, 2, 90, counts)])          # (s=1, p=4, cap, w)
    want = tex.batched_hash_exchange(t(rows), t(counts[None]), 1, 8, 64,
                                     torch.tensor([tex.salt_offset(5)]))
    got = tex.hash_exchange(t(rows[0]), t(counts), 1, 8, 64, salt=5)
    for g, w in zip(got, want):
        assert torch.equal(g, w[0])


def test_grid_coordinate_functions_match_reference_numpy():
    from repro.mpc.cartesian import CartesianGrid as JGrid
    from repro.mpc.hypercube import HyperCubeGrid as JCube
    from repro_torch.mpc.cartesian import CartesianGrid
    from repro_torch.mpc.hypercube import HyperCubeGrid

    ids = np.arange(87, dtype=np.int64)
    g, jg = CartesianGrid([50, 30, 7], 16), JGrid([50, 30, 7], 16)
    assert (g.dims, g.t_prime) == (jg.dims, jg.t_prime)
    for li in range(g.t_prime):
        want = jg.cells_for_ids(li, ids)
        np.testing.assert_array_equal(g.cells_for_ids(li, ids), want)
        np.testing.assert_array_equal(g.cells_for_ids_dev(li, t(ids.astype(np.int32))).numpy(),
                                      want)
    shares = {"A": 3, "B": 2, "C": 4}
    hc, jhc = HyperCubeGrid(("A", "B", "C"), shares), JCube(("A", "B", "C"), shares)
    fixed = {"A": np.array([0, 1, 2, 0, 2]), "C": np.array([3, 2, 1, 0, 3])}
    want = jhc.cells_for(fixed)
    np.testing.assert_array_equal(hc.cells_for(fixed), want)
    got = hc.cells_for_dev({k: t(v.astype(np.int32)) for k, v in fixed.items()})
    np.testing.assert_array_equal(got.numpy(), want)


def test_hypercube_cell_twins_run_where_the_caller_asks():
    """Asked for the CPU, the torch twins give the numpy cells there; asked
    nothing, they run on the card (and raise where there is none)."""
    from repro.mpc.hypercube import HyperCubeGrid as JCube
    from repro_torch.mpc.hypercube import HyperCubeGrid, hc_cell_contribs, hc_cells_dev

    shares = {"A": 3, "B": 2, "C": 4}
    hc, jhc = HyperCubeGrid(("A", "B", "C"), shares), JCube(("A", "B", "C"), shares)
    got = hc.cells_for_dev({}, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), jhc.cells_for({}))
    coords = np.array([1, 0, 1, 1])
    strides, contribs = hc_cell_contribs(hc.attrs, hc.dims, ("B",))
    got = hc_cells_dev([(t(coords.astype(np.int32)), strides["B"])], contribs, 4, device="cpu")
    np.testing.assert_array_equal(got.numpy(), jhc.cells_for({"B": coords}))
    if torch.cuda.is_available():
        assert hc.cells_for_dev({}).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            hc.cells_for_dev({})
