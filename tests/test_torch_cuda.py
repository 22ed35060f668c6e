"""The hand-written CUDA kernels ≡ their plain PyTorch versions, on the card
(the integer kernels bit for bit, attention and the SSD scan within the
tolerances that chip_smoke.py states).

Marked ``cuda``: without a CUDA card every test here skips (the kernels
have no CPU form).  The file imports neither jax nor the JAX package, so it
runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import merge_join as tmj
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_cuda
from repro_torch.kernels.hash_partition import (MAX_SMEM_PARTS, SMEM_LIMIT, hash_partition_cuda,
                                                hash_partition_pack_cuda)
from repro_torch.kernels.ssd import ssd_chunk_cuda
from repro_torch.kernels import ref as tref

INT32_MAX = 2**31 - 1


def sorted_segments(rng, s, n, dom, fills):
    """(s, n) int32, each row sorted with its tail past fills[i] sentinelled."""
    x = np.sort(rng.integers(0, dom, (s, n)), axis=1).astype(np.int64)
    for i, f in enumerate(fills):
        x[i, f:] = INT32_MAX
    return x.astype(np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,parts", [(64, 1000, 64), (5, 3001, 1), (4096, 1024, 8)])
def test_hash_partition_pack_kernel_on_card(cuda_device, s, n, parts):
    rng = np.random.default_rng(s + n)
    keys = torch.from_numpy(rng.integers(-(2**31), 2**31, (s, n)).astype(np.int32))
    counts = torch.from_numpy(rng.integers(0, n + 1, s).astype(np.int32))
    k, c = keys.to(cuda_device), counts.to(cuda_device)
    got = hash_partition_pack_cuda(k, c, parts)
    for g, w in zip(got, tref.hash_partition_pack_ref(keys, counts, parts)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,m,dom", [(64, 1000, 3000, 40), (3, 1, 999, 3)])
def test_merge_join_kernels_on_card(cuda_device, s, n, m, dom):
    rng = np.random.default_rng(n + m)
    a = torch.from_numpy(sorted_segments(rng, s, n, dom, [n] * (s - 1) + [0]))
    b = torch.from_numpy(sorted_segments(rng, s, m, dom, [m] * s))
    lower, upper = tref.merge_join_counts_ref(a, b)
    for g, w in zip(tmj.merge_join_counts_cuda(a.to(cuda_device), b.to(cuda_device)),
                    (lower, upper)):
        assert torch.equal(g.cpu(), w)
    cnt = torch.where(a < INT32_MAX, upper - lower, torch.zeros_like(lower)).to(torch.int64)
    starts = (torch.cumsum(cnt, dim=1) - cnt).to(torch.int32)
    got = tmj.merge_join_pairs_cuda(lower.to(cuda_device), starts.to(cuda_device), 5000)
    for g, w in zip(got, tref.merge_join_pairs_ref(lower, starts, 5000)):
        assert torch.equal(g.cpu(), w)


def merge_join_edge_case(name):
    """(a, b) int32 CPU tensors, rows sorted, for one named hazard of the
    merge-path search."""
    rng = np.random.default_rng(len(name))
    lo32, hi32 = -(2**31), INT32_MAX
    if name == "runs-across-stretches":      # 3 keys over 2^20: runs span many stretches
        a = np.sort(rng.integers(-1, 4, (64, 4096)), axis=1)
        b = np.sort(rng.integers(0, 3, (64, 1 << 20)), axis=1)
    elif name == "n1":
        a = rng.integers(0, 1000, (8, 1))
        b = np.sort(rng.integers(0, 1000, (8, 1 << 20)), axis=1)
    elif name == "m1":
        a = np.sort(rng.integers(0, 1000, (8, 1 << 20)), axis=1)
        b = rng.integers(0, 1000, (8, 1))
    elif name == "all-sentinel":             # all sentinels: both rows 0-1, A in 2, B in 3
        a = np.sort(rng.integers(0, 50, (4, 3000)), axis=1)
        b = np.sort(rng.integers(0, 50, (4, 5000)), axis=1)
        a[:3], b[:2], b[3] = INT32_MAX, INT32_MAX, INT32_MAX
        a[3, 2000:] = INT32_MAX
    else:                                    # "int32-extremes": keys at -2^31 and 2^31 - 1
        edge = np.array([lo32, lo32 + 1, hi32 - 1, hi32])
        a = np.sort(rng.choice(edge, (16, 5000)), axis=1)
        b = np.sort(rng.choice(edge, (16, 7000)), axis=1)
    return (torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["runs-across-stretches", "n1", "m1", "all-sentinel",
                                  "int32-extremes"])
def test_merge_join_counts_kernel_edge_cases_on_card(cuda_device, name):
    a, b = merge_join_edge_case(name)
    before = _build.launches["merge_join_counts"]
    got = tmj.merge_join_counts_cuda(a.to(cuda_device), b.to(cuda_device))
    assert _build.launches["merge_join_counts"] == before + 1
    for g, w in zip(got, tref.merge_join_counts_ref(a, b)):
        assert torch.equal(g.cpu(), w)


def pairs_from_counts(rng, counts):
    """(lower, starts) int32 CPU tensors for per-key match counts (S, N)."""
    starts = np.cumsum(counts, axis=1) - counts
    lower = np.cumsum(rng.integers(0, 3, counts.shape), axis=1) + starts
    return torch.from_numpy(lower.astype(np.int32)), torch.from_numpy(starts.astype(np.int32))


def merge_join_pairs_edge_case(name):
    """(lower, starts, cap_out) for one named hazard of the load-balancing
    search (each block owns 2816 elements of the merge of keys and slots)."""
    rng = np.random.default_rng(len(name))
    if name in ("main-path-regime", "cap-off-stretch"):  # 90% zero counts, 35% zero tail
        counts = np.where(rng.random((16, 40000)) < 0.1, rng.geometric(0.7, (16, 40000)), 0)
        counts[:, 26000:] = 0
        cap = int(1.6 * counts.sum(axis=1).max()) if name == "main-path-regime" else 3 * 2816 + 17
    elif name == "total-over-cap":           # keys past the last slot
        counts = rng.integers(0, 6, (16, 20000))
        cap = int(counts.sum(axis=1).min()) // 3
    elif name == "hub-owns-all-slots":       # one key across 372 stretches
        counts = np.zeros((8, 5000), np.int64)
        counts[:, 1234] = 1 << 20
        cap = 1 << 20
    elif name == "equal-starts-across-stretches":
        counts = np.zeros((16, 30000), np.int64)
        counts[:, ::3001] = 5
        cap = 60
    elif name == "n1":
        counts, cap = rng.integers(0, 9, (8, 1)), 1000
    elif name == "cap1":
        counts, cap = rng.integers(0, 3, (8, 5000)), 1
    else:                                    # "s4096-small-n"
        counts, cap = rng.integers(0, 4, (4096, 16)), 64
    return (*pairs_from_counts(rng, counts), cap)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["main-path-regime", "total-over-cap", "hub-owns-all-slots",
                                  "equal-starts-across-stretches", "n1", "cap1",
                                  "cap-off-stretch", "s4096-small-n"])
def test_merge_join_pairs_kernel_edge_cases_on_card(cuda_device, name):
    lower, starts, cap = merge_join_pairs_edge_case(name)
    before = _build.launches["merge_join_pairs"]
    got = tmj.merge_join_pairs_cuda(lower.to(cuda_device), starts.to(cuda_device), cap)
    assert _build.launches["merge_join_pairs"] == before + 1
    for g, w in zip(got, tref.merge_join_pairs_ref(lower, starts, cap)):
        assert torch.equal(g.cpu(), w)


def hash_partition_pack_edge_case(name):
    """(keys, counts, n_parts) for one named hazard of the look-back across
    a segment's 1024-row tiles."""
    rng = np.random.default_rng(len(name))
    keys = lambda s, n: rng.integers(-(2**31), 2**31, (s, n)).astype(np.int32)
    mixed = lambda s, n: np.array([0, n] * (s // 2), np.int32)
    if name == "n2e20-one-partition":        # 1024 tiles of look-back, one bin
        k, c, parts = np.full((4, 1 << 20), 777, np.int32), np.full(4, 1 << 20, np.int32), 64
    elif name == "n2e20-64-partitions":
        k, c, parts = keys(4, 1 << 20), rng.integers(0, (1 << 20) + 1, 4).astype(np.int32), 64
    elif name == "n-off-1024":
        k, c, parts = keys(6, 5003), mixed(6, 5003), 16
    elif name == "n1":
        k, c, parts = keys(4, 1), mixed(4, 1), 5
    elif name == "counts-0-and-n":
        k, c, parts = keys(8, 4096), mixed(8, 4096), 64
    elif name == "p1":
        k, c, parts = keys(4, 3000), np.full(4, 3000, np.int32), 1
    elif name == "p-largest":                # the largest P of the single-block kernel
        k, c, parts = keys(4, 9000), rng.integers(0, 9001, 4).astype(np.int32), MAX_SMEM_PARTS
    elif name == "p-past-single-block":      # the smallest P of the wide kernel
        k, c, parts = keys(4, 9000), rng.integers(0, 9001, 4).astype(np.int32), MAX_SMEM_PARTS + 1
    elif name in ("p384", "p1024", "p4096"):  # past the old limit of 383, on both kernels
        k, c, parts = keys(8, 5000), rng.integers(0, 5001, 8).astype(np.int32), int(name[1:])
    else:                                    # "s4096-one-tile"
        k, c, parts = keys(4096, 1024), rng.integers(0, 1025, 4096).astype(np.int32), 64
    return torch.from_numpy(k), torch.from_numpy(c), parts


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["n2e20-one-partition", "n2e20-64-partitions", "n-off-1024",
                                  "n1", "counts-0-and-n", "p1", "p-largest", "s4096-one-tile",
                                  "p-past-single-block", "p384", "p1024", "p4096"])
def test_hash_partition_pack_kernel_edge_cases_on_card(cuda_device, name):
    keys, counts, parts = hash_partition_pack_edge_case(name)
    before = _build.launches["hash_partition_pack"]
    got = hash_partition_pack_cuda(keys.to(cuda_device), counts.to(cuda_device), parts)
    assert _build.launches["hash_partition_pack"] == before + 1
    for g, w in zip(got, tref.hash_partition_pack_ref(keys, counts, parts)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_launch_counters_skip_calls_with_no_work(cuda_device):
    """A wrapper counts only calls that launched its kernel."""
    i32 = dict(dtype=torch.int32, device=cuda_device)
    before = dict(_build.launches)
    part, slot, send = hash_partition_pack_cuda(torch.empty((0, 64), **i32),
                                                    torch.empty((0,), **i32), 8)
    assert part.shape == (0, 64) and send.shape == (0, 8)
    lower, _ = tmj.merge_join_counts_cuda(torch.empty((4, 0), **i32),
                                          torch.zeros((4, 16), **i32))
    assert lower.shape == (4, 0)
    a_idx, _ = tmj.merge_join_pairs_cuda(torch.zeros((4, 16), **i32),
                                         torch.zeros((4, 16), **i32), 0)
    assert a_idx.shape == (4, 0)
    assert dict(_build.launches) == before
    # N = 0 with segments still launches the scan pass: zero send counts
    _, _, send = hash_partition_pack_cuda(torch.empty((3, 0), **i32),
                                              torch.zeros((3,), **i32), 8)
    assert _build.launches["hash_partition_pack"] == before.get("hash_partition_pack", 0) + 1
    assert torch.equal(send.cpu(), torch.zeros((3, 8), dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,parts", [(1, 1), (3001, 7), (1 << 20, 64)])
def test_hash_partition_kernel_on_card(cuda_device, n, parts):
    rng = np.random.default_rng(n + parts)
    keys = torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(np.int32))
    got = hash_partition_cuda(keys.to(cuda_device), parts)
    for g, w in zip(got, tref.hash_partition_ref(keys, parts)):
        assert torch.equal(g.cpu(), w)


#: (N, P, offset): N below, at and past one group of 4 keys, keys that start
#: off a 16-byte boundary (an offset view), and the largest P the wrapper takes
HASH_PARTITION_EDGES = {
    "n1": (1, 64, 0), "n3": (3, 7, 0), "n4097": (4097, 64, 0),
    "n2e20-offset-view": (1 << 20, 64, 1), "n3-offset-view": (3, 5, 3),
    "p-largest": (20000, SMEM_LIMIT // 4 - 1, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(HASH_PARTITION_EDGES))
def test_hash_partition_kernel_edge_cases_on_card(cuda_device, name):
    n, parts, offset = HASH_PARTITION_EDGES[name]
    rng = np.random.default_rng(len(name))
    full = rng.integers(-(2**31), 2**31, n + offset).astype(np.int32)
    keys = torch.from_numpy(full).to(cuda_device)[offset:]
    assert keys.is_contiguous() and keys.storage_offset() == offset
    before = _build.launches["hash_partition"]
    part, hist = hash_partition_cuda(keys, parts)
    assert _build.launches["hash_partition"] == before + 1
    want = tref.hash_partition_ref(torch.from_numpy(full[offset:]), parts)
    assert torch.equal(part.cpu(), want[0]) and torch.equal(hist.cpu(), want[1])
    assert int(hist.sum()) == n


#: (BH, Sq, Sk, D, causal): ragged Sq and Sk (not multiples of the 64-row
#: tiles), Sq != Sk under the causal mask, BH = 1, and every head dim at
#: each edge shape
ATTENTION_SHAPES = (
    [(3, 100, 100, 80, True), (3, 128, 256, 64, True), (3, 384, 384, 128, False),
     (3, 256, 256, 32, True), (3, 64, 192, 16, False)]
    + [(bh, sq, sk, d, causal) for bh, sq, sk, causal in
       [(1, 64, 100, False), (2, 200, 200, True), (2, 128, 256, True), (2, 256, 128, True),
        (1, 1, 1, True)] for d in HEAD_DIMS])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,causal", ATTENTION_SHAPES)
def test_flash_attention_kernel_on_card(cuda_device, bh, sq, sk, d, causal, dtype):
    rng = np.random.default_rng(bh * 7 + sq + sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d), dtype=np.float32))
               .to(cuda_device).to(dtype) for s in (sq, sk, sk))
    got = flash_attention_cuda(q, k, v, causal)
    want = tref.flash_attention_ref(q, k, v, causal)
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        limit = tref.flash_attention_bf16_tolerance(q, k, v, want, causal)
        assert bool(((got.float() - want.float()).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,p,n,chunk", [(1, 256, 64, 128, 256), (3, 512, 16, 32, 64),
                                            (2, 64, 64, 128, 16)])
def test_ssd_chunk_kernel_on_card(cuda_device, bh, s, p, n, chunk):
    rng = np.random.default_rng(bh * s + p)
    arrays = (rng.standard_normal((bh, s, p), dtype=np.float32),
              rng.uniform(0.01, 0.2, (bh, s)).astype(np.float32),
              -rng.uniform(0.5, 2.0, bh).astype(np.float32),
              rng.standard_normal((bh, s, n), dtype=np.float32),
              rng.standard_normal((bh, s, n), dtype=np.float32))
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    for g, w in zip(ssd_chunk_cuda(*args, chunk), tref.ssd_chunked_ref(*args, chunk)):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def ssd_edge_case(name):
    """(x, dt, a, b, c) float32 CPU tensors and the chunk, for one named hazard
    of the chunk-parallel scan, plus the storage offset (in elements) its
    card copies start at."""
    bh, s, p, n, chunk, a_val, offset = {
        "p17-n33-chunk40": (2, 80, 17, 33, 40, None, 0),   # ragged tiles, odd rows
        "chunk16-64-chunks": (2, 1024, 64, 128, 16, None, 0),   # a long state scan
        "bh1": (1, 512, 64, 128, 256, None, 0),
        "a0-no-decay": (2, 1024, 64, 64, 64, 0.0, 0),      # states grow over the chunks
        "a-50-underflow": (2, 512, 64, 128, 256, -50.0, 0),
        "one-chunk": (3, 256, 32, 64, 256, None, 0),
        "offset-one-element": (2, 256, 64, 128, 64, None, 1),   # not 16-byte aligned
        "offset-16-bytes": (2, 256, 64, 128, 64, None, 4),
    }[name]
    rng = np.random.default_rng(len(name) + bh * s)
    a = (np.full(bh, a_val, np.float32) if a_val is not None
         else -rng.uniform(0.5, 2.0, bh).astype(np.float32))
    arrays = (rng.standard_normal((bh, s, p), dtype=np.float32),
              rng.uniform(0.01, 0.2, (bh, s)).astype(np.float32), a,
              rng.standard_normal((bh, s, n), dtype=np.float32),
              rng.standard_normal((bh, s, n), dtype=np.float32))
    return [torch.from_numpy(x) for x in arrays], chunk, offset


def on_card_at_offset(t, device, offset):
    """A contiguous card copy of t whose data starts ``offset`` elements into
    its storage."""
    buf = torch.empty((t.numel() + offset,), dtype=t.dtype, device=device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p17-n33-chunk40", "chunk16-64-chunks", "bh1", "a0-no-decay",
                                  "a-50-underflow", "one-chunk", "offset-one-element",
                                  "offset-16-bytes"])
def test_ssd_chunk_kernel_edge_cases_on_card(cuda_device, name):
    args, chunk, offset = ssd_edge_case(name)
    card = [on_card_at_offset(t, cuda_device, offset) for t in args]
    assert all(t.is_contiguous() and t.storage_offset() == offset for t in card)
    before = _build.launches["ssd_chunk"]
    got = ssd_chunk_cuda(*card, chunk)
    assert _build.launches["ssd_chunk"] == before + 1
    for g, w in zip(got, tref.ssd_chunked_ref(*args, chunk)):
        g = g.cpu()
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.cuda
def test_ssd_chunk_kernel_refuses_what_shared_memory_cannot_hold(cuda_device):
    """A chunk of 32768 steps needs its cum and decay weights (2 x 32768 fp32)
    in one block's shared memory, past what a block can have: the launcher's
    error raises, and the next launch is unaffected by it."""
    f32 = dict(dtype=torch.float32, device=cuda_device)
    s = 32768
    big = (torch.zeros((1, s, 8), **f32), torch.full((1, s), 0.1, **f32),
           torch.full((1,), -1.0, **f32), torch.zeros((1, s, 8), **f32),
           torch.zeros((1, s, 8), **f32))
    before = _build.launches["ssd_chunk"]
    with pytest.raises(RuntimeError, match="ssd_chunk"):
        ssd_chunk_cuda(*big, s)
    assert _build.launches["ssd_chunk"] == before
    small = [t[:, :16] for t in big[:2]] + [big[2]] + [t[:, :16] for t in big[3:]]
    small[0] = torch.ones((1, 16, 8), **f32)
    y, state = ssd_chunk_cuda(*(t.contiguous() for t in small), 16)
    torch.cuda.synchronize()
    assert _build.launches["ssd_chunk"] == before + 1
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())


def zipf_triangle_query(seed, n_vertices, n_edges):
    """A Zipf graph's degree-oriented triangle query (the port's generator)."""
    from repro_torch.core.query import query_from_arrays
    from repro_torch.graph import compile_pattern, triangle, zipf_graph

    g = zipf_graph(np.random.default_rng(seed), n_vertices, n_edges, skew=0.9)
    rels = compile_pattern(g, triangle()).query.relations
    return query_from_arrays([(r.scheme, r.data, r.table) for r in rels])


def same_result(a, b):
    return (a.count == b.count and a.per_h_counts == b.per_h_counts
            and a.rows.dtype == b.rows.dtype and a.rows.tobytes() == b.rows.tobytes())


@pytest.mark.cuda
def test_session_past_the_old_pack_limit_matches_the_cpu(cuda_device):
    """JoinSession(p=512) on a skewed triangle whose heavy stages run
    HashPartition and SemiJoin: every hash exchange partitions into
    512 > 383 parts, on the single-block pack kernel; the card's rows equal
    the CPU's plain path byte for byte."""
    from repro_torch.core.query import random_query
    from repro_torch.mpc import JoinSession

    q = random_query(np.random.default_rng(2), "clique", 3, tuples_per_rel=2000, dom_size=300,
                     skew=2.0)
    _build.launches.clear()
    got = JoinSession(p=512, device=cuda_device).submit(q, lam=16)
    assert {"step2-unary", "step2-bx"} <= set(got.result.round_us)
    assert _build.launches["hash_partition_pack"] > 0
    assert same_result(got, JoinSession(p=512, device="cpu").submit(q, lam=16))


@pytest.mark.cuda
def test_coalesced_batch_on_card_equals_serial(cuda_device):
    """One coalesced scheduler pass on the card (distinct data behind one
    plan, a repeat that deduplicates, another shape) ≡ serial submits."""
    from repro_torch.mpc import JoinSession

    queries = [zipf_triangle_query(s, 800, 4000) for s in (5, 6, 7)]
    batch = queries + [queries[0]]
    serial = JoinSession(p=64, device=cuda_device)
    want = [serial.submit(q) for q in batch]
    session = JoinSession(p=64, device=cuda_device)
    got = session.submit_coalesced(batch)
    assert session.stats.deduped == 1
    for g, w in zip(got, want):
        assert same_result(g, w)
