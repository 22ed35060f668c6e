"""Plain PyTorch versions of the port's kernels ≡ the JAX package's public ops.

Each plain version in ``repro_torch.kernels.ref`` is the function its CUDA
kernel must reproduce bit for bit.  Here it is held against the JAX op with
``use_pallas=True`` — on the CPU that runs the Pallas kernel under the
interpreter, as tests/test_kernels.py does — one segment at a time, with no
tolerance: same values, same int32 dtype.

The CUDA kernels themselves are compared with these plain versions on the
card by ``chip_smoke.py`` and by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dataplane.exchange import salt_offset as jax_salt_offset
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.dataplane.exchange import salt_offset
from repro_torch.kernels import _build
from repro_torch.kernels import merge_join as tmj
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.hash_partition import hash_partition_cuda, hash_partition_pack_cuda
from repro_torch.kernels.ssd import ssd_chunk_cuda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)

INT32_MAX = 2**31 - 1


def per_segment(fn, *arrays):
    """Run a JAX op on each row of (S, ...) numpy inputs; stack its outputs."""
    outs = [fn(*(a[i] for a in arrays)) for i in range(arrays[0].shape[0])]
    return [np.stack([np.asarray(o[j]) for o in outs]) for j in range(len(outs[0]))]


def assert_same(got, want):
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.dtype == np.int32 and w.dtype == np.int32, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# hash_u32 and the int32 wrap of salted keys
# ---------------------------------------------------------------------------


def test_hash_u32_matches_jax_near_int32_limits():
    edge = np.array([0, 1, -1, 2, -2, INT32_MAX, INT32_MAX - 1, -(2**31), -(2**31) + 1,
                     2**30, -(2**30), 65535, 65536, -65536], np.int64)
    rnd = np.random.default_rng(0).integers(-(2**31), 2**31, 4096)
    keys = np.concatenate([edge, rnd]).astype(np.int32)
    want = np.asarray(jref.hash_u32_ref(jnp.asarray(keys))).astype(np.int64)
    got = tref.hash_u32_ref(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 2**32


@pytest.mark.parametrize("salt", [0, 1, 7, 2**20 + 3, 1_234_567_891])
def test_salted_keys_wrap_like_int32(salt):
    """key + salt_offset(salt) wraps in int32 on both sides."""
    assert salt_offset(salt) == jax_salt_offset(salt)
    keys = np.array([0, 5, INT32_MAX - 1, INT32_MAX - 3, -(2**31), 2**30, -7], np.int32)
    off = salt_offset(salt)
    want = np.asarray(jnp.asarray(keys) + jnp.int32(off))
    got = tref.wrap_i32(torch.from_numpy(keys).to(torch.int64) + off).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# hash_partition_pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,parts", [(1024, 8), (4096, 64), (1000, 3), (1, 1), (3001, 64),
                                     (2048, 1), (2500, 383), (1025, 2)])
def test_hash_partition_pack_matches_jax(n, parts):
    rng = np.random.default_rng(n * 131 + parts)
    keys = rng.integers(-(2**31), 2**31, (3, n)).astype(np.int32)
    keys[0, : min(n, 3)] = [INT32_MAX, -(2**31), INT32_MAX - 1][: min(n, 3)]
    counts = np.array([n, int(0.7 * n), 0], np.int32)
    want = per_segment(
        lambda k, c: jops.hash_partition_pack(jnp.asarray(k), int(c), parts, use_pallas=True),
        keys, counts,
    )
    got = tref.hash_partition_pack_ref(torch.from_numpy(keys), torch.from_numpy(counts), parts)
    assert_same(got, want)


@pytest.mark.parametrize("dom,salt", [(3, 0), (40, 12345), (2**31, 987_654_321)])
def test_hash_partition_pack_duplicates_and_salt(dom, salt):
    """Heavily duplicated keys (stable slots inside one partition) and a
    salt whose offset wraps the salted keys in int32."""
    rng = np.random.default_rng(dom)
    raw = rng.integers(0, dom, (2, 2000)).astype(np.int64)
    raw[1, :5] = INT32_MAX - 1
    off = salt_offset(salt)
    keys = tref.wrap_i32(torch.from_numpy(raw) + off)
    jkeys = np.asarray(jnp.asarray(raw.astype(np.int32)) + jnp.int32(off))
    np.testing.assert_array_equal(keys.numpy(), jkeys)
    counts = np.array([2000, 1500], np.int32)
    want = per_segment(
        lambda k, c: jops.hash_partition_pack(jnp.asarray(k), int(c), 8, use_pallas=True),
        jkeys, counts,
    )
    assert_same(tref.hash_partition_pack_ref(keys, torch.from_numpy(counts), 8), want)


def test_stable_rank_is_the_one_hot_running_count():
    rng = np.random.default_rng(5)
    part = rng.integers(0, 5, (4, 777))
    got = tref.stable_rank(torch.from_numpy(part), 5).numpy()
    want = np.zeros_like(part)
    for s in range(part.shape[0]):
        seen = {}
        for i, b in enumerate(part[s]):
            want[s, i] = seen.get(b, 0)
            seen[b] = want[s, i] + 1
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# merge_join_counts / merge_join_pairs
# ---------------------------------------------------------------------------


def sorted_segments(rng, s, n, dom, fills):
    """(s, n) int32, each row sorted with its tail past fills[i] sentinelled."""
    x = np.sort(rng.integers(0, dom, (s, n)), axis=1).astype(np.int64)
    for i, f in enumerate(fills):
        x[i, f:] = INT32_MAX
    return x.astype(np.int32)


@pytest.mark.parametrize("n,m", [(256, 1024), (512, 2048), (300, 1500), (256, 999), (1, 7)])
@pytest.mark.parametrize("dom", [50, 10_000])
def test_merge_join_counts_matches_jax(n, m, dom):
    rng = np.random.default_rng(n + m + dom)
    a = sorted_segments(rng, 3, n, dom, [n, n // 2, 0])      # last row: all sentinels
    b = sorted_segments(rng, 3, m, dom, [m, 0, m // 3])
    want = per_segment(
        lambda x, y: jops.merge_join_counts(jnp.asarray(x), jnp.asarray(y), use_pallas=True),
        a, b,
    )
    assert_same(tref.merge_join_counts_ref(torch.from_numpy(a), torch.from_numpy(b)), want)


def pairs_inputs(rng, s, n, m, dom):
    a = sorted_segments(rng, s, n, dom, [n] + [int(f) for f in rng.integers(0, n + 1, s - 1)])
    b = sorted_segments(rng, s, m, dom, [m] * s)
    lower = np.stack([np.searchsorted(b[i], a[i], "left") for i in range(s)]).astype(np.int32)
    upper = np.stack([np.searchsorted(b[i], a[i], "right") for i in range(s)]).astype(np.int32)
    cnt = np.where(a < INT32_MAX, upper - lower, 0)
    starts = (np.cumsum(cnt, axis=1) - cnt).astype(np.int32)
    return lower, starts, cnt.sum(axis=1)


@pytest.mark.parametrize("n,m,dom,cap_out", [
    (256, 1024, 50, 1 << 13),
    (300, 1500, 40, 1 << 12),
    (512, 2048, 10_000, 1 << 10),
    (1, 7, 3, 64),
    (100, 100, 2, 300),          # cap_out far below the total: truncation
])
def test_merge_join_pairs_matches_jax(n, m, dom, cap_out):
    rng = np.random.default_rng(n * m + dom)
    lower, starts, _ = pairs_inputs(rng, 3, n, m, dom)
    want = per_segment(
        lambda lo, st: jops.merge_join_pairs(jnp.asarray(lo), jnp.asarray(st), cap_out,
                                             use_pallas=True),
        lower, starts,
    )
    got = tref.merge_join_pairs_ref(torch.from_numpy(lower), torch.from_numpy(starts), cap_out)
    assert_same(got, want)


def pairs_from_counts(rng, counts):
    starts = np.cumsum(counts, axis=1) - counts
    lower = np.cumsum(rng.integers(0, 3, counts.shape), axis=1) + starts
    return lower.astype(np.int32), starts.astype(np.int32)


@pytest.mark.parametrize("case", ["zero-count-tail", "hub-key", "all-zero", "equal-start-runs",
                                  "cap-one"])
def test_merge_join_pairs_from_counts_matches_jax(case):
    """The load-balancing search's regimes on the plain version: mostly
    zero-count keys with a zero-count tail (slots past the total alias the
    last key), one key owning every slot, no match at all, long runs of
    equal starts, a single slot."""
    rng = np.random.default_rng(len(case))
    n, cap = 1000, 1500
    if case == "zero-count-tail":
        counts = np.where(rng.random((3, n)) < 0.1, rng.geometric(0.7, (3, n)), 0)
        counts[:, 650:] = 0
    elif case == "hub-key":
        counts = np.zeros((3, n), np.int64)
        counts[:, 77] = cap
    elif case == "all-zero":
        counts = np.zeros((3, n), np.int64)
    elif case == "equal-start-runs":
        counts = np.zeros((3, n), np.int64)
        counts[:, ::301] = 5
    else:
        counts, cap = rng.integers(0, 3, (3, n)), 1
    lower, starts = pairs_from_counts(rng, counts)
    want = per_segment(
        lambda lo, st: jops.merge_join_pairs(jnp.asarray(lo), jnp.asarray(st), cap,
                                             use_pallas=True),
        lower, starts,
    )
    got = tref.merge_join_pairs_ref(torch.from_numpy(lower), torch.from_numpy(starts), cap)
    assert_same(got, want)


# ---------------------------------------------------------------------------
# Dispatch: the device of the tensors decides; no fallback on CUDA tensors
# ---------------------------------------------------------------------------


def test_ops_on_cpu_tensors_run_the_plain_versions():
    rng = np.random.default_rng(1)
    lower, starts, _ = pairs_inputs(rng, 2, 64, 64, 10)
    lo, st = torch.from_numpy(lower), torch.from_numpy(starts)
    before = dict(_build.launches)
    for g, w in zip(tops.merge_join_pairs(lo, st, 500), tref.merge_join_pairs_ref(lo, st, 500)):
        assert torch.equal(g, w)
    a = torch.from_numpy(sorted_segments(rng, 2, 50, 9, [50, 20]))
    for g, w in zip(tops.merge_join_counts(a, a), tref.merge_join_counts_ref(a, a)):
        assert torch.equal(g, w)
    keys, counts = a.clone(), torch.tensor([50, 7], dtype=torch.int32)
    for g, w in zip(tops.hash_partition_pack(keys, counts, 4),
                    tref.hash_partition_pack_ref(keys, counts, 4)):
        assert torch.equal(g, w)
    assert dict(_build.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 8), dtype=torch.int32)
    c = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hash_partition_pack_cuda(x, c, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tmj.merge_join_counts_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        tmj.merge_join_pairs_cuda(x, x, 16)
    with pytest.raises(ValueError, match="CUDA"):
        hash_partition_cuda(x[0], 4)
    f = torch.zeros((2, 8, 16), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(f, f, f)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_cuda(f, f[:, :, 0].contiguous(), f[:, 0, 0].contiguous(), f, f, 4)
