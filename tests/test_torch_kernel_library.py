"""The port's kernel library ops ≡ the JAX package's ``repro.kernels.ops``.

``hash_partition``, ``fold64``, ``flash_attention`` and ``ssd_chunk`` of
``repro_torch.kernels`` run here on CPU tensors, so they run their plain
PyTorch versions; the JAX ops run with ``use_pallas=True`` (the Pallas
kernels under the interpreter, as tests/test_kernels.py runs them) and, for
``ssd_chunk``, also on their jnp branch.  Inputs are made with numpy from a
seed and handed to both packages as numpy arrays.

Tolerances: ``hash_partition`` is integer work, bit-equal; float32
attention agrees to 2e-5 (the bound of tests/test_kernels_flash.py);
bfloat16 attention within the rounding error of the output and the weights
(``ref.flash_attention_bf16_tolerance``, tighter than that file's 3e-2 at
these shapes); the SSD scan agrees to 1e-5.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py`` and tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The suite runs several pytest-xdist workers on a few cores: one
    intra-op thread keeps these tests from starving the others, and the
    worker's own setting comes back after this module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

INT32_MAX = 2**31 - 1


def fold64_numpy(keys: np.ndarray) -> np.ndarray:
    """A numpy uint64 transcription of ``repro.kernels.ops.fold64``."""
    k = keys.astype(np.uint64)
    return ((k ^ (k >> np.uint64(32))).astype(np.uint32) & np.uint32(0xFFFFFFFF)).astype(np.int32)


# ---------------------------------------------------------------------------
# hash_partition and fold64
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parts", [1, 8, 64])
@pytest.mark.parametrize("n", [7, 1000, 1024, 3001])
def test_hash_partition_matches_jax(n, parts):
    rng = np.random.default_rng(n * 131 + parts)
    keys = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    keys[: min(n, 4)] = [INT32_MAX, -(2**31), 0, -1][: min(n, 4)]
    want = jops.hash_partition(jnp.asarray(keys), parts, use_pallas=True)
    got = tops.hash_partition(torch.from_numpy(keys), parts)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.int32 and w.dtype == np.int32, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)
    assert int(got[1].sum()) == n


def test_hash_partition_rejects_what_it_cannot_hash():
    with pytest.raises(ValueError, match="int32"):
        tops.hash_partition(torch.zeros(8, dtype=torch.float32), 4)
    with pytest.raises(ValueError, match=r"\(N,\)"):
        tops.hash_partition(torch.zeros((2, 8), dtype=torch.int32), 4)


def test_fold64_matches_the_numpy_uint64_transcription():
    rng = np.random.default_rng(5)
    edge = np.array([0, 1, -1, 2**31, -(2**31), 2**32, -(2**32), 2**32 - 1, 2**62, -(2**62),
                     2**63 - 1, -(2**63), 0x123456789ABCDEF0 - 2**64 + 2**63], np.int64)
    keys = np.concatenate([edge, rng.integers(-(2**63), 2**63 - 1, 4096, dtype=np.int64)])
    got = tops.fold64(torch.from_numpy(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), fold64_numpy(keys))


def test_hash_partition_of_int64_keys_folds_them_first():
    rng = np.random.default_rng(6)
    keys = rng.integers(-(2**63), 2**63 - 1, 3001, dtype=np.int64)
    want = jops.hash_partition(jnp.asarray(fold64_numpy(keys)), 64, use_pallas=True)
    got = tops.hash_partition(torch.from_numpy(keys), 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


def attention_inputs(bh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bh, s, d)).astype(np.float32) for s in (sq, sk, sk)]


@pytest.mark.parametrize("bh,sq,sk,d", [
    (2, 128, 128, 32),
    (1, 256, 256, 64),
    (3, 128, 256, 16),     # Sq != Sk: the causal mask still counts from position 0
    (1, 384, 384, 64),     # several q and kv blocks
    (2, 100, 100, 16),     # one ragged block (bq = bk = 100)
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_f32(bh, sq, sk, d, causal):
    q, k, v = attention_inputs(bh, sq, sk, d, bh * sq + d)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, use_pallas=True)
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (bh, sq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_attention_matches_jax_bf16():
    q, k, v = attention_inputs(2, 256, 256, 64, 0)
    want = jops.flash_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                                causal=True, use_pallas=True)
    got = tops.flash_attention(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)),
                               causal=True)
    assert got.dtype == torch.bfloat16
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    limit = tref.flash_attention_bf16_tolerance(tq, tk, tv, got, causal=True)
    diff = (got.float() - torch.from_numpy(np.asarray(want, np.float32))).abs()
    assert bool((diff <= limit).all()), float((diff / limit).max())


def test_flash_attention_rejects_what_the_jax_op_rejects():
    """Sq = 200 is no multiple of bq = min(128, 200): both packages refuse it."""
    q, k, v = attention_inputs(1, 200, 200, 16, 1)
    with pytest.raises(AssertionError):
        jops.flash_attention(*map(jnp.asarray, (q, k, v)), use_pallas=True)
    with pytest.raises(ValueError, match="multiples"):
        tops.flash_attention(*map(torch.from_numpy, (q, k, v)))


# ---------------------------------------------------------------------------
# ssd_chunk
# ---------------------------------------------------------------------------


def ssd_inputs(bh, s, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bh, s, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(bh, s)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(bh,)).astype(np.float32),
            rng.normal(size=(bh, s, n)).astype(np.float32),
            rng.normal(size=(bh, s, n)).astype(np.float32))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("bh,s,p,n,chunk", [
    (2, 64, 16, 32, 16),
    (3, 128, 32, 64, 32),
    (1, 64, 64, 128, 64),
])
def test_ssd_chunk_matches_jax(bh, s, p, n, chunk, use_pallas):
    args = ssd_inputs(bh, s, p, n, bh * s + p)
    want = jops.ssd_chunk(*map(jnp.asarray, args), chunk=chunk, use_pallas=use_pallas)
    got = tops.ssd_chunk(*map(torch.from_numpy, args), chunk=chunk)
    for g, w, shape in zip(got, want, [(bh, s, p), (bh, p, n)]):
        assert g.dtype == torch.float32 and g.shape == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_ssd_chunk_rejects_a_ragged_last_chunk():
    args = ssd_inputs(1, 48, 8, 8, 2)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tops.ssd_chunk(*map(torch.from_numpy, args), chunk=32)


# ---------------------------------------------------------------------------
# Dispatch: CPU tensors run the plain versions and launch nothing
# ---------------------------------------------------------------------------


def test_library_ops_on_cpu_tensors_run_the_plain_versions():
    before = dict(_build.launches)
    keys = torch.arange(-50, 50, dtype=torch.int32)
    for g, w in zip(tops.hash_partition(keys, 5), tref.hash_partition_ref(keys, 5)):
        assert torch.equal(g, w)
    q, k, v = map(torch.from_numpy, attention_inputs(2, 64, 64, 16, 3))
    assert torch.equal(tops.flash_attention(q, k, v), tref.flash_attention_ref(q, k, v))
    args = tuple(map(torch.from_numpy, ssd_inputs(2, 32, 8, 8, 4)))
    for g, w in zip(tops.ssd_chunk(*args, chunk=16), tref.ssd_chunked_ref(*args, 16)):
        assert torch.equal(g, w)
    assert dict(_build.launches) == before
