"""The table digest (``core/query.py`` ``table_digest``), its path choice
(``kernels/digest.py`` ``chunk_digests``) and its chunk kernel
(``kernels.ops.blake2b_chunks``).

On the CPU:

* the digest equals a Merkle tree computed here with ``hashlib`` alone:
  ``blake2b(chunk, digest_size=32)`` of every ``CHUNK``-byte chunk of the
  C-order bytes, then blake2b (16 bytes) over the dtype string, the shape's
  repr, the byte length and the chunk digests;
* one flipped bit at the first byte, a chunk's last byte, the next chunk's
  first byte or the table's last byte changes it; so do another dtype or
  shape over the same bytes; a non-contiguous view digests as its
  contiguous copy; an empty table has a digest;
* the plain chunk op equals ``hashlib`` per chunk; a CPU device, or a CUDA
  device's table under ``CARD_DIGEST_MIN_BYTES``, takes the host path and
  counts its bytes as ``host_bytes``; a CPU session counts every distinct
  bound byte under ``stats/digest:host_bytes``.

Marked ``cuda`` (skipped without a card; this file imports neither jax nor
the JAX package, so it runs on the card's machine):

    python -m pytest -q -m cuda tests/test_torch_table_digest.py

* every chunk digest the kernel writes equals ``hashlib``'s, from 0 bytes
  to past a slice and for a lineorder-shaped table (6,001,215 × 4 int64);
* the card path's table digest equals the host path's, launches the kernel
  once per slice, never reaches the plain version, and leaves
  ``torch.cuda.memory_allocated()`` as it found it;
* a CUDA session's warm submit counts the distinct bound tables' bytes at
  or above ``CARD_DIGEST_MIN_BYTES`` under ``stats/digest:card_bytes``.
"""

import hashlib
from functools import partial

import numpy as np
import pytest
import torch

from repro_torch.core.query import query_from_arrays, table_digest
from repro_torch.kernels import _build, ops
from repro_torch.kernels import digest as tdigest
from repro_torch.kernels import ref as tref
from repro_torch.kernels.digest import CARD_DIGEST_MIN_BYTES, CHUNK, SLICE, chunk_digests
from repro_torch.mpc import JoinSession
from repro_torch.spans import Trace, activate

torch.set_num_threads(1)


def tree(a: np.ndarray) -> bytes:
    """The digest's definition, from hashlib alone."""
    b = np.ascontiguousarray(a).tobytes()
    leaves = b"".join(hashlib.blake2b(b[i:i + CHUNK], digest_size=32).digest()
                      for i in range(0, len(b), CHUNK))
    h = hashlib.blake2b(digest_size=16)
    h.update(str(a.dtype).encode())
    h.update(repr(a.shape).encode())
    h.update(len(b).to_bytes(8, "little"))
    h.update(leaves)
    return h.digest()


def hashlib_chunks(b: bytes) -> np.ndarray:
    leaves = [hashlib.blake2b(b[i:i + CHUNK], digest_size=32).digest()
              for i in range(0, len(b), CHUNK)]
    return np.frombuffer(b"".join(leaves), dtype=np.uint8).reshape(-1, 32)


def table(rows: int, cols: int = 2, seed: int = 0, dtype=np.int64) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**31, (rows, cols)).astype(dtype)


def test_the_chunk_and_slice_sizes_fit_each_other():
    assert CHUNK % 128 == 0 and SLICE % CHUNK == 0


@pytest.mark.parametrize("rows,cols,dtype", [
    (1, 1, np.int64), (3, 2, np.int64), (1024, 2, np.int64), (1025, 2, np.int64),
    (5000, 4, np.int64), (7777, 3, np.int32), (100, 3, np.uint8)])
def test_digest_is_the_hashlib_tree(rows, cols, dtype):
    a = table(rows, cols, seed=rows, dtype=dtype)
    assert table_digest(a) == tree(a)
    assert table_digest(a, partial(chunk_digests, device="cpu")) == tree(a)


@pytest.mark.parametrize("where", ["first byte", "a chunk's last byte",
                                   "the next chunk's first byte", "the last byte"])
def test_one_flipped_bit_changes_the_digest(where):
    a = table(3000)                                  # 48,000 bytes: three chunks
    at = {"first byte": 0, "a chunk's last byte": CHUNK - 1,
          "the next chunk's first byte": CHUNK, "the last byte": a.nbytes - 1}[where]
    flipped = a.copy()
    flipped.view(np.uint8).reshape(-1)[at] ^= 1
    assert table_digest(flipped) != table_digest(a)
    assert table_digest(flipped) == tree(flipped)


@pytest.mark.parametrize("other", ["dtype", "shape"])
def test_the_same_bytes_under_another_dtype_or_shape_differ(other):
    a = table(3000)
    b = a.view(np.uint64) if other == "dtype" else a.reshape(1500, 4)
    assert b.tobytes() == a.tobytes()
    assert table_digest(b) != table_digest(a)


@pytest.mark.parametrize("view", ["transposed", "strided", "column"])
def test_a_non_contiguous_view_digests_as_its_contiguous_copy(view):
    a = table(4000, 4)
    v = {"transposed": a.T, "strided": a[::3], "column": a[:, 1:3]}[view]
    assert not v.flags.c_contiguous
    assert table_digest(v) == table_digest(np.ascontiguousarray(v)) == tree(v)


def test_an_empty_table_has_a_digest():
    e2, e3 = np.zeros((0, 2), np.int64), np.zeros((0, 3), np.int64)
    assert table_digest(e2) == tree(e2) and len(table_digest(e2)) == 16
    assert table_digest(e2) != table_digest(e3)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 5])
def test_plain_chunks_equal_hashlib(n):
    b = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    got = ops.blake2b_chunks(torch.from_numpy(b))
    assert got.dtype == torch.uint8 and got.shape == (-(-n // CHUNK), 32)
    assert np.array_equal(got.numpy(), hashlib_chunks(b.tobytes()))


def test_chunks_refuse_other_than_a_byte_vector():
    for bad in (torch.zeros(4, dtype=torch.int32), torch.zeros((2, 2), dtype=torch.uint8)):
        with pytest.raises(ValueError):
            ops.blake2b_chunks(bad)


@pytest.mark.parametrize("device,n_bytes", [
    ("cpu", 8), ("cpu", CARD_DIGEST_MIN_BYTES), ("cuda", 8), ("cuda", CARD_DIGEST_MIN_BYTES - 8)])
def test_the_host_path_hashes_a_cpu_device_or_a_small_table(device, n_bytes):
    """No card is touched: a CPU device, or a table under the constant."""
    a = np.random.default_rng(n_bytes).integers(0, 2**62, n_bytes // 8)
    trace = Trace("t")
    with activate(trace):
        got = chunk_digests(a.view(np.uint8), device)
    assert got == hashlib_chunks(a.tobytes()).tobytes()
    assert trace.counters == {"card_bytes": 0, "host_bytes": n_bytes}


def star(fact_rows: int, seed: int = 3):
    """A 4-ary fact table and two keyed dimensions."""
    rng = np.random.default_rng(seed)
    fact = np.stack([rng.integers(0, 300, fact_rows), rng.integers(0, 200, fact_rows),
                     rng.integers(0, 50, fact_rows), rng.integers(0, 9, fact_rows)], axis=1)
    dim = lambda k, m: np.stack([np.arange(k), np.arange(k) % m], axis=1)  # noqa: E731
    return query_from_arrays([(("c", "s", "p", "d"), fact, "F"), (("c", "cn"), dim(300, 5), "C"),
                              (("s", "sn"), dim(200, 4), "S")])


def digest_counts(res):
    return res.counters["stats/digest:card_bytes"], res.counters["stats/digest:host_bytes"]


def test_a_cpu_session_hashes_every_distinct_table_on_the_host():
    q = star(2000)
    session = JoinSession(p=8, device="cpu")
    distinct = sum({id(rel.data): rel.data.nbytes for rel in q.relations}.values())
    for _ in range(2):
        assert digest_counts(session.submit(q)) == (0, distinct)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the digest kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, CHUNK - 1, CHUNK, CHUNK + 1,
                               SLICE - 1, SLICE, SLICE + 1])
def test_kernel_chunks_equal_hashlib(cuda_device, n):
    b = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    got = ops.blake2b_chunks(torch.from_numpy(b).to(cuda_device))
    torch.cuda.synchronize()
    assert got.is_cuda and got.shape == (-(-n // CHUNK), 32)
    assert np.array_equal(got.cpu().numpy(), hashlib_chunks(b.tobytes()))


@pytest.mark.cuda
def test_kernel_chunks_of_a_lineorder_shaped_table(cuda_device):
    a = np.random.default_rng(7).integers(0, 2**31, (6_001_215, 4))
    got = ops.blake2b_chunks(torch.from_numpy(a.view(np.uint8).reshape(-1)).to(cuda_device))
    assert np.array_equal(got.cpu().numpy(), hashlib_chunks(a.tobytes()))


@pytest.mark.cuda
@pytest.mark.parametrize("n_bytes", [CARD_DIGEST_MIN_BYTES, 2 * SLICE, 2 * SLICE + 8,
                                     5 * SLICE // 2, 6_001_215 * 4 * 8])
def test_card_digest_equals_the_host_path(cuda_device, monkeypatch, n_bytes):
    a = np.random.default_rng(n_bytes).integers(0, 2**62, n_bytes // 8)
    want = table_digest(a)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    launched = _build.launches["blake2b_chunks"]

    def refuse(*args, **kwargs):
        raise AssertionError("a card digest reached the plain version")

    monkeypatch.setattr(tdigest, "host_chunk_digests", refuse)
    monkeypatch.setattr(tref, "blake2b_chunks_ref", refuse)
    assert table_digest(a, partial(chunk_digests, device=cuda_device)) == want == tree(a)
    assert _build.launches["blake2b_chunks"] - launched == -(-a.nbytes // SLICE)
    assert torch.cuda.memory_allocated() == before


@pytest.mark.cuda
def test_a_cuda_session_counts_the_large_tables_as_card_bytes(cuda_device):
    q = star(CARD_DIGEST_MIN_BYTES // 32 + 1000)
    tables = {id(rel.data): rel.data.nbytes for rel in q.relations}
    large = sum(n for n in tables.values() if n >= CARD_DIGEST_MIN_BYTES)
    assert 0 < large < sum(tables.values())
    session = JoinSession(p=8, device=cuda_device)
    cold = session.submit(q)
    launched = _build.launches["blake2b_chunks"]
    warm = session.submit(q)
    assert digest_counts(warm) == digest_counts(cold) == (large, sum(tables.values()) - large)
    assert warm.counters["stats:memo_hits"] == 1
    assert _build.launches["blake2b_chunks"] - launched == 1
    assert np.array_equal(warm.rows, JoinSession(p=8, device="cpu").submit(q).rows)
    session.close()
