"""The hand-written CUDA kernels ≡ their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA card every test here skips (the kernels
have no CPU form).  The file imports neither jax nor the JAX package, so it
runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import hash_partition as thp
from repro_torch.kernels import merge_join as tmj
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
    got = thp.hash_partition_pack_cuda(k, c, parts)
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


@pytest.mark.cuda
def test_launch_counters_skip_calls_with_no_work(cuda_device):
    """A wrapper counts only calls that launched its kernel."""
    i32 = dict(dtype=torch.int32, device=cuda_device)
    before = (thp.launches, tmj.counts_launches, tmj.pairs_launches)
    part, slot, send = thp.hash_partition_pack_cuda(torch.empty((0, 64), **i32),
                                                    torch.empty((0,), **i32), 8)
    assert part.shape == (0, 64) and send.shape == (0, 8)
    lower, _ = tmj.merge_join_counts_cuda(torch.empty((4, 0), **i32),
                                          torch.zeros((4, 16), **i32))
    assert lower.shape == (4, 0)
    a_idx, _ = tmj.merge_join_pairs_cuda(torch.zeros((4, 16), **i32),
                                         torch.zeros((4, 16), **i32), 0)
    assert a_idx.shape == (4, 0)
    assert (thp.launches, tmj.counts_launches, tmj.pairs_launches) == before
    # N = 0 with segments still launches the scan pass: zero send counts
    _, _, send = thp.hash_partition_pack_cuda(torch.empty((3, 0), **i32),
                                              torch.zeros((3,), **i32), 8)
    assert thp.launches == before[0] + 1
    assert torch.equal(send.cpu(), torch.zeros((3, 8), dtype=torch.int32))
