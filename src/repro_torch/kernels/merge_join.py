"""Wrappers of the ``merge_join_counts`` and ``merge_join_pairs`` CUDA
kernels (csrc/merge_join.cu).

They replace the TPU kernels ``merge_join_counts_pallas`` and
``merge_join_pairs_pallas`` (src/repro/kernels/merge_join.py): the sorted
join's match-range probe and its expansion into a flat pair list, for every
segment of a batch in one call.
"""

from __future__ import annotations

import torch

from . import _build


def _require(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


#: the elements of one launch: the grid's x extent (< 2^31 blocks) at 256
#: per block.  Both launchers give a block a 2816-element stretch of a merge
#: (the counts: keys of A and B; the pairs: keys and output slots, plus the
#: slots past the last key's start) and refuse a grid past 2^31 - 1 blocks,
#: which the wrapper then raises
MAX_THREADS = 256 * (2**31 - 1)


def _check_pair(x: torch.Tensor, y: torch.Tensor, name: str) -> None:
    _require(x.is_cuda and y.device == x.device, name, "tensors must share one CUDA device")
    _require(x.dtype == torch.int32 and y.dtype == torch.int32, name, "tensors must be int32")
    _require(x.dim() == 2 and y.dim() == 2 and x.shape[0] == y.shape[0], name,
             "want (S, N) and (S, M) tensors")
    _require(x.is_contiguous() and y.is_contiguous(), name, "tensors must be contiguous")
    _require(max(x.shape + y.shape) < 2**31, name, "dimensions must fit int32")


def merge_join_counts_cuda(a_keys: torch.Tensor, b_keys: torch.Tensor):
    """a_keys (S, N), b_keys (S, M) int32, rows sorted ascending →
    (lower, upper) (S, N) int32."""
    _check_pair(a_keys, b_keys, "merge_join_counts")
    s, n = a_keys.shape
    m = b_keys.shape[1]
    _require(s * n < MAX_THREADS, "merge_join_counts", "batch too large for one launch")
    lower = torch.empty_like(a_keys)
    upper = torch.empty_like(a_keys)
    if s * n == 0:                  # nothing to compute: no launch, no count
        return lower, upper
    fn = _build.launcher("merge_join_counts_launch")
    stream = torch.cuda.current_stream(a_keys.device).cuda_stream
    rc = fn(a_keys.data_ptr(), b_keys.data_ptr(), s, n, m,
            lower.data_ptr(), upper.data_ptr(), stream)
    _build.launched("merge_join_counts", rc)
    return lower, upper


def merge_join_pairs_cuda(lower: torch.Tensor, starts: torch.Tensor, cap_out: int):
    """lower, starts (S, N) int32 with N >= 1 → (a_idx, b_idx) (S, cap_out)
    int32 (see ``ref.merge_join_pairs_ref`` for the slot semantics)."""
    _check_pair(lower, starts, "merge_join_pairs")
    _require(lower.shape == starts.shape and starts.shape[1] >= 1, "merge_join_pairs",
             "want lower and starts of one shape (S, N), N >= 1")
    s, n = starts.shape
    _require(0 <= cap_out < 2**31 and s * cap_out < MAX_THREADS, "merge_join_pairs",
             "cap_out too large for one launch")
    a_idx = torch.empty((s, cap_out), dtype=torch.int32, device=starts.device)
    b_idx = torch.empty_like(a_idx)
    if s * cap_out == 0:            # nothing to compute: no launch, no count
        return a_idx, b_idx
    fn = _build.launcher("merge_join_pairs_launch")
    stream = torch.cuda.current_stream(starts.device).cuda_stream
    rc = fn(lower.data_ptr(), starts.data_ptr(), s, n, cap_out,
            a_idx.data_ptr(), b_idx.data_ptr(), stream)
    _build.launched("merge_join_pairs", rc)
    return a_idx, b_idx
