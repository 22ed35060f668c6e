"""The comparison that decides ``correct``: an answer's rows against the
reference's, as multisets (row order is not part of a join's result)."""

from __future__ import annotations

import torch

_SPAN = 1 << 62


def _row_ids(rows: torch.Tensor) -> torch.Tensor:
    """Id of each row among the distinct rows of ``rows`` (n, k) int64."""
    if rows.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=rows.device)
    lo, hi = rows.min(0).values, rows.max(0).values
    span, key = 1, torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    for j in range(rows.shape[1]):
        width = int(hi[j]) - int(lo[j]) + 1
        span *= width
        if span >= _SPAN:
            return torch.unique(rows, dim=0, return_inverse=True)[1]
        key = key * width + (rows[:, j] - lo[j])
    return torch.unique(key, return_inverse=True)[1]


def rows_gap(got: torch.Tensor, want: torch.Tensor) -> int:
    """Size of the multiset difference between two row sets, both ways: the
    rows one side has more often than the other, summed.  0 means equal."""
    if got.dim() != 2 or got.shape[1] != want.shape[1]:
        return int(got.shape[0]) + int(want.shape[0])
    ids = _row_ids(torch.cat([got.to(torch.int64), want.to(torch.int64)]))
    n = int(ids.max()) + 1 if ids.numel() else 0
    diff = (torch.bincount(ids[: got.shape[0]], minlength=n)
            - torch.bincount(ids[got.shape[0]:], minlength=n))
    return int(diff.abs().sum())
