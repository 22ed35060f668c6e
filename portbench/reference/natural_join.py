"""Plain natural join of sets of rows: the reference every join cell is held to.

PyTorch only; it imports nothing of the program and takes only the rows the
benchmark made.  Each relation is a set (repeated rows count once), the
relations are joined left to right on their shared attribute names, and the
result's columns are the attributes in sorted order.  Rows are expanded in
blocks of at most ``block_rows`` so that a large intermediate fits.

``dtype`` is the width keys are held in: the reference's own is int64; the
benchmark's control passes a narrower one (values wrap, as a narrowed key
column would) and widens the result back to int64.
"""

from __future__ import annotations

import numpy as np
import torch

#: largest product of the key ranges one composite key may span
_KEY_SPAN = 1 << 62


def _composite_key(cols, bounds):
    """Mixed-radix key of ``cols`` over ``bounds`` [(lo, span)]; rows outside
    the bounds get -1."""
    key = torch.zeros(cols[0].shape[0], dtype=torch.int64, device=cols[0].device)
    inside = torch.ones_like(key, dtype=torch.bool)
    for c, (lo, span) in zip(cols, bounds):
        inside &= (c >= lo) & (c < lo + span)
        key = key * span + (c - lo)
    return torch.where(inside, key, torch.full_like(key, -1))


class _Right:
    """One relation prepared for probing: rows sorted by the key of the
    attributes it shares with what is joined so far."""

    def __init__(self, scheme, rows, shared):
        self.rows = rows
        self.shared = [scheme.index(a) for a in shared]
        self.new = [i for i, a in enumerate(scheme) if a not in shared]
        cols = [rows[:, i] for i in self.shared]
        self.bounds, span = [], 1
        for c in cols:
            lo, hi = (int(c.min()), int(c.max())) if c.numel() else (0, 0)
            self.bounds.append((lo, hi - lo + 1))
            span *= hi - lo + 1
        if span >= _KEY_SPAN:
            raise NotImplementedError("shared attributes span more than 2^62 keys")
        key = _composite_key(cols, self.bounds) if cols else torch.zeros(
            rows.shape[0], dtype=torch.int64, device=rows.device)
        self.order = torch.argsort(key, stable=True)
        self.keys = key[self.order]

    def matches(self, left_cols):
        """(lower, count) of each left row's range in ``order``."""
        key = _composite_key(left_cols, self.bounds)
        lower = torch.searchsorted(self.keys, key, side="left")
        return lower, torch.searchsorted(self.keys, key, side="right") - lower


def _join_from(rows, attrs, rights, block_rows, out):
    """Join ``rows`` (over ``attrs``) with every relation in ``rights`` in
    turn, appending finished rows to ``out`` block by block."""
    if not rights:
        out.append(rows)
        return
    (scheme, right), rest = rights[0], rights[1:]
    if rows.shape[0] == 0:
        return
    left_cols = [rows[:, attrs.index(scheme[i])] for i in right.shared]
    if not left_cols:
        lower = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
        count = torch.full_like(lower, right.rows.shape[0])
    else:
        lower, count = right.matches(left_cols)
    ends = torch.cumsum(count, 0)
    next_attrs = attrs + [scheme[i] for i in right.new]
    start = 0
    n = rows.shape[0]
    while start < n:
        base = int(ends[start - 1]) if start else 0
        # the longest run of left rows whose expansion stays within the block
        stop = int(torch.searchsorted(ends, base + block_rows, side="right"))
        stop = min(n, max(stop, start + 1))
        cnt = count[start:stop]
        total = int(ends[stop - 1]) - base
        if total:
            rep = torch.repeat_interleave(torch.arange(stop - start, device=rows.device), cnt)
            first = torch.cumsum(cnt, 0) - cnt
            ridx = right.order[lower[start:stop][rep] + torch.arange(total, device=rows.device)
                               - first[rep]]
            joined = torch.cat([rows[start:stop][rep], right.rows[ridx][:, right.new]], dim=1)
            _join_from(joined, next_attrs, rest, block_rows, out)
        start = stop


def join(relations, device, dtype=torch.int64, block_rows: int = 1 << 25):
    """``relations``: [(scheme, (n, arity) integer rows)] → (attributes in
    sorted order, (rows, len(attributes)) int64 tensor on ``device``)."""
    sets = []
    for scheme, rows in relations:
        t = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=device)
        t = t.reshape(-1, len(scheme)).to(dtype).to(torch.int64)
        sets.append((tuple(scheme), torch.unique(t, dim=0)))
    (scheme0, rows0), others = sets[0], sets[1:]
    attrs = list(scheme0)
    rights = []
    seen = set(attrs)
    for scheme, rows in others:
        rights.append((scheme, _Right(scheme, rows, [a for a in scheme if a in seen])))
        seen.update(scheme)
    out = []
    _join_from(rows0, attrs, rights, block_rows, out)
    final_attrs = list(dict.fromkeys(a for scheme, _ in sets for a in scheme))
    result = torch.cat(out) if out else torch.zeros((0, len(final_attrs)), dtype=torch.int64,
                                                    device=device)
    order = sorted(range(len(final_attrs)), key=lambda i: final_attrs[i])
    return [final_attrs[i] for i in order], result[:, order]
