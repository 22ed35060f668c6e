"""Distributed equi-join among p machines on one device: exchange + local
sorted join.

The local primitives (`local_sorted_join`, `local_semijoin`, `local_unique`,
`local_join_count`, `local_join_filtered`) work on a leading segment axis —
one segment per (stage, machine) pair — and run on the ``merge_join_counts``
and ``merge_join_pairs`` kernels.  The ``batched_sharded_*`` functions lower
the round-program ops for s stages of p machines at once, (s, p, ...) stacks
in and out, around the capacity-padded `batched_hash_exchange`.

Each ``batched_sharded_*`` function returns ``(fn, args)`` instead of running
when called with ``invoke=False`` (the executor's scheduler builds a bucket's
call, then launches it); ``fn(*args)`` moves host arrays to ``device`` and
runs.

Overflow contract: every sharded primitive returns ``ovf`` of shape
(s, p, 2) — column 0 counts *slot* (routing-buffer) overflow, column 1
*output* overflow — so the executor's retry can grow only the capacity that
actually overflowed.

Device word contract: values are int32 with INT32_MAX reserved as the padding
sentinel (same convention as the kernels)."""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.ops import merge_join_counts, merge_join_pairs
from ..spans import count
from .exchange import batched_hash_exchange, scatter_rows, valid_mask

BIG = 2**31 - 1


def _big_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, BIG)


def take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per segment gather: rows (S, cap, ...) and idx (S, n) → (S, n, ...)."""
    s, cap = rows.shape[:2]
    flat = (torch.arange(s, device=rows.device)[:, None] * cap + idx.to(torch.int64)).reshape(-1)
    return rows.reshape((s * cap,) + tuple(rows.shape[2:]))[flat].reshape(
        (s, idx.shape[1]) + tuple(rows.shape[2:])
    )


def local_sorted_join(
    a_rows: torch.Tensor, a_count: torch.Tensor,   # (S, capA, wa): key in col ka
    b_rows: torch.Tensor, b_count: torch.Tensor,   # (S, capB, wb): key in col kb
    ka: int, kb: int, cap_out: int,
    a_keys: Optional[torch.Tensor] = None,         # optional precomputed (S, capA)
    b_keys: Optional[torch.Tensor] = None,         # join keys (pads may be any value)
    b_cols: Optional[Sequence[int]] = None,        # B's columns to emit
):
    """→ (out (S, cap_out, wa+len(b_cols)), count (S,), overflow (S,)).  Key
    written once: A's columns, then ``b_cols`` (default: B's non-key
    columns); only those are gathered from B, and the output is masked in
    place.  ``a_keys``/``b_keys`` override the key columns (composite-key
    joins pass folded keys)."""
    s, capa, _ = a_rows.shape
    _, capb, wb = b_rows.shape
    dev = a_rows.device
    a_keys = a_rows[:, :, ka] if a_keys is None else a_keys
    b_keys = b_rows[:, :, kb] if b_keys is None else b_keys
    a_keys = torch.where(valid_mask(capa, a_count), a_keys, _big_like(a_keys))
    b_keys = torch.where(valid_mask(capb, b_count), b_keys, _big_like(b_keys))
    a_k, a_ord = torch.sort(a_keys, dim=1, stable=True)
    b_k, b_ord = torch.sort(b_keys, dim=1, stable=True)

    lower, upper = merge_join_counts(a_k.contiguous(), b_k.contiguous())
    # sentinel keys must not match each other
    counts = torch.where(a_k < BIG, upper - lower, torch.zeros_like(lower)).to(torch.int64)
    starts = (torch.cumsum(counts, dim=1) - counts).to(torch.int32)   # output offset per a-row
    total = counts.sum(dim=1)
    overflow = (total - cap_out).clamp(min=0).to(torch.int32)

    # range expansion: out row t ← a_idx(t) = max{i : starts[i] <= t},
    # b_idx(t) = lower[a_idx] + (t - starts[a_idx])
    a_idx, b_idx = merge_join_pairs(lower, starts, cap_out)
    b_idx = b_idx.clamp(0, capb - 1)
    t = torch.arange(cap_out, device=dev)[None, :]
    n_valid = total.clamp(max=cap_out)
    valid = t < n_valid[:, None]

    # gather output rows through the sort permutation (composed index gathers)
    out = take_rows(a_rows, a_ord.gather(1, a_idx.to(torch.int64)))
    b_cols = [c for c in range(wb) if c != kb] if b_cols is None else list(b_cols)
    if b_cols:
        b_part = take_rows(b_rows[:, :, b_cols], b_ord.gather(1, b_idx.to(torch.int64)))
        out = torch.cat([out, b_part], dim=2)
        del b_part
    out.masked_fill_(~valid[:, :, None], 0)
    return out, n_valid.to(torch.int32), overflow


def _compact_prefix(rows: torch.Tensor, keep: torch.Tensor):
    """Per segment: stable-compact kept rows (S, cap, ...) to a zero-padded
    valid prefix → (rows, counts (S,) int32)."""
    s, cap = keep.shape
    cnt = keep.sum(dim=1).to(torch.int32)
    seg = torch.arange(s, device=keep.device)[:, None]
    dest = torch.where(keep, seg * cap + torch.cumsum(keep, dim=1) - 1,
                       torch.full((s, cap), s * cap, device=keep.device, dtype=torch.int64))
    flat = rows.reshape((s * cap,) + tuple(rows.shape[2:]))
    return scatter_rows(flat, dest.reshape(-1), s * cap).reshape(rows.shape), cnt


def local_unique(vals: torch.Tensor, count: torch.Tensor):
    """(S, cap) padded value lists → sorted distinct values in a valid prefix."""
    s, cap = vals.shape
    v = torch.sort(torch.where(valid_mask(cap, count), vals, _big_like(vals)), dim=1).values
    first = torch.ones_like(v, dtype=torch.bool)
    first[:, 1:] = v[:, 1:] != v[:, :-1]
    return _compact_prefix(v, first & (v < BIG))


def local_semijoin(rows: torch.Tensor, count: torch.Tensor, col: int,
                   keys: torch.Tensor, kcount: torch.Tensor):
    """Per segment: keep rows (S, cap, w) whose rows[:, :, col] appears in
    keys[:, :kcount].  Output rows are reordered by key and compacted to a
    valid prefix (multiset semantics).  Each key-sized temporary goes as soon
    as it is used: the compaction, where the device holds the most, keeps
    only the sorted rows and the membership mask."""
    s, cap, _ = rows.shape
    capk = keys.shape[1]
    rk = rows[:, :, col]
    rk = torch.where(valid_mask(cap, count), rk, _big_like(rk))
    rk_s, order = torch.sort(rk, dim=1, stable=True)
    del rk
    rows_s = take_rows(rows, order)
    del order
    kv = torch.sort(torch.where(valid_mask(capk, kcount), keys, _big_like(keys)), dim=1).values
    lower, upper = merge_join_counts(rk_s.contiguous(), kv.contiguous())
    member = (upper > lower) & (rk_s < BIG)
    del lower, upper, rk_s, kv
    return _compact_prefix(rows_s, member)


def _composite_rank_keys(a_cols: Sequence[torch.Tensor], a_valid: torch.Tensor,
                         b_cols: Sequence[torch.Tensor], b_valid: torch.Tensor):
    """Per segment dense lexicographic rank of key *tuples* across both sides.

    Equal tuples (on either side) get equal ranks, so a single-column sorted
    join on the ranks is exactly the multi-column equi-join.  Ranks fit int32
    (< capA + capB); invalid rows sort last."""
    na = a_valid.shape[1]
    valid = torch.cat([a_valid, b_valid], dim=1)
    cols = []
    for ac, bc in zip(a_cols, b_cols):
        c = torch.cat([ac, bc], dim=1)
        cols.append(torch.where(valid, c, _big_like(c)))
    # lexicographic order: stable sorts from the least significant column up
    order = torch.arange(valid.shape[1], device=valid.device).expand_as(valid)
    for c in reversed(cols):
        _, o = torch.sort(c.gather(1, order), dim=1, stable=True)
        order = order.gather(1, o)
    scols = [c.gather(1, order) for c in cols]
    first = torch.ones_like(valid)
    diff = scols[0][:, 1:] != scols[0][:, :-1]
    for c in scols[1:]:
        diff = diff | (c[:, 1:] != c[:, :-1])
    first[:, 1:] = diff
    gid = (torch.cumsum(first, dim=1) - 1).to(torch.int32)
    ranks = torch.empty_like(gid).scatter_(1, order, gid)
    return ranks[:, :na], ranks[:, na:]


def _packed_keys(rows: torch.Tensor, cols: Sequence[int], mults: torch.Tensor) -> torch.Tensor:
    """Mixed-radix int32 packing of the key tuple rows[:, :, cols] per
    segment: key = ((c0·m0 + c1)·m1 + c2)···, with ``mults`` (S, len(cols)-1)
    the per-position radices.  Collision-free iff every value is in [0, m_i)
    and the radix product stays below 2^31 — the executor's host-side
    eligibility check."""
    k = rows[:, :, cols[0]].to(torch.int32)
    for i, c in enumerate(cols[1:]):
        k = k * mults[:, i, None] + rows[:, :, c].to(torch.int32)
    return k


def _folded_keys(a_rows, a_count, b_rows, b_count, ka, kb, dup_pairs, key_mults):
    """Join keys of both sides with the ``dup_pairs`` attributes folded in."""
    if key_mults is not None:
        return (
            _packed_keys(a_rows, [ka] + [ca for ca, _ in dup_pairs], key_mults),
            _packed_keys(b_rows, [kb] + [cb for _, cb in dup_pairs], key_mults),
        )
    return _composite_rank_keys(
        [a_rows[:, :, ka]] + [a_rows[:, :, ca] for ca, _ in dup_pairs],
        valid_mask(a_rows.shape[1], a_count),
        [b_rows[:, :, kb]] + [b_rows[:, :, cb] for _, cb in dup_pairs],
        valid_mask(b_rows.shape[1], b_count),
    )


def local_join_count(a_rows, a_count, b_rows, b_count, ka: int, kb: int,
                     dup_pairs: Tuple[Tuple[int, int], ...] = (),
                     key_mults: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact per-segment match count (S,) int32 of `local_join_filtered` — no
    expansion, no row gathers (keys only).  The executor's count-then-emit
    pass runs this to size the emit's cap_out exactly."""
    if not dup_pairs:
        a_keys, b_keys = a_rows[:, :, ka], b_rows[:, :, kb]
    else:
        a_keys, b_keys = _folded_keys(a_rows, a_count, b_rows, b_count, ka, kb,
                                      dup_pairs, key_mults)
    a_keys = torch.where(valid_mask(a_rows.shape[1], a_count), a_keys, _big_like(a_keys))
    b_keys = torch.where(valid_mask(b_rows.shape[1], b_count), b_keys, _big_like(b_keys))
    a_k = torch.sort(a_keys, dim=1).values
    b_k = torch.sort(b_keys, dim=1).values
    lower, upper = merge_join_counts(a_k.contiguous(), b_k.contiguous())
    matches = torch.where(a_k < BIG, upper - lower, torch.zeros_like(lower))
    return matches.sum(dim=1).to(torch.int32)


def local_join_filtered(a_rows, a_count, b_rows, b_count, ka: int, kb: int, cap_out: int,
                        dup_pairs: Tuple[Tuple[int, int], ...] = (),
                        key_mults: Optional[torch.Tensor] = None):
    """`local_sorted_join` with duplicated attributes folded into the key.

    ``dup_pairs`` lists (a_col, b_col) pairs (b_col ≠ kb) of attributes shared
    beyond the join key.  The full key tuple is folded to one int32 key —
    mixed-radix *packing* when ``key_mults`` is given (the executor checked
    the key space fits int32), dense lexicographic *ranking* otherwise — so
    ``cap_out`` meters only true matches.  Output scheme is A's columns then
    B's columns minus kb and minus the dup b_cols.

    Where every column of B is in the folded key and B is a set (a routed
    relation), each A row matches at most one B row: the level is a
    semijoin, and it emits the kept A rows in their stable key order
    without gathering anything of B."""
    if not dup_pairs:
        return local_sorted_join(a_rows, a_count, b_rows, b_count, ka, kb, cap_out)
    wb = b_rows.shape[2]
    a_keys, b_keys = _folded_keys(a_rows, a_count, b_rows, b_count, ka, kb,
                                  dup_pairs, key_mults)
    dup_b = {cb for _, cb in dup_pairs}
    return local_sorted_join(
        a_rows, a_count, b_rows, b_count, ka, kb, cap_out, a_keys=a_keys, b_keys=b_keys,
        b_cols=[c for c in range(wb) if c != kb and c not in dup_b],
    )


# ---------------------------------------------------------------------------
# Stage-batched sharded primitives: (s, p, ...) in, (s, p, ...) out
# ---------------------------------------------------------------------------


def infer_device(device, *xs) -> torch.device:
    """``device`` when given, else the device of the first tensor in ``xs``."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("host (numpy) inputs need an explicit device=")


def to_dev(x, device: torch.device) -> torch.Tensor:
    """Host array or tensor → tensor on ``device`` (int dtypes kept).  A
    host array's bytes count as ``h2d_bytes`` of the innermost span, whatever
    the device."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.ascontiguousarray(x)
    count("h2d_bytes", a.nbytes)
    return torch.from_numpy(a).to(device)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(s, p, ...) → (s·p, ...)."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def _per_segment(x: torch.Tensor, p: int) -> torch.Tensor:
    """Per-stage values (s, ...) repeated for each of the p machines → (s·p, ...)."""
    return x.repeat_interleave(p, dim=0)


def _intersect(offs, *flat, cap_slot: int, cap_out: int, device):
    offs = to_dev(offs, device)
    s = offs.shape[0]
    ovf_slot = ovf_out = None
    cur = cur_cnt = None
    for i in range(len(flat) // 2):
        v, c = to_dev(flat[2 * i], device), to_dev(flat[2 * i + 1], device)
        p = v.shape[1]
        ex, exc, o_s, o_o = batched_hash_exchange(v[..., None], c, 0, cap_slot, cap_out, offs)
        ovf_slot = o_s if ovf_slot is None else ovf_slot + o_s
        ovf_out = o_o if ovf_out is None else ovf_out + o_o
        uv, uc = local_unique(_flat(ex[..., 0]), _flat(exc))
        if cur is None:
            cur, cur_cnt = uv, uc
        else:
            kept, kc = local_semijoin(cur[..., None], cur_cnt, 0, uv, uc)
            cur, cur_cnt = kept[..., 0], kc
    ovf = torch.stack([ovf_slot, ovf_out], dim=-1)
    return cur.reshape(s, p, cap_out), cur_cnt.reshape(s, p), ovf


def batched_sharded_intersect(pieces, offs, cap_slot: int, cap_out: int,
                              device=None, invoke: bool = True):
    """Distributed intersection of unary relations (the R''_X(η) step, the
    HashPartition op) for s stages: every piece [(vals (s, p, cap_i),
    counts (s, p))] is hash-exchanged on its value with the stage's salt
    offset ``offs`` (s,), deduplicated, and intersected locally.  Returns
    (vals (s, p, cap_out), counts (s, p), ovf (s, p, 2)), distributed by
    hash(value, salt); ``invoke=False`` returns ``(fn, args)``."""
    args = [offs]
    for pv, pc in pieces:
        args += [pv, pc]
    fn = partial(_intersect, cap_slot=cap_slot, cap_out=cap_out,
                 device=infer_device(device, *args))
    return (fn, tuple(args)) if not invoke else fn(*args)


def _semijoin(rows, cnt, offs, pv, pc, *, col: int, cap_slot: int, cap_out: int, device):
    rows, cnt, offs, pv, pc = (to_dev(x, device) for x in (rows, cnt, offs, pv, pc))
    s, p = cnt.shape
    rows, cnt, o_s, o_o = batched_hash_exchange(rows, cnt, col, cap_slot, cap_out, offs)
    kept, kc = local_semijoin(_flat(rows), _flat(cnt), col, _flat(pv), _flat(pc))
    ovf = torch.stack([o_s, o_o], dim=-1)
    return kept.reshape(rows.shape), kc.reshape(s, p), ovf


def batched_sharded_semijoin(rows, counts, col: int, offs, piece_vals, piece_counts,
                             cap_slot: int, cap_out: int, device=None, invoke: bool = True):
    """Semi-join s stages of a relation (s, p, cap, w) against co-located
    unary pieces (s, p, capx): each stage's rows are hash-exchanged on ``col``
    with its piece's salt offset ``offs`` (s,) — so rows land where the
    piece lives — and filtered by membership (the SemiJoin op).  Returns
    (rows (s, p, cap_out, w), counts (s, p), ovf (s, p, 2));
    ``invoke=False`` returns ``(fn, args)``."""
    args = (rows, counts, offs, piece_vals, piece_counts)
    fn = partial(_semijoin, col=col, cap_slot=cap_slot, cap_out=cap_out,
                 device=infer_device(device, *args))
    return (fn, args) if not invoke else fn(*args)


def _colocated(a, ac, b, bc, mults, *, ka, kb, cap_out, dup_pairs, packed, count, device):
    a, ac, b, bc = (to_dev(x, device) for x in (a, ac, b, bc))
    s, p = ac.shape
    km = _per_segment(to_dev(mults, device), p) if packed else None
    if count:
        cnt = local_join_count(_flat(a), _flat(ac), _flat(b), _flat(bc), ka, kb,
                               dup_pairs, km)
        return cnt.reshape(s, p), torch.zeros((s, p, 2), dtype=torch.int32, device=device)
    out, cnt, ovf = local_join_filtered(_flat(a), _flat(ac), _flat(b), _flat(bc), ka, kb,
                                        cap_out, dup_pairs, km)
    # no exchange ⇒ no slot channel; only output capacity can overflow
    ovf2 = torch.stack([torch.zeros_like(ovf), ovf], dim=-1)
    return out.reshape((s, p) + tuple(out.shape[1:])), cnt.reshape(s, p), ovf2.reshape(s, p, 2)


def batched_sharded_colocated_join(a_global, a_counts, b_global, b_counts, ka: int, kb: int,
                                   cap_out: int, dup_pairs: Tuple[Tuple[int, int], ...] = (),
                                   key_mults=None, device=None, invoke: bool = True):
    """Communication-free per-cell joins (the LocalJoin op) for s stages:
    blocks (s, p, cap, w) whose cells are already co-located.  ``key_mults``
    (s, ndup) int32 selects the packed composite-key path.  Returns
    (out (s, p, cap_out, w), counts (s, p), ovf (s, p, 2));
    ``invoke=False`` returns ``(fn, args)``."""
    packed = key_mults is not None
    mults = key_mults if packed else np.zeros((1, 1), np.int32)
    args = (a_global, a_counts, b_global, b_counts, mults)
    fn = partial(_colocated, ka=ka, kb=kb, cap_out=cap_out, dup_pairs=tuple(dup_pairs),
                 packed=packed, count=False, device=infer_device(device, *args))
    return (fn, args) if not invoke else fn(*args)


def batched_sharded_colocated_join_count(a_global, a_counts, b_global, b_counts,
                                         ka: int, kb: int,
                                         dup_pairs: Tuple[Tuple[int, int], ...] = (),
                                         key_mults=None, device=None, invoke: bool = True):
    """Count-only twin of `batched_sharded_colocated_join`: the exact
    per-machine match totals (s, p) with no expansion, so the executor can
    size the emit pass's cap_out exactly.  Returns (counts (s, p),
    ovf (s, p, 2) structurally zero); ``invoke=False`` → ``(fn, args)``."""
    packed = key_mults is not None
    mults = key_mults if packed else np.zeros((1, 1), np.int32)
    args = (a_global, a_counts, b_global, b_counts, mults)
    fn = partial(_colocated, ka=ka, kb=kb, cap_out=0, dup_pairs=tuple(dup_pairs),
                 packed=packed, count=True, device=infer_device(device, *args))
    return (fn, args) if not invoke else fn(*args)
