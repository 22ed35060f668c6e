"""Capacity-padded hash exchange among p machines held on one device.

The p machines of the MPC model are a leading tensor axis: machine i's
relation block is ``rows[i] (cap_in, w)`` with its first ``counts[i]`` rows
valid.  The exchange:
  1. partition ids, send slots and send counts via the ``hash_partition_pack``
     kernel (shared-seed hashing ⇒ every machine agrees, the paper's
     footnote-2 common randomness);
  2. rows placed into a (p_src, p_dst, cap_slot, w) send buffer;
  3. the all-to-all is a transpose of the first two axes;
  4. received (p_dst, p_src, cap_slot, w) + per-source counts compacted back
     to (cap_out, w) per machine.

Every function takes a leading segment axis: ``batched_*`` functions work on
(s, p, ...) stacks of s independent stages, which share one call.

Capacity: cap_slot = c·ceil(cap_in/P) with slack c.  Overflow is *detected and
returned*, never silently dropped — the executor's retry doubles capacity.
Overflow is reported on two separate channels so the retry can scale only the
buffer that actually overflowed:

  * *slot* overflow — a destination's send slot exceeded ``cap_slot``;
  * *out* overflow — the compacted receive side exceeded ``cap_out``."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels.ops import hash_partition_pack
from ..kernels.ref import stable_rank, wrap_i32
from ..spans import count

INT32 = np.iinfo(np.int32)


def blockify(rows, p: int, cap: Optional[int] = None):
    """Host-side staging: split an (n, w) array into evenly spread per-machine
    blocks.  Returns numpy (blocks (p, cap, w) int32, counts (p,) int32).
    Values must fit int32 (the device word contract; INT32_MAX is reserved)."""
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows.reshape(-1, 1)
    n, w = rows.shape
    if n and (rows.max() >= INT32.max or rows.min() < INT32.min):
        raise ValueError("values exceed the int32 device word contract")
    per = -(-n // p) if n else 0
    if cap is None:
        cap = max(1, per)
    if per > cap:
        raise ValueError(f"cap {cap} < required {per}")
    blocks = np.zeros((p, cap, w), np.int32)
    counts = np.zeros((p,), np.int32)
    for i in range(p):
        part = rows[i * per : (i + 1) * per]
        blocks[i, : len(part)] = part
        counts[i] = len(part)
    return blocks, counts


def to_host(x) -> np.ndarray:
    """Tensor (any device) or array → numpy.  A tensor's bytes count as
    ``d2h_bytes`` of the innermost span, whatever its device."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    a = x.cpu().numpy()
    count("d2h_bytes", a.nbytes)
    return a


def unblockify(blocks, counts) -> np.ndarray:
    """Inverse of `blockify`: concatenate the valid prefixes of all machine
    blocks into one (n, w) int64 numpy array."""
    b, c = to_host(blocks), to_host(counts)
    parts = [b[i, : int(c[i])] for i in range(b.shape[0])]
    out = np.concatenate(parts, axis=0) if parts else np.zeros((0, b.shape[2]), b.dtype)
    return out.astype(np.int64)


def spread_rows(rows: torch.Tensor, p: int, cap: int):
    """Device twin of `blockify`: (n, w) rows, on their device → (blocks
    (p, cap, w) int32, counts (p,) int32) there.  Machine i holds rows
    [i·per, (i+1)·per), per = ceil(n/p), behind zero padding, exactly as
    `blockify` lays them out; the values are taken as int32 unchecked."""
    n, w = rows.shape
    per = -(-n // p) if n else 0
    if per > cap:
        raise ValueError(f"cap {cap} < required {per}")
    dev = rows.device
    blocks = torch.zeros((p, cap, w), dtype=torch.int32, device=dev)
    if n:
        full, rest = divmod(n, per)
        blocks[:full, :per] = rows[: full * per].reshape(full, per, w)
        if rest:
            blocks[full, :rest] = rows[full * per:]
    counts = (n - per * torch.arange(p, device=dev)).clamp(0, per).to(torch.int32)
    return blocks, counts


def valid_rows(blocks: torch.Tensor, counts: torch.Tensor, n: int) -> torch.Tensor:
    """Device twin of `unblockify`: the valid prefixes of blocks (p, cap, w)
    in machine order → (n, w), gathered where the blocks live, dtype kept.
    ``n`` is the sum of ``counts``, which the caller knows; the blocks may be
    a strided view."""
    dev = blocks.device
    counts = counts.to(device=dev, dtype=torch.int64)
    machine = torch.repeat_interleave(torch.arange(blocks.shape[0], device=dev), counts,
                                      output_size=n)
    starts = torch.cumsum(counts, 0) - counts
    return blocks[machine, torch.arange(n, device=dev) - starts[machine]]


def valid_mask(cap: int, counts: torch.Tensor) -> torch.Tensor:
    """(S,) counts → (S, cap) bool mask of each segment's valid prefix."""
    return torch.arange(cap, device=counts.device)[None, :] < counts.to(torch.int64)[:, None]


def scatter_rows(src: torch.Tensor, dest: torch.Tensor, n_out: int) -> torch.Tensor:
    """Write the rows of ``src`` (n, ...) to positions ``dest`` (n,) in
    [0, n_out] of a zero (n_out, ...) buffer; destination ``n_out`` is a trash
    row that drops its rows — the ``mode="drop"`` scatter of the reference."""
    out = torch.zeros((n_out + 1,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    out[dest] = src
    return out[:n_out]


def pack_by_partition(
    rows: torch.Tensor, counts: torch.Tensor, part: torch.Tensor, n_parts: int,
    cap_slot: int, slot: Optional[torch.Tensor] = None,
    send_counts: Optional[torch.Tensor] = None,
):
    """Per segment: rows (S, cap, w), counts (S,), part (S, cap) →
    (send (S, P, cap_slot, w), send_counts (S, P), overflow (S,)).
    Rows beyond a destination's cap_slot overflow (counted, not sent).

    A row's slot is its stable rank among same-destination rows; when the
    ``hash_partition_pack`` kernel already produced (slot, send_counts) they
    are taken as they are, else a stable sort ranks the rows."""
    s, cap, w = rows.shape
    dev = rows.device
    if slot is None:
        part = torch.where(valid_mask(cap, counts), part, torch.full_like(part, n_parts))
        slot = stable_rank(part, n_parts + 1)
        hist = torch.zeros((s, n_parts + 1), dtype=torch.int64, device=dev)
        hist.scatter_add_(1, part.to(torch.int64), torch.ones_like(part, dtype=torch.int64))
        send_counts = hist[:, :n_parts].to(torch.int32)
    overflow = (send_counts - cap_slot).clamp(min=0).sum(dim=1).to(torch.int32)
    keep = (part < n_parts) & (slot < cap_slot)
    seg = torch.arange(s, device=dev)[:, None]
    n_out = s * n_parts * cap_slot
    dest = (seg * n_parts + part.to(torch.int64)) * cap_slot + slot.to(torch.int64)
    dest = torch.where(keep, dest, torch.full_like(dest, n_out))
    send = scatter_rows(rows.reshape(s * cap, w), dest.reshape(-1), n_out)
    return (send.reshape(s, n_parts, cap_slot, w), send_counts.clamp(max=cap_slot),
            overflow)


def compact(recv: torch.Tensor, recv_counts: torch.Tensor, cap_out: int):
    """Per segment: (S, P, cap_slot, w) + (S, P) → (out (S, cap_out, w),
    total (S,), overflow (S,)).  Each valid row goes to its rank among valid
    rows (stable); rows past cap_out are dropped and counted."""
    s, p, cap_slot, w = recv.shape
    dev = recv.device
    valid = torch.arange(cap_slot, device=dev)[None, None, :] < recv_counts.to(torch.int64)[:, :, None]
    vflat = valid.reshape(s, p * cap_slot)
    total = vflat.sum(dim=1)
    overflow = (total - cap_out).clamp(min=0).to(torch.int32)
    rank = torch.cumsum(vflat, dim=1) - 1
    seg = torch.arange(s, device=dev)[:, None]
    n_out = s * cap_out
    dest = torch.where(vflat & (rank < cap_out), seg * cap_out + rank,
                       torch.full_like(rank, n_out))
    out = scatter_rows(recv.reshape(s * p * cap_slot, w), dest.reshape(-1), n_out)
    return out.reshape(s, cap_out, w), total.clamp(max=cap_out).to(torch.int32), overflow


def salt_offset(salt: int) -> int:
    """Additive key offset derived from a routing salt (Knuth multiplicative
    mix), computed host-side."""
    return salt * 2654435761 % (2**31)


def batched_exchange_by_partition(
    rows: torch.Tensor, counts: torch.Tensor, part: torch.Tensor,
    cap_slot: int, cap_out: int,
    slot: Optional[torch.Tensor] = None, slot_counts: Optional[torch.Tensor] = None,
):
    """Route rows (s, p, cap, w) with counts (s, p) to explicit destination
    machines ``part`` (s, p, cap) among the p machines, s stages at once.
    ``slot``/``slot_counts`` (per segment, (s·p, cap) and (s·p, p)) accept
    the ``hash_partition_pack`` kernel's precomputed send layout.  Returns
    (rows_out (s, p, cap_out, w), counts (s, p), ovf_slot (s, p),
    ovf_out (s, p))."""
    s, p, cap, w = rows.shape
    seg = s * p
    send, send_counts, ovf_slot = pack_by_partition(
        rows.reshape(seg, cap, w), counts.reshape(seg), part.reshape(seg, cap),
        p, cap_slot, slot, slot_counts,
    )
    # the all-to-all: machine j receives send[i, j] from every machine i
    recv = send.reshape(s, p, p, cap_slot, w).transpose(1, 2).reshape(seg, p, cap_slot, w)
    recv_counts = send_counts.reshape(s, p, p).transpose(1, 2).reshape(seg, p)
    out, count_out, ovf_out = compact(recv, recv_counts, cap_out)
    return (out.reshape(s, p, cap_out, w), count_out.reshape(s, p),
            ovf_slot.reshape(s, p), ovf_out.reshape(s, p))


def exchange_by_partition(rows, counts, part, cap_slot: int, cap_out: int,
                          slot=None, slot_counts=None):
    """One stage of `batched_exchange_by_partition`: rows (p, cap, w), counts
    (p,), part (p, cap) → (rows_out (p, cap_out, w), counts (p,),
    ovf_slot (p,), ovf_out (p,))."""
    out = batched_exchange_by_partition(
        rows[None], counts[None], part[None], cap_slot, cap_out, slot, slot_counts
    )
    return tuple(x[0] for x in out)


def batched_hash_exchange(
    rows: torch.Tensor, counts: torch.Tensor, key_col: int,
    cap_slot: int, cap_out: int, offs: torch.Tensor,
):
    """s stages exchanged by hash(key + per-stage offset) among p machines.
    rows (s, p, cap, w), counts (s, p), ``offs`` (s,) the per-stage salt
    offsets (`salt_offset`).  The salted key wraps in int32.  Returns
    (rows_out (s, p, cap_out, w), counts (s, p), ovf_slot (s, p),
    ovf_out (s, p))."""
    s, p, cap, _ = rows.shape
    keys = wrap_i32(rows[..., key_col].to(torch.int64) + offs.to(torch.int64)[:, None, None])
    part, slot, slot_counts = hash_partition_pack(
        keys.reshape(s * p, cap), counts.reshape(s * p).to(torch.int32), p
    )
    return batched_exchange_by_partition(
        rows, counts, part.reshape(s, p, cap), cap_slot, cap_out, slot, slot_counts
    )


def hash_exchange(rows, counts, key_col: int, cap_slot: int, cap_out: int, salt=0):
    """One stage of `batched_hash_exchange`: rows (p, cap, w), counts (p,);
    ``salt`` is a Python int (mixed via `salt_offset`) or an int tensor
    already holding the offset.  Returns (rows_out (p, cap_out, w),
    counts (p,), ovf_slot (p,), ovf_out (p,))."""
    off = salt_offset(salt) if isinstance(salt, int) else int(salt)
    offs = torch.tensor([off], dtype=torch.int64, device=rows.device)
    out = batched_hash_exchange(rows[None], counts[None], key_col, cap_slot, cap_out, offs)
    return tuple(x[0] for x in out)
