"""Plain PyTorch versions of the dataplane kernels.

Each function is the semantics its CUDA kernel must reproduce bit for bit,
batched over a leading segment axis (one segment per (stage, machine) pair).
The wrappers run these on CPU tensors; ``chip_smoke.py`` holds each kernel
against its plain version on the card.

uint32 arithmetic: PyTorch on the CPU has no ``>>`` or ``%`` for uint32, so
the hashes compute in int64 masked to 32 bits, and every 32-bit multiplier is
split into 16-bit halves so that no intermediate product leaves int64's range.
"""

from __future__ import annotations

import torch

MIX_A = 2654435761  # Knuth multiplicative constant
MIX_B = 0x9E3779B9
MASK32 = 0xFFFFFFFF
INT32_MAX = 2**31 - 1


def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for int64 ``x`` in [0, 2^32) and a constant c < 2^32:
    x·c_lo + ((x·c_hi) mod 2^16)·2^16 keeps every term below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) lanes reinterpreted as uint32 values, held in int64."""
    return x.to(torch.int64) & MASK32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 two's complement (JAX's int32 overflow)."""
    return (((x.to(torch.int64) + 2**31) & MASK32) - 2**31).to(torch.int32)


def hash_u32_ref(keys: torch.Tensor) -> torch.Tensor:
    """Multiplicative mix on uint32 lanes → int64 tensor of values in [0, 2^32)."""
    k = as_u32(keys)
    h = mul_u32(k ^ (k >> 16), MIX_A)
    h = mul_u32(h ^ (h >> 13), MIX_B)
    return h ^ (h >> 16)


def hash_partition_pack_ref(keys: torch.Tensor, counts: torch.Tensor, n_parts: int):
    """keys (S, N) int32, counts (S,) int32 → (part (S, N) with ``n_parts``
    marking rows at or past the segment's count, slot (S, N) stable rank of
    the row within its partition, send_counts (S, n_parts)); all int32."""
    s, n = keys.shape
    dev = keys.device
    part = (hash_u32_ref(keys) % n_parts).to(torch.int32)
    valid = torch.arange(n, device=dev)[None, :] < counts.to(torch.int64)[:, None]
    part = torch.where(valid, part, torch.full_like(part, n_parts))
    slot = stable_rank(part, n_parts + 1)
    hist = torch.zeros((s, n_parts + 1), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, part.to(torch.int64), torch.ones_like(part, dtype=torch.int64))
    return part, slot, hist[:, :n_parts].to(torch.int32)


def stable_rank(part: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(S, N) bin ids in [0, n_bins) → (S, N) int32 rank of each element among
    the earlier elements of its segment in the same bin (the one-hot running
    count of the reference, in O(N) memory via a stable sort)."""
    s, n = part.shape
    dev = part.device
    sorted_part, order = torch.sort(part, dim=1, stable=True)
    hist = torch.zeros((s, n_bins), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, part.to(torch.int64), torch.ones_like(part, dtype=torch.int64))
    first = torch.cumsum(hist, dim=1) - hist                     # bin start offsets
    pos = torch.arange(n, device=dev).expand(s, n)
    rank = pos - first.gather(1, sorted_part.to(torch.int64))
    slot = torch.empty((s, n), dtype=torch.int64, device=dev)
    slot.scatter_(1, order, rank)
    return slot.to(torch.int32)


def merge_join_counts_ref(a_keys: torch.Tensor, b_keys: torch.Tensor):
    """a_keys (S, N), b_keys (S, M) int32, each row sorted ascending →
    (lower, upper) (S, N) int32: matches of a_keys[s, i] in b_keys[s] live at
    [lower, upper)."""
    if a_keys.shape[1] == 0 or b_keys.shape[1] == 0:
        z = torch.zeros(a_keys.shape, dtype=torch.int32, device=a_keys.device)
        return z, z.clone()
    lower = torch.searchsorted(b_keys, a_keys, side="left").to(torch.int32)
    upper = torch.searchsorted(b_keys, a_keys, side="right").to(torch.int32)
    return lower, upper


def merge_join_pairs_ref(lower: torch.Tensor, starts: torch.Tensor, cap_out: int):
    """Expand match ranges into flat pair lists, per segment: starts (S, N) is
    the exclusive prefix sum of per-key match counts (starts[:, 0] == 0),
    lower (S, N) the per-key lower bound in B.  → (a_idx, b_idx) (S, cap_out)
    int32 with a_idx[t] = max{i : starts[i] <= t} clipped to [0, N-1] and
    b_idx[t] = lower[a_idx] + t - starts[a_idx] (unclipped); slots past the
    true total alias the last key."""
    s, n = starts.shape
    dev = starts.device
    if n == 0:
        z = torch.zeros((s, cap_out), dtype=torch.int32, device=dev)
        return z, z.clone()
    t = torch.arange(cap_out, dtype=torch.int32, device=dev).expand(s, cap_out).contiguous()
    k = torch.searchsorted(starts.to(torch.int32).contiguous(), t, side="right") - 1
    a_idx = k.clamp(0, n - 1)
    b_idx = lower.to(torch.int64).gather(1, a_idx) + (t - starts.to(torch.int64).gather(1, a_idx))
    return a_idx.to(torch.int32), b_idx.to(torch.int32)
