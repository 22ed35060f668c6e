"""Plain PyTorch versions of the hand-written kernels.

The dataplane kernels' versions are the semantics their CUDA kernels must
reproduce bit for bit, batched over a leading segment axis (one segment per
(stage, machine) pair); the float kernels' versions (attention, SSD) are the
values their kernels must reproduce within a stated tolerance.  The wrappers
run these on CPU tensors; ``chip_smoke.py`` holds each kernel against its
plain version on the card.

uint32 arithmetic: PyTorch on the CPU has no ``>>`` or ``%`` for uint32, so
the hashes compute in int64 masked to 32 bits, and every 32-bit multiplier is
split into 16-bit halves so that no intermediate product leaves int64's range.
"""

from __future__ import annotations

import torch

from ..core.query import host_chunk_digests

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


def hash_partition_ref(keys: torch.Tensor, n_parts: int):
    """keys (N,) int32, any N → (part (N,) int32 partition id per key, hist
    (n_parts,) int32 global histogram of the ids)."""
    part = (hash_u32_ref(keys) % n_parts).to(torch.int32)
    hist = torch.zeros((n_parts,), dtype=torch.int64, device=keys.device)
    hist.scatter_add_(0, part.to(torch.int64), torch.ones_like(part, dtype=torch.int64))
    return part, hist.to(torch.int32)


def attention_weights(q: torch.Tensor, k: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """fp32 softmax weights (BH, Sq, Sk) of q (BH, Sq, D) against k (BH, Sk, D):
    scores at scale D^-0.5; the causal mask keeps ``k_pos <= q_pos`` counted
    from position 0 (also when Sq != Sk), masked scores are -1e30."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (d ** -0.5)
    if causal:
        iq = torch.arange(s.shape[1], device=s.device)[:, None]
        ik = torch.arange(s.shape[2], device=s.device)[None, :]
        s = torch.where(ik <= iq, s, torch.full_like(s, -1e30))
    return torch.softmax(s, dim=-1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain softmax attention: q (BH, Sq, D), k/v (BH, Sk, D) → (BH, Sq, D)
    in v's dtype.  The weights of :func:`attention_weights` are rounded to v's
    dtype before the fp32-accumulated P·V."""
    w = attention_weights(q, k, causal)
    return torch.einsum("bqk,bkd->bqd", w.to(v.dtype).float(), v.float()).to(v.dtype)


def flash_attention_bf16_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   out: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """The |Δ| (BH, Sq, D), fp32, by which a bfloat16 attention kernel may
    differ from :func:`flash_attention_ref`'s output ``out`` on these inputs.

    bf16's unit roundoff is 2^-8.  Both sides round the output once: 2^-7·|out|.
    Both round each weight once before P·V (the plain version its normalised
    softmax, a kernel its running exp(s - m)): at worst 2^-7·Σ_j w_j|v_j|;
    as independent bounded errors, Hoeffding puts their sum above
    2^-4·sqrt(Σ_j w_j² v_j²) with probability below 2e^-32.  The weights'
    term is the smaller of the two (the first wherever a row sees fewer than
    64 keys)."""
    w = attention_weights(q, k, causal)
    vf = v.float()
    worst = torch.einsum("bqk,bkd->bqd", w, vf.abs())
    spread = torch.einsum("bqk,bkd->bqd", w * w, vf * vf).sqrt()
    return 2.0 ** -7 * out.float().abs() + torch.minimum(2.0 ** -7 * worst, 2.0 ** -4 * spread)


def ssd_chunk_ref(x, dt, a, b_ssm, c_ssm, prev_state):
    """One SSD chunk for every (batch·head): x (BH, Q, P), dt (BH, Q), a (BH,),
    b/c (BH, Q, N), prev_state (BH, P, N) → (y (BH, Q, P), new_state
    (BH, P, N)).  fp32 math; the decay is masked before ``exp`` (for i < j,
    cum_i − cum_j > 0 and its exp may be inf)."""
    q = x.shape[1]
    cum = torch.cumsum(dt * a[:, None], dim=1)                      # (BH, Q)
    li = cum[:, :, None] - cum[:, None, :]
    iot = torch.arange(q, device=x.device)
    mask = iot[:, None] >= iot[None, :]
    decay = torch.exp(torch.where(mask, li, torch.full_like(li, -torch.inf)))
    cb = c_ssm @ b_ssm.transpose(1, 2)                              # (BH, Q, Q)
    w = cb * decay * dt[:, None, :]
    y_diag = w @ x                                                  # (BH, Q, P)
    y_off = (torch.exp(cum)[:, :, None] * c_ssm) @ prev_state.transpose(1, 2)
    decay_tail = torch.exp(cum[:, -1:] - cum)                       # (BH, Q)
    s_new = x.transpose(1, 2) @ (b_ssm * (decay_tail * dt)[:, :, None])   # (BH, P, N)
    new_state = torch.exp(cum[:, -1])[:, None, None] * prev_state + s_new
    return y_diag + y_off, new_state


def ssd_chunked_ref(x, dt, a, b_ssm, c_ssm, chunk: int):
    """SSD over a whole sequence, chunk after chunk: x (BH, S, P), dt (BH, S),
    a (BH,), b/c (BH, S, N), S % chunk == 0 → (y (BH, S, P), final_state
    (BH, P, N)), fp32; the state starts at zero."""
    bh, s, p = x.shape
    state = torch.zeros((bh, p, b_ssm.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)
        y, state = ssd_chunk_ref(x[:, sl], dt[:, sl], a, b_ssm[:, sl], c_ssm[:, sl], state)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else torch.zeros((bh, 0, p), dtype=torch.float32,
                                                    device=x.device)
    return y, state


def blake2b_chunks_ref(data: torch.Tensor) -> torch.Tensor:
    """data (N,) uint8 on the CPU → (ceil(N / DIGEST_CHUNK), 32) uint8: each
    chunk's BLAKE2b-256 digest, the table digest's host path
    (``core/query.py`` ``host_chunk_digests``)."""
    digests = bytearray(host_chunk_digests(data.contiguous().numpy()))
    return torch.frombuffer(digests, dtype=torch.uint8).view(-1, 32) if digests else \
        torch.empty((0, 32), dtype=torch.uint8)
