"""Attention: GQA (full / sliding-window / bidirectional), MLA, cross-attention,
and single-token decode paths.

Train/prefill attention goes to the port's ``flash_attention`` kernel wherever the
kernel computes the span exactly (:func:`_flash_eligible`, a rule of shapes and
config alone); everything else (MLA, whose key and value widths differ, and
sliding windows shorter than the sequence) runs :func:`chunked_attention`, the
twin of the JAX package's q-chunked attention with static KV spans. The kernel
route is differentiable: its backward recomputes :func:`chunked_attention`.
Decode attends to the cache in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..distributed.ctx import shard
from ..kernels import ops
from ..kernels.flash_attention import HEAD_DIMS
from .layers import Init, Params, apply_rope, recompute_grads, rope_cos_sin


def _attn_chunk(q, k, v, bias):
    """q (B,Cq,H,Dk), k (B,Sk,KV,Dk), v (B,Sk,KV,Dv) → (B,Cq,H,Dv). Softmax in fp32.
    Query head h attends with KV head h // (H/KV)."""
    b, cq, h, d = q.shape
    kvh = k.shape[2]
    dv = v.shape[-1]
    rep = h // kvh
    qg = q.reshape(b, cq, kvh, rep, d)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), k.float())
    scores = scores * (d ** -0.5)
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", w, v)
    return out.reshape(b, cq, h, dv)


def _causal_bias(q_start: int, cq: int, k_start: int, sk: int, window: int,
                 device) -> Optional[torch.Tensor]:
    """Additive -1e30 mask for chunk rows [q_start, q_start+cq) over kv [k_start,
    k_start+sk); None when the whole span is visible to every row."""
    fully_causal = (k_start + sk - 1) <= q_start
    fully_in_window = window == 0 or k_start > (q_start + cq - 1) - window
    if fully_causal and fully_in_window:
        return None
    qpos = q_start + torch.arange(cq, device=device)[:, None]
    kpos = k_start + torch.arange(sk, device=device)[None, :]
    ok = kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0, chunk: int = 2048) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,S,KV,D). Query chunks, each over a static KV span
    ([0, end) for causal, an aligned window for sliding-window attention)."""
    b, s, h, d = q.shape
    c = min(chunk, s)
    while s % c != 0:
        c //= 2
    outs = []
    for q_start in range(0, s, c):
        qc = q[:, q_start:q_start + c]
        if not causal:
            k_start, k_end = 0, k.shape[1]
        elif window > 0:
            k_start, k_end = max(0, (q_start - window + 1) // c * c), q_start + c
        else:
            k_start, k_end = 0, q_start + c
        bias = (_causal_bias(q_start, c, k_start, k_end - k_start, window, q.device)
                if causal else None)
        outs.append(_attn_chunk(qc, k[:, k_start:k_end], v[:, k_start:k_end], bias))
    return torch.cat(outs, dim=1)


def _flash_eligible(q_len: int, dk: int, dv: int, *, causal: bool, window: int) -> bool:
    """Whether the ``flash_attention`` kernel computes this attention exactly: every
    key of the span is visible to a causal row (no window, or one that covers the
    whole sequence) or the attention is bidirectional; keys and values share a
    head dim; and the kernel is compiled for it."""
    spans_all = window == 0 or q_len <= window or not causal
    return spans_all and dk == dv and dk in HEAD_DIMS


def _to_bhsd(x: torch.Tensor, rep: int) -> torch.Tensor:
    """(B,S,KV,D) → (B·KV·rep, S, D) contiguous, KV head j serving query heads
    j·rep .. j·rep+rep-1 (the grouping of :func:`_attn_chunk`)."""
    if rep > 1:
        x = x.repeat_interleave(rep, dim=2)
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool) -> torch.Tensor:
    """One ``ops.flash_attention`` call over the model's layout (its block
    contract is the whole span: ``bq=Sq``, ``bk=Sk``)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    rep = h // k.shape[2]
    out = ops.flash_attention(_to_bhsd(q, 1), _to_bhsd(k, rep), _to_bhsd(v, rep),
                              causal=causal, bq=sq, bk=sk)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3)


class _FlashAttn(torch.autograd.Function):
    """The forward on ``ops.flash_attention`` (the kernel on the card, its plain
    version on the CPU). The backward recomputes :func:`chunked_attention` over
    the full span and takes its gradient: the function the JAX package
    differentiates, with XLA, outside any kernel (it has no backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _flash_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        causal = ctx.causal
        grads = recompute_grads(lambda q, k, v: chunked_attention(q, k, v, causal=causal),
                                ctx.saved_tensors, ctx.needs_input_grad[:3], (g,))
        return grads + (None,)


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,KV,D) → (B,Sq,H,D) through ``ops.flash_attention``,
    differentiable (:class:`_FlashAttn`)."""
    return _FlashAttn.apply(q, k, v, causal)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
              window: int) -> torch.Tensor:
    """The kernel where :func:`_flash_eligible` allows it, else the chunked twin."""
    if _flash_eligible(q.shape[1], q.shape[-1], v.shape[-1], causal=causal, window=window):
        return flash_attn(q, k, v, causal=causal)
    return chunked_attention(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


def attn_params(cfg, init: Init, dtype, kv_heads: Optional[int] = None) -> Params:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    kv = kv_heads if kv_heads is not None else cfg.n_kv_heads
    s = d ** -0.5
    return Params({
        "wq": init((d, h * hd), dtype, s),
        "wk": init((d, kv * hd), dtype, s),
        "wv": init((d, kv * hd), dtype, s),
        "wo": init((h * hd, d), dtype, (h * hd) ** -0.5),
    })


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def _shard_heads(cfg, x: torch.Tensor) -> torch.Tensor:
    """Heads over the model axis, or (``shard_attn_heads`` off) replicated."""
    if cfg.shard_attn_heads:
        return shard(x, "dp", None, "tp", None)
    return shard(x, "dp", None, None, None)


def attn_apply(cfg, p: Params, x: torch.Tensor, *, positions: torch.Tensor, causal: bool,
               window: int, rope_theta: float,
               kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Full GQA block (train/prefill). kv_override supplies cross-attention memory."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cos, sin = rope_cos_sin(positions, hd, rope_theta)
    q = apply_rope(_shard_heads(cfg, _split_heads(x @ p.wq, h)), cos, sin)
    if kv_override is None:
        mem, mcos, msin = x, cos, sin
    else:
        mem, mem_positions = kv_override
        mcos, msin = rope_cos_sin(mem_positions, hd, rope_theta)
    k = apply_rope(_split_heads(mem @ p.wk, kv), mcos, msin)
    v = _split_heads(mem @ p.wv, kv)
    k = shard(k, "dp", None, None, None)
    v = shard(v, "dp", None, None, None)
    out = _shard_heads(cfg, attention(q, k, v, causal=causal, window=window))
    b, s = out.shape[:2]
    return out.reshape(b, s, h * hd) @ p.wo


def attn_kv_for_cache(cfg, p: Params, x, positions, rope_theta):
    """Project + rope k/v for prefill cache construction."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    k = _split_heads(x @ p.wk, kv)
    v = _split_heads(x @ p.wv, kv)
    cos, sin = rope_cos_sin(positions, hd, rope_theta)
    return apply_rope(k, cos, sin), v


def cache_slot(pos: int, s_max: int, window: int) -> int:
    """Where decode writes the token at ``pos``: a rotating slot on windowed
    layers, else the last slot once the buffer is full."""
    return pos % s_max if window > 0 else min(pos, s_max - 1)


def _valid_keys(pos: int, s_max: int, device) -> torch.Tensor:
    """(s_max,) bool: slots past ``pos`` are padding until the buffer is full."""
    return (torch.arange(s_max, device=device) <= pos) | (pos >= s_max)


def _at(pos: int, device) -> torch.Tensor:
    """(1,) int64 position ``pos``, filled on ``device`` (no host-to-device copy)."""
    return torch.full((1,), pos, dtype=torch.long, device=device)


def attn_decode(cfg, p: Params, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: int, *, window: int, rope_theta: float) -> torch.Tensor:
    """One-token decode: x (B, 1, d); the cache (B, S_max, KV, hd) is a rotating
    buffer (windowed layers: S_max = window), written in place at
    :func:`cache_slot`. ``pos`` is the current length, a host int."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_max = k_cache.shape[1]
    q = _split_heads(x @ p.wq, h)
    k_new = _split_heads(x @ p.wk, kv)
    v_new = _split_heads(x @ p.wv, kv)
    cos, sin = rope_cos_sin(_at(pos, x.device), hd, rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    k_new = apply_rope(k_new, cos[None], sin[None])

    slot = cache_slot(pos, s_max, window)
    k_cache[:, slot] = k_new[:, 0]
    v_cache[:, slot] = v_new[:, 0]

    qg = q.reshape(b, 1, kv, h // kv, hd)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k_cache).float() * (hd ** -0.5)
    scores = scores.masked_fill(~_valid_keys(pos, s_max, x.device), -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", w, v_cache).reshape(b, 1, h * hd)
    return out @ p.wo


def cross_decode(cfg, p: Params, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: int, rope_theta: float) -> torch.Tensor:
    """One-token cross-attention against the cached encoder K/V (no mask)."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _shard_heads(cfg, _split_heads(x @ p.wq, h))
    cos, sin = rope_cos_sin(_at(pos, x.device), hd, rope_theta)
    q = apply_rope(q, cos[None], sin[None])
    qg = q.reshape(b, 1, kv, h // kv, hd)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k).float()
    w = torch.softmax(scores * (hd ** -0.5), dim=-1).to(x.dtype)
    o = torch.einsum("bkrqs,bskd->bqkrd", w, v).reshape(b, 1, h * hd)
    return o @ p.wo


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank compressed KV cache
# ---------------------------------------------------------------------------


def mla_params(cfg, init: Init, dtype) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    r, nd, vd, rd = cfg.kv_lora, cfg.qk_nope_dim, cfg.v_head_dim, cfg.qk_rope_dim
    s = d ** -0.5
    return Params({
        "wq": init((d, h * (nd + rd)), dtype, s),
        "w_dkv": init((d, r + rd), dtype, s),      # latent + shared k_rope
        "w_uk": init((r, h * nd), dtype, r ** -0.5),
        "w_uv": init((r, h * vd), dtype, r ** -0.5),
        "wo": init((h * vd, d), dtype, (h * vd) ** -0.5),
    })


def mla_latent(cfg, p: Params, x, positions, rope_theta):
    """x (B,S,d) → (latent c (B,S,r), roped shared key (B,S,rd)): what MLA caches."""
    ckv = x @ p.w_dkv
    c, k_rope = ckv[..., :cfg.kv_lora], ckv[..., cfg.kv_lora:]
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_dim, rope_theta)
    return c, apply_rope(k_rope[..., None, :], cos, sin)[..., 0, :]


def mla_apply(cfg, p: Params, x, *, positions, rope_theta) -> torch.Tensor:
    """Train/prefill MLA (expanded form)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nd, vd, rd = cfg.qk_nope_dim, cfg.v_head_dim, cfg.qk_rope_dim
    q = shard((x @ p.wq).reshape(b, s, h, nd + rd), "dp", None, "tp", None)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    cos, sin = rope_cos_sin(positions, rd, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    c, k_rope = mla_latent(cfg, p, x, positions, rope_theta)
    k_nope = shard((c @ p.w_uk).reshape(b, s, h, nd), "dp", None, "tp", None)
    v = shard((c @ p.w_uv).reshape(b, s, h, vd), "dp", None, "tp", None)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rd)], dim=-1)
    out = attention(q_full, k_full, v, causal=True, window=0)
    return out.reshape(b, s, h * vd) @ p.wo


def mla_decode(cfg, p: Params, x, c_cache, kr_cache, pos: int, *, rope_theta) -> torch.Tensor:
    """Absorbed-matrix MLA decode: scores against the latent cache directly; the
    cache (B, S_max, ·) is written in place at slot min(pos, S_max - 1)."""
    b = x.shape[0]
    h = cfg.n_heads
    r, nd, vd, rd = cfg.kv_lora, cfg.qk_nope_dim, cfg.v_head_dim, cfg.qk_rope_dim
    s_max = c_cache.shape[1]
    q = (x @ p.wq).reshape(b, 1, h, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    c_new, kr_new = mla_latent(cfg, p, x, _at(pos, x.device), rope_theta)
    cos, sin = rope_cos_sin(_at(pos, x.device), rd, rope_theta)
    q_rope = apply_rope(q_rope, cos[None], sin[None])
    slot = min(pos, s_max - 1)
    c_cache[:, slot] = c_new[:, 0]
    kr_cache[:, slot] = kr_new[:, 0]

    q_eff = torch.einsum("bqhn,rhn->bhr", q_nope, p.w_uk.reshape(r, h, nd))
    scores = torch.einsum("bhr,bsr->bhs", q_eff, c_cache).float()
    scores = scores + torch.einsum("bqhd,bsd->bhs", q_rope, kr_cache).float()
    scores = scores * ((nd + rd) ** -0.5)
    scores = scores.masked_fill(~_valid_keys(pos, s_max, x.device), -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhs,bsr->bhr", w, c_cache)
    out = torch.einsum("bhr,rhv->bhv", ctx, p.w_uv.reshape(r, h, vd)).reshape(b, 1, h * vd)
    return out @ p.wo
