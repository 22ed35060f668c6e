"""Mamba-2 / SSD (state-space duality) block [arXiv:2405.21060].

The prefill and forward scan runs on the port's ``ssd_chunk`` kernel
(:func:`ssd_chunked`): within a chunk of Q tokens the recurrence is a masked
matmul, across chunks a scan carries the (H, P, N) state. Both start from a zero
state, which is the kernel's. The kernel computes in fp32: in a bf16 model the
port is the more exact side against the JAX package's ``ssd_chunked``, whose
einsums round their inputs to bf16. :func:`ssd_reference` is the per-token
recurrence, kept as the tests' oracle. The kernel route is differentiable: its
backward recomputes :func:`ssd_chunked_matmul`, the JAX package's matmul form.

The depthwise causal conv is applied separately to the x / B / C streams.

Shapes: x (B,S,H,P) with H = d_inner/headdim SSD heads, P = headdim; B̃/C (B,S,G,N)
with G groups and N = d_state; dt (B,S,H) after softplus; A (H,) negative.

Decode carries (conv states (B,k-1,·) per stream, ssm_state (B,H,P,N)): O(1) per
token.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..distributed.ctx import shard
from ..kernels import ops
from .layers import Init, Params, recompute_grads, rms_norm, silu


def mamba_params(cfg, init: Init, dtype) -> Params:
    d, di = cfg.d_model, cfg.d_inner
    g, n, nh = cfg.ssm_ngroups, cfg.d_state, cfg.ssm_nheads
    s = d ** -0.5
    return Params({
        "w_z": init((d, di), dtype, s),
        "w_x": init((d, di), dtype, s),
        "w_B": init((d, g * n), dtype, s),
        "w_C": init((d, g * n), dtype, s),
        "w_dt": init((d, nh), dtype, s),
        "dt_bias": init.full((nh,), torch.float32, 0.0),
        "conv_x": init((cfg.conv_k, di), dtype, 0.1),
        "conv_B": init((cfg.conv_k, g * n), dtype, 0.1),
        "conv_C": init((cfg.conv_k, g * n), dtype, 0.1),
        "A_log": init.full((nh,), torch.float32, 0.0),
        "D": init.full((nh,), torch.float32, 1.0),
        "norm_scale": init.full((di,), dtype, 0.0),
        "w_out": init((di, d), dtype, di ** -0.5),
    })


def _causal_conv(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + SiLU: xs (B,S,CH), w (K,CH)."""
    k = w.shape[0]
    pad = F.pad(xs, (0, 0, k - 1, 0))
    out = torch.zeros_like(xs)
    for i in range(k):
        out = out + pad[:, i:i + xs.shape[1], :] * w[i][None, None, :]
    return silu(out)


def _conv_step(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Single-position depthwise conv: window (B,K,CH), w (K,CH) → (B,1,CH)."""
    return silu(torch.sum(window * w[None], dim=1, keepdim=True))


def _project(cfg, p: Params, u: torch.Tensor):
    """u (B,S,d) → z, x_pre, b_pre, c_pre, dt (pre-conv streams; dt fp32)."""
    dt = F.softplus((u @ p.w_dt).float() + p.dt_bias[None, None, :])
    return u @ p.w_z, u @ p.w_x, u @ p.w_B, u @ p.w_C, dt


def ssd_chunk_len(chunk: int, s: int) -> int:
    """The JAX package's chunk: ``min(chunk, S)``, halved until it divides S."""
    q = min(chunk, s)
    while s % q:
        q //= 2
    return q


def _ssd_forward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_ssm: torch.Tensor,
                 c_ssm: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``ops.ssd_chunk`` call over the model's layout (heads first, fp32)."""
    bsz, s, h, pdim = x.shape
    g = b_ssm.shape[2]

    def heads_first(t, rep):            # (B,S,G,·) → (B·H, S, ·) fp32
        if rep > 1:
            t = t.repeat_interleave(rep, dim=2)
        return t.permute(0, 2, 1, 3).reshape(bsz * h, s, -1).float()

    y, state = ops.ssd_chunk(
        heads_first(x, 1), dt.permute(0, 2, 1).reshape(bsz * h, s).float(),
        a.float().repeat(bsz),                       # index b·H + h → a[h]
        heads_first(b_ssm, h // g), heads_first(c_ssm, h // g),
        chunk=ssd_chunk_len(chunk, s))
    y = y.reshape(bsz, h, s, pdim).permute(0, 2, 1, 3)
    state = state.reshape(bsz, h, pdim, -1)
    return y.to(x.dtype), state.to(x.dtype)


def ssd_chunked_matmul(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                       chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's matmul-form chunked SSD from a zero state, in PyTorch ops
    (the function its training differentiates, and :func:`ssd_chunked`'s
    backward recomputes): the intra-chunk part as masked, decayed products, the
    chunk summaries, the inter-chunk recurrence (here a loop over the chunks,
    there an associative scan) and the inter-chunk outputs. The einsums take
    their operands in x's dtype, as there. → (y (B,S,H,P), final_state
    (B,H,P,N)) in x's dtype."""
    bsz, s, h, pdim = x.shape
    g, n = b_ssm.shape[2], b_ssm.shape[3]
    q = ssd_chunk_len(chunk, s)
    nc = s // q
    rep = h // g

    xq = x.reshape(bsz, nc, q, h, pdim)
    dtq = dt.reshape(bsz, nc, q, h)
    bq = b_ssm.reshape(bsz, nc, q, g, n)
    cq = c_ssm.reshape(bsz, nc, q, g, n)

    cum = torch.cumsum(dtq * a[None, None, None, :], dim=2)   # (B,nc,Q,H) fp32, ≤ 0
    seg_sum = cum[:, :, -1, :]                                 # (B,nc,H)
    # decay L[i,j] = exp(cum_i - cum_j) for i ≥ j, masked before the exp
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (B,nc,Q,Q,H)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    decay = torch.exp(torch.where(mask, li, torch.full_like(li, float("-inf"))))

    # heads factor as H = G groups × R heads per group; B̃/C stay per group
    xg = xq.reshape(bsz, nc, q, g, rep, pdim)
    dtg = dtq.reshape(bsz, nc, q, g, rep)
    cb = torch.einsum("bcign,bcjgn->bcijg", cq.float(), bq.float())
    w_ij = (cb[..., None] * decay.reshape(bsz, nc, q, q, g, rep)
            * dtg[:, :, None, :, :, :])                        # (B,nc,Q,Q,G,R)
    y_diag = torch.einsum("bcijgr,bcjgrp->bcigrp", w_ij.to(x.dtype), xg)

    # chunk summaries S_c = Σ_j exp(seg - cum_j) dt_j B_j ⊗ x_j
    wdt = (torch.exp(seg_sum[:, :, None, :] - cum) * dtq).reshape(bsz, nc, q, g, rep)
    s_c = torch.einsum("bcjgr,bcjgn,bcjgrp->bcgrpn", wdt.to(x.dtype), bq,
                       xg).reshape(bsz, nc, h, pdim, n)

    # the state entering chunk c: states[c] = exp(seg_{c-1})·states[c-1] + S_{c-1}
    gamma = torch.exp(seg_sum)                                 # (B,nc,H)
    state = torch.zeros((bsz, h, pdim, n), dtype=s_c.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = s_c[:, c] + state * gamma[:, c][..., None, None].to(state.dtype)
    prev_g = torch.stack(prev, dim=1).reshape(bsz, nc, g, rep, pdim, n)

    # inter-chunk contribution y[i] += C_i · exp(cum_i) · prev_state
    decay_head = torch.exp(cum).reshape(bsz, nc, q, g, rep)
    y_off = torch.einsum("bcign,bcigr,bcgrpn->bcigrp", cq.to(x.dtype),
                         decay_head.to(x.dtype), prev_g)
    return (y_diag + y_off).reshape(bsz, s, h, pdim), state


class _SsdChunk(torch.autograd.Function):
    """The forward on ``ops.ssd_chunk`` (the kernel on the card, its plain
    version on the CPU). The backward recomputes :func:`ssd_chunked_matmul` and
    takes its gradient: the function the JAX package differentiates, with XLA,
    outside any kernel (it has no backward kernel)."""

    @staticmethod
    def forward(ctx, x, dt, a, b_ssm, c_ssm, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b_ssm, c_ssm)
        return _ssd_forward(x, dt, a, b_ssm, c_ssm, chunk)

    @staticmethod
    def backward(ctx, g_y, g_state):
        chunk = ctx.chunk
        grads = recompute_grads(lambda *t: ssd_chunked_matmul(*t, chunk), ctx.saved_tensors,
                                ctx.needs_input_grad[:5], (g_y, g_state))
        return grads + (None,)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_ssm: torch.Tensor,
                c_ssm: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan from a zero state through ``ops.ssd_chunk``: x (B,S,H,P),
    dt (B,S,H) fp32, a (H,), b/c (B,S,G,N) → (y (B,S,H,P), final_state (B,H,P,N))
    in x's dtype. Head h reads group h // (H/G). Differentiable
    (:class:`_SsdChunk`)."""
    return _SsdChunk.apply(x, dt, a, b_ssm, c_ssm, chunk)


def ssd_reference(x, dt, a, b_ssm, c_ssm):
    """Naive per-token recurrence from a zero state, in fp32 (the oracle):
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T ; y_t = C_t · h_t."""
    bsz, s, h, pdim = x.shape
    rep = h // b_ssm.shape[2]
    state = torch.zeros((bsz, h, pdim, b_ssm.shape[3]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        btg = b_ssm[:, t].float().repeat_interleave(rep, dim=1)
        ctg = c_ssm[:, t].float().repeat_interleave(rep, dim=1)
        decay = torch.exp(dt[:, t] * a[None, :])[..., None, None]
        upd = dt[:, t][..., None, None] * torch.einsum("bhp,bhn->bhpn", x[:, t].float(), btg)
        state = decay * state + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ctg))
    return torch.stack(ys, dim=1).to(x.dtype), state.to(x.dtype)


def _ssd_run(cfg, p: Params, z, x_conv, b_conv, c_conv, dt):
    bsz, s, _ = x_conv.shape
    h, pdim = cfg.ssm_nheads, cfg.ssm_headdim
    x4 = shard(x_conv.reshape(bsz, s, h, pdim), "dp", None, "tp", None)
    b4 = b_conv.reshape(bsz, s, cfg.ssm_ngroups, cfg.d_state)
    c4 = c_conv.reshape(bsz, s, cfg.ssm_ngroups, cfg.d_state)
    a = -torch.exp(p.A_log)
    y, state = ssd_chunked(x4, dt, a, b4, c4, cfg.ssd_chunk)
    y = y + x4 * p.D[None, None, :, None].to(x4.dtype)
    y = y.reshape(bsz, s, cfg.d_inner)
    y = rms_norm(y * silu(z), p.norm_scale)
    return y @ p.w_out, state


def mamba_apply(cfg, p: Params, u: torch.Tensor) -> torch.Tensor:
    """Train forward (B,S,d) → (B,S,d)."""
    out, _, _ = mamba_prefill(cfg, p, u)
    return out


def mamba_prefill(cfg, p: Params, u: torch.Tensor):
    """Forward + decode state (conv windows are the last k-1 *pre-conv* positions)."""
    z, x, b, c, dt = _project(cfg, p, u)
    k = cfg.conv_k
    conv_state = {"x": x[:, -(k - 1):, :], "B": b[:, -(k - 1):, :], "C": c[:, -(k - 1):, :]}
    out, state = _ssd_run(cfg, p, z, _causal_conv(x, p.conv_x), _causal_conv(b, p.conv_B),
                          _causal_conv(c, p.conv_C), dt)
    return out, conv_state, state


def mamba_decode(cfg, p: Params, u: torch.Tensor, conv_state: Dict[str, torch.Tensor],
                 ssm_state: torch.Tensor):
    """One token: u (B,1,d); conv_state {x,B,C: (B,k-1,·)}; ssm_state (B,H,P,N)
    → (out, new conv_state, new ssm_state)."""
    bsz = u.shape[0]
    h, pdim = cfg.ssm_nheads, cfg.ssm_headdim
    z, x_new, b_new, c_new, dt = _project(cfg, p, u)

    new_conv, outs = {}, {}
    for name, new, w in (("x", x_new, p.conv_x), ("B", b_new, p.conv_B),
                         ("C", c_new, p.conv_C)):
        window = torch.cat([conv_state[name], new], dim=1)          # (B,k,CH)
        new_conv[name] = window[:, 1:, :]
        outs[name] = _conv_step(window, w)

    x = outs["x"].reshape(bsz, h, pdim)
    rep = h // cfg.ssm_ngroups
    bt = outs["B"].reshape(bsz, cfg.ssm_ngroups, cfg.d_state).repeat_interleave(rep, dim=1)
    ct = outs["C"].reshape(bsz, cfg.ssm_ngroups, cfg.d_state).repeat_interleave(rep, dim=1)
    a = -torch.exp(p.A_log)
    dtt = dt[:, 0, :]                                               # (B,H)
    decay = torch.exp(dtt * a[None, :])[..., None, None].to(ssm_state.dtype)
    upd = (dtt[..., None, None]
           * torch.einsum("bhp,bhn->bhpn", x.float(), bt.float())).to(ssm_state.dtype)
    ssm_state = decay * ssm_state + upd
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, ct.to(ssm_state.dtype)).to(u.dtype)
    y = y + x * p.D[None, :, None].to(x.dtype)
    y = y.reshape(bsz, 1, cfg.d_inner)
    y = rms_norm(y * silu(z), p.norm_scale)
    return y @ p.w_out, new_conv, ssm_state
