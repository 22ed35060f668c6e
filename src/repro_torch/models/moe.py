"""Mixture-of-Experts FFN: shared experts + fine-grained routed experts (top-k).

Dispatch paths (cfg.moe_dispatch):

  * "loop"  — dropless Python loop over experts: the numerical oracle.
  * "dense" — every expert on every token, combined with sparse gates (the naive
              baseline).
  * "a2a"   — expert parallelism over the model axis of the ambient mesh
              (``distributed.ctx.set_mesh`` with ``axes_context``), held on one
              device as a virtual mesh: each shard packs its token slice into
              per-expert capacity buffers, one ``all_to_all`` (a transpose of the
              shard dims) carries them to the experts' owners, the experts run
              batched, and a second ``all_to_all`` brings the rows back. With no
              axes set it resolves to "loop", as in the JAX package.

Capacity: cap = ceil(T_local · top_k / E · capacity_factor), tokens beyond an expert's
capacity are dropped (their combine weight is zero) — the standard GShard contract; the
"loop" oracle is dropless, so it equals "a2a" at a capacity factor that makes drops
impossible (≥ E / top_k).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..distributed.collectives import all_to_all
from ..distributed.ctx import Mesh, current_axes, current_mesh, shard
from .layers import Init, Params, silu


def moe_params(cfg, init: Init, dtype) -> Params:
    d, dff, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    s = d ** -0.5
    p = {
        "router": init((d, e), torch.float32, s),
        "w_gate": init((e, d, dff), dtype, s),
        "w_up": init((e, d, dff), dtype, s),
        "w_out": init((e, dff, d), dtype, dff ** -0.5),
    }
    if cfg.n_shared_experts:
        dsh = cfg.d_ff_expert * cfg.n_shared_experts
        p["shared"] = Params({
            "w_gate": init((d, dsh), dtype, s),
            "w_up": init((d, dsh), dtype, s),
            "w_out": init((dsh, d), dtype, dsh ** -0.5),
        })
    return Params(p)


def _expert_ffn(p: Params, x: torch.Tensor, e_idx=None) -> torch.Tensor:
    """x (T, d) through one expert's weights, or (e_idx None) through all: (T,E,d)."""
    wg, wu, wo = p.w_gate, p.w_up, p.w_out
    if e_idx is not None:
        return (silu(x @ wg[e_idx]) * (x @ wu[e_idx])) @ wo[e_idx]
    h = silu(torch.einsum("td,edf->tef", x, wg)) * torch.einsum("td,edf->tef", x, wu)
    return torch.einsum("tef,efd->ted", h, wo)


def _router(cfg, p: Params, x_flat: torch.Tensor):
    """x (T, d) → (probs (T,E) fp32, topk_idx (T,k), topk_w (T,k) normalized); the
    logits accumulate in fp32 over the stream-dtype operands."""
    logits = x_flat.float() @ p.router.to(x_flat.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, topk_idx, topk_w / topk_w.sum(-1, keepdim=True)


def _aux_loss(cfg, probs: torch.Tensor, topk_idx: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss: E · Σ_e f_e · P_e."""
    e = cfg.n_experts
    f = F.one_hot(topk_idx, e).float().sum(1).mean(0) / cfg.top_k
    return e * torch.sum(f * probs.mean(0))


def _moe_loop(cfg, p: Params, x_flat: torch.Tensor):
    """Dropless python-loop oracle."""
    probs, topk_idx, topk_w = _router(cfg, p, x_flat)
    out = torch.zeros_like(x_flat)
    for e in range(cfg.n_experts):
        w_e = torch.where(topk_idx == e, topk_w, torch.zeros_like(topk_w)).sum(-1)   # (T,)
        out = out + _expert_ffn(p, x_flat, e_idx=e) * w_e[:, None].to(x_flat.dtype)
    return out, _aux_loss(cfg, probs, topk_idx)


def _moe_dense(cfg, p: Params, x_flat: torch.Tensor):
    """Every expert on every token; sparse combine."""
    probs, topk_idx, topk_w = _router(cfg, p, x_flat)
    onehot = F.one_hot(topk_idx, cfg.n_experts).float()                             # (T,k,E)
    gates = torch.einsum("tk,tke->te", topk_w, onehot)
    out = torch.einsum("te,ted->td", gates.to(x_flat.dtype), _expert_ffn(p, x_flat))
    return out, _aux_loss(cfg, probs, topk_idx)


def _pack_capacity(cfg, x_loc: torch.Tensor, idx_loc: torch.Tensor, cap: int):
    """Pack each shard's tokens into per-expert capacity buffers.

    x_loc (..., t, d), idx_loc (..., t, k) → (buffers (..., E, cap, d), slot
    (..., t, k), keep (..., t, k)): slot is each (token, k) entry's position among
    its shard's entries for the same expert, counted in (token, k) order; entries
    at slot ≥ cap are dropped (keep False). Only kept entries land in the buffers:
    dropped ones are written to a spare slot past the capacity, which is cut off,
    so a dropped entry never touches a kept token's row (the JAX package writes
    every dropped entry as zeros into slot cap-1, over the row of that expert's
    last kept token), and no two kept entries share a row."""
    *lead, t, k = idx_loc.shape
    e = cfg.n_experts
    flat = idx_loc.reshape(*lead, t * k)                          # expert per entry
    onehot = F.one_hot(flat, e).to(torch.int32)                    # (..., t·k, E)
    slot = ((torch.cumsum(onehot, dim=-2) * onehot).sum(-1) - 1).reshape(*lead, t, k)
    keep = slot < cap
    buffers = x_loc.new_zeros(*lead, e, cap + 1, x_loc.shape[-1])
    at = [torch.arange(n, device=x_loc.device).reshape([-1 if j == i else 1
                                                        for j in range(len(lead))] + [1, 1])
          for i, n in enumerate(lead)]
    buffers.index_put_((*at, idx_loc, slot.clamp(max=cap)), x_loc[..., None, :])
    return buffers[..., :cap, :], slot, keep


def _moe_a2a(cfg, p: Params, x_flat: torch.Tensor, axes):
    """All_to_all dispatch over the model axis of the ambient (virtual) mesh."""
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("moe_dispatch 'a2a' under mesh axes needs an ambient mesh "
                         "(distributed.ctx.set_mesh)")
    tp = axes.model
    tp_size = mesh.shape[tp]
    e = cfg.n_experts
    if e % tp_size:
        raise ValueError(f"{e} experts do not divide over {tp_size} model shards")
    e_loc = e // tp_size

    probs, topk_idx, topk_w = _router(cfg, p, x_flat)
    aux = _aux_loss(cfg, probs, topk_idx)

    # tokens partitioned over dp AND tp: each shard dispatches its own token slice.
    # Decode batches are small: fall back to tp-only sharding (dp groups dispatch
    # redundantly, so one group stands for all) or, for tiny T, to the dense path.
    dp_size = math.prod(mesh.shape[a] for a in axes.data)
    n_tok, d = x_flat.shape
    if n_tok % (dp_size * tp_size) == 0:
        groups = dp_size
    elif n_tok % tp_size == 0:
        groups = 1
    else:
        return _moe_dense(cfg, p, x_flat)
    t_loc = n_tok // (groups * tp_size)
    k = cfg.top_k
    cap = int(math.ceil(t_loc * k / e * cfg.capacity_factor))
    # small local batches (decode): pad capacity toward dropless
    cap = max(cap, min(t_loc, 8), 1)

    # (G, tp, ...): shard (g, m) holds token slice g·tp + m, as dp × tp splits dim 0
    shards = Mesh((groups, tp_size), ("dp", tp))
    x_loc = x_flat.reshape(groups, tp_size, t_loc, d)
    idx_loc = topk_idx.reshape(groups, tp_size, t_loc, k)
    w_loc = topk_w.reshape(groups, tp_size, t_loc, k)
    buffers, slot, keep = _pack_capacity(cfg, x_loc, idx_loc, cap)
    # (G, tp, E, cap, d) → (G, tp, tp_dst, E_loc, cap, d) → a2a → tokens from every
    # peer for each shard's own experts: (G, tp, tp_src, E_loc, cap, d)
    buffers = buffers.reshape(groups, tp_size, tp_size, e_loc, cap, d)
    recv = all_to_all(buffers, shards, tp, split_axis=0, concat_axis=0)
    # the experts of every shard at once, each over the rows its shard received in
    # every dp group: (tp, E_loc, G·tp_src·cap, d); shard m's weights are a view
    # of rows m·E_loc … (m+1)·E_loc of the (E, d, f) stacks
    rows = recv.permute(1, 3, 0, 2, 4, 5).reshape(tp_size, e_loc, -1, d)
    wg = p.w_gate.view(tp_size, e_loc, *p.w_gate.shape[1:])
    wu = p.w_up.view(tp_size, e_loc, *p.w_up.shape[1:])
    wo = p.w_out.view(tp_size, e_loc, *p.w_out.shape[1:])
    y = (silu(rows @ wg) * (rows @ wu)) @ wo
    y = y.reshape(tp_size, e_loc, groups, tp_size, cap, d).permute(2, 0, 3, 1, 4, 5)
    back = all_to_all(y, shards, tp, split_axis=0, concat_axis=0)
    back = back.reshape(groups, tp_size, e, cap, d)   # each shard's tokens, processed
    # combine: gather each (token, k) entry's row
    gi = torch.arange(groups, device=x_flat.device)[:, None, None]
    mi = torch.arange(tp_size, device=x_flat.device)[None, :, None]
    picked = back[gi, mi, idx_loc.reshape(groups, tp_size, t_loc * k),
                  slot.clamp(0, cap - 1).reshape(groups, tp_size, t_loc * k)]
    w_flat = torch.where(keep, w_loc, torch.zeros_like(w_loc)).reshape(groups, tp_size, -1)
    out = (picked * w_flat[..., None].to(picked.dtype)).reshape(groups, tp_size, t_loc, k, d)
    # each shard returns its own token slice: the tokens split over the model axis
    # (and the data axes), the JAX package's shard_map out_specs
    return shard(out.sum(dim=3).reshape(n_tok, d), "tp", None), aux


def moe_apply(cfg, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) → (out (B,S,d), aux_loss scalar)."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    axes = current_axes()
    dispatch = cfg.moe_dispatch
    if axes is None and dispatch == "a2a":
        dispatch = "loop"
    if dispatch == "a2a":
        out, aux = _moe_a2a(cfg, p, x_flat, axes)
    elif dispatch in ("dense", "einsum"):
        out, aux = _moe_dense(cfg, p, x_flat)
    elif dispatch == "loop":
        out, aux = _moe_loop(cfg, p, x_flat)
    else:
        raise ValueError(f"unknown moe_dispatch {dispatch!r}")
    if cfg.n_shared_experts:
        sp = p.shared
        out = out + (silu(x_flat @ sp.w_gate) * (x_flat @ sp.w_up)) @ sp.w_out
    return out.reshape(b, s, d), aux
