"""Mixture-of-Experts FFN: shared experts + fine-grained routed experts (top-k).

Dispatch paths (cfg.moe_dispatch):

  * "loop"  — dropless Python loop over experts: the numerical oracle.
  * "dense" — every expert on every token, combined with sparse gates (the naive
              baseline).
  * "a2a"   — the JAX package's expert-parallel all_to_all exchange needs a mesh,
              which the port does not have; on one device it resolves to "loop",
              exactly as the JAX package does when no mesh axes are set.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

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


def moe_apply(cfg, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) → (out (B,S,d), aux_loss scalar)."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    dispatch = "loop" if cfg.moe_dispatch == "a2a" else cfg.moe_dispatch
    if dispatch in ("dense", "einsum"):
        out, aux = _moe_dense(cfg, p, x_flat)
    elif dispatch == "loop":
        out, aux = _moe_loop(cfg, p, x_flat)
    else:
        raise ValueError(f"unknown moe_dispatch {dispatch!r}")
    if cfg.n_shared_experts:
        sp = p.shared
        out = out + (silu(x_flat @ sp.w_gate) * (x_flat @ sp.w_up)) @ sp.w_out
    return out.reshape(b, s, d), aux
