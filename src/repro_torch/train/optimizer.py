"""AdamW with fp32 master weights + optional int8 gradient compression.

State layout, over the parameters by name (``dict(model.named_parameters())``):
``{"master": {name: fp32 copy}, "m": {name: fp32}, "v": {name: fp32}, "step": int32
scalar tensor}``. The model's parameters stay in their own dtype (bf16 for compute,
fp32 where the model keeps fp32, such as Mamba's ``A_log`` or the MoE router); the
update runs in fp32 against the master copy and casts each parameter back to its
own dtype. The JAX package casts every parameter to the dtype of its tree's first
leaf instead, so a bf16 model whose first leaf is fp32 comes out of one step in
fp32 (ROADMAP, Queue 3).

The update works in place (``master``, ``m``, ``v`` and the parameters are
overwritten, as the JAX driver donates them), so the state costs 12 bytes a
parameter and no second copy during the step.

Gradient compression: symmetric per-tensor int8 quantization with error feedback
[Seide et al.; 1-bit Adam lineage], applied to the accumulated gradient before the
optimizer. Not ``torch.optim.AdamW``: its decay and bias correction are not this
update.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to ``min_lr_frac · lr`` at
    ``total_steps``; fp32 on ``step``'s device."""
    step = step.float()
    warm = cfg.lr * step / max(1, cfg.warmup_steps)
    t = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
                    0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Tensors) -> Dict[str, object]:
    """fp32 master copies and zero moments of each parameter, on its device."""
    with torch.no_grad():
        return {
            "master": {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()},
            "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(iter(params.values())).device),
        }


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt(Σ ‖g‖²) over every tensor, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tensors.values()))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-12), max=1.0)


def clip_by_global_norm(tensors: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    """→ ({name: fp32 g · min(1, max_norm / ‖g‖)}, ‖g‖)."""
    norm = global_norm(tensors)
    scale = _clip_scale(norm, max_norm)
    return {k: g.float() * scale for k, g in tensors.items()}, norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tensors, grads: Tensors,
                 state: Dict[str, object]) -> Tuple[Tensors, Dict[str, object], Tensors]:
    """One AdamW step on clipped gradients, in place → (params, state, {"grad_norm",
    "lr"}). Each parameter is overwritten with its new master cast to its own
    dtype; ``state``'s tensors are overwritten too."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in params.items():
        g = grads[name].float() * scale
        master, m, v = state["master"][name], state["m"][name], state["v"][name]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * master
        master.sub_(lr * upd)
        p.copy_(master)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale fp32)."""
    x = x.float()
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_grads_with_ef(grads: Tensors, ef_state: Tensors) -> Tuple[Tensors, Tensors]:
    """Quantize (grad + ef) per tensor; the new ef is the residual → (dequantized
    grads, new ef)."""
    deq, ef = {}, {}
    for k, g in grads.items():
        g = g.float() + ef_state[k]
        q, s = compress_int8(g)
        deq[k] = decompress_int8(q, s)
        ef[k] = g - deq[k]
    return deq, ef


def init_ef_state(params: Tensors) -> Tensors:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
