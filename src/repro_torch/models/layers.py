"""Shared layers: norms, rotary embeddings, MLPs, embedding/logits, loss.

Parameters live in :class:`Params` modules whose attribute names are the JAX
package's dictionary keys (``p.wq`` here is ``p["wq"]`` there), so that
``models/convert.py`` carries weights across by name. The parameters are
created frozen (serving builds no autograd graph); the training step turns
their gradients on. RMSNorm and the per-block bf16 gradient barrier carry the
JAX package's custom backward passes as ``torch.autograd.Function`` classes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..distributed.ctx import shard

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


class Init:
    """Makes a model's tensors on one device: ``init(shape, dtype, std)`` draws
    normal(0, std) from ``generator``, or, with no generator, returns
    uninitialised storage for weights copied in afterwards
    (``convert.params_from_numpy``) — on the ``meta`` device, shapes and dtypes
    with no storage (``launch/inputs.py``); :meth:`full` makes constants."""

    def __init__(self, device: torch.device, generator: Optional[torch.Generator] = None):
        self.device, self.generator = device, generator

    def __call__(self, shape: Tuple[int, ...], dtype: torch.dtype, std: float) -> torch.Tensor:
        if self.generator is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        return torch.randn(shape, generator=self.generator, dtype=dtype,
                           device=self.device) * std

    def full(self, shape: Tuple[int, ...], dtype: torch.dtype, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


class Params(nn.Module):
    """Named tensors (and nested ``Params``) of one layer part, created frozen:
    the serve path builds no autograd graph (the training step turns the
    gradients on)."""

    def __init__(self, tensors: Dict[str, object]):
        super().__init__()
        for name, t in tensors.items():
            if isinstance(t, nn.Module):
                self.add_module(name, t)
            else:
                self.register_parameter(name, nn.Parameter(t, requires_grad=False))


class _Bf16Barrier(torch.autograd.Function):
    """Identity forward; the backward casts the gradient to bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def grad_dtype_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; casts a bf16 tensor's gradient to bf16 on the way back
    (the JAX package's per-block cap on fp32 cotangent contagion). PyTorch's
    engine already hands every tensor a gradient of its own dtype, so this keeps
    the reference's structure rather than changing a value."""
    if x.dtype != torch.bfloat16:
        return x
    return _Bf16Barrier.apply(x)


def recompute_grads(fn, inputs, needs, grads_out):
    """The gradient of ``fn(*inputs)`` (a tensor or a tuple) against the outputs'
    gradients ``grads_out`` (None for an output that got none), for the inputs
    whose ``needs`` flag is set: ``fn`` runs again under ``torch.enable_grad()``
    on detached copies of the inputs → one gradient or None per input."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
        wanted = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                       allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in leaves)


def _rms_inv(x: torch.Tensor, eps: float) -> torch.Tensor:
    """(…, 1) fp32 inverse RMS of x."""
    xf = x.float()
    return torch.rsqrt((xf * xf).sum(-1, keepdim=True) / x.shape[-1] + eps)


class _RmsCore(torch.autograd.Function):
    """RMSNorm with the JAX package's closed-form backward in the stream dtype:
    d_x = s·inv·g − x·inv³·⟨s·g, x⟩/d, fp32 only for the (…, 1) statistics and
    the scale gradient (summed over every batch dim in fp32)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        inv = _rms_inv(x, eps)
        ctx.save_for_backward(x, inv, scale)
        return x * inv.to(x.dtype) * (1.0 + scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, inv, scale = ctx.saved_tensors
        d = x.shape[-1]
        gy = g.to(x.dtype) * (1.0 + scale).to(x.dtype)
        dot = (gy.float() * x.float()).sum(-1, keepdim=True)
        coef = inv ** 3 * (dot / d)
        d_x = gy * inv.to(x.dtype) - x * coef.to(x.dtype)
        xin = x * inv.to(x.dtype)
        d_scale = (g.float() * xin.float()).reshape(-1, d).sum(0).to(scale.dtype)
        return d_x, d_scale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm scaled by ``1 + scale``: the statistics in fp32, x kept in its
    dtype, and the custom backward of :class:`_RmsCore`."""
    return _RmsCore.apply(x, scale, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    d = x.shape[-1]
    xf = x.float()
    mu = xf.sum(-1, keepdim=True) / d
    var = (xf * xf).sum(-1, keepdim=True) / d - mu * mu
    inv = torch.rsqrt(var + eps)
    return (x - mu.to(x.dtype)) * inv.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p: Params) -> torch.Tensor:
    """The config's norm, its output behind :func:`grad_dtype_barrier`."""
    if cfg.norm == "rms":
        return grad_dtype_barrier(rms_norm(x, p.scale))
    return grad_dtype_barrier(layer_norm(x, p.scale, p.bias))


def norm_params(cfg, init: Init, d: int, dtype) -> Params:
    if cfg.norm == "rms":
        return Params({"scale": init.full((d,), dtype, 0.0)})
    return Params({"scale": init.full((d,), dtype, 1.0), "bias": init.full((d,), dtype, 0.0)})


# -- rotary ------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int → cos/sin (..., dim/2) float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, D/2) broadcast over heads (half-rotation),
    computed in fp32."""
    dt = x.dtype
    x = x.float()
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(dt)


# -- MLP ----------------------------------------------------------------------


# The activations follow the JAX package's rounding in low precision op by op (its
# CPU compiler rounds a bf16 result after every elementwise op, and rounds Python
# constants to the operand's type), so a bf16 model routes its MoE tokens as the
# JAX package does. In float32 they equal torch's fused functions to rounding.


def _const(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c`` rounded to x's dtype, filled on x's device (no host-to-device copy)."""
    return torch.full((), c, dtype=x.dtype, device=x.device)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x))."""
    one = _const(1.0, x)
    return one / (one + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · sigmoid(x)."""
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    inner = _const(np.sqrt(2 / np.pi), x) * (x + _const(0.044715, x) * (x * x * x))
    return x * (_const(0.5, x) * (_const(1.0, x) + torch.tanh(inner)))


def mlp_params(cfg, init: Init, d_model: int, d_ff: int, dtype) -> Params:
    scale = d_model ** -0.5
    p = {"w_out": init((d_ff, d_model), dtype, d_ff ** -0.5)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = init((d_model, d_ff), dtype, scale)
    p["w_up"] = init((d_model, d_ff), dtype, scale)
    return Params(p)


def mlp_apply(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) → (B, S, d)."""
    if cfg.act in ("swiglu", "geglu"):
        act = silu if cfg.act == "swiglu" else gelu
        h = act(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = gelu(x @ p.w_up)
    return shard(h, "dp", None, "tp") @ p.w_out


# -- embedding / logits / loss -------------------------------------------------


def embed_params(cfg, init: Init, dtype) -> Params:
    return Params({"embedding": init((cfg.vocab_padded, cfg.d_model), dtype, 0.02)})


def embed_apply(cfg, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return shard(p.embedding[tokens], "dp", None, None)


def logits_apply(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) → (B, S, vocab_padded): the tied embedding, padded columns included."""
    return shard(x @ p.embedding.T.to(x.dtype), "dp", None, "tp")


def cross_entropy(cfg, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all positions; padded vocab ids masked out of the logsumexp."""
    v = logits.shape[-1]
    logits = logits.float()
    iota = torch.arange(v, device=logits.device)
    logits = torch.where(iota < cfg.vocab, logits, torch.full_like(logits, -1e30))
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean()
