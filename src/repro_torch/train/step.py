"""train_step / serve_step / prefill_step builders: the functions the drivers call.

train_step supports microbatch gradient accumulation (a loop over microbatches,
fp32 sums) and optional int8 gradient compression with error feedback, applied to
the accumulated gradient before the optimizer. It updates the model and the
optimizer state in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..models.model import Model, decode_step, loss_fn, prefill
from .optimizer import (
    AdamWConfig,
    adamw_update,
    compressed_grads_with_ef,
    init_ef_state,
    init_opt_state,
)


@dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    compress_grads: bool = False


def loss_and_grads(cfg, params: Model, batch) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """→ ({name: gradient of the loss, in the parameter's dtype}, the loss's
    metrics). A parameter the loss does not reach gets zeros, as ``jax.grad``
    gives. Turns the parameters' gradients on."""
    named = dict(params.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(named.items(), grads)}
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) → (params, opt_state, metrics),
    the model and the state updated in place.

    opt_state = {"adamw": …, "ef": … (if compression)}. Batch tensors lead with
    the global batch; with microbatches the gradients are summed in fp32 and
    divided by their count, and the metrics are the last microbatch's.
    metrics: {"loss", "ce", "aux", "grad_norm", "lr"}."""

    def train_step(params: Model, opt_state, batch):
        if tcfg.microbatches > 1:
            mb = tcfg.microbatches
            micro = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:]) for k, v in batch.items()}
            grads = None
            for i in range(mb):
                g, metrics = loss_and_grads(cfg, params, {k: v[i] for k, v in micro.items()})
                if grads is None:
                    grads = {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                             for k, t in g.items()}
                for k, t in g.items():
                    grads[k] += t.float()
                del g
            grads = {k: t / mb for k, t in grads.items()}
        else:
            grads, metrics = loss_and_grads(cfg, params, batch)

        new_opt = dict(opt_state)
        if tcfg.compress_grads:
            grads, new_opt["ef"] = compressed_grads_with_ef(grads, opt_state["ef"])
        named = dict(params.named_parameters())
        _, new_opt["adamw"], opt_metrics = adamw_update(tcfg.adamw, named, grads,
                                                       opt_state["adamw"])
        return params, new_opt, {**metrics, **opt_metrics}

    return train_step


def init_train_state(cfg, tcfg: TrainConfig, params: Model):
    """{"adamw": fp32 masters and moments} (+ {"ef": zeros} with compression)."""
    named = dict(params.named_parameters())
    state = {"adamw": init_opt_state(named)}
    if tcfg.compress_grads:
        state["ef"] = init_ef_state(named)
    return state


def make_serve_step(cfg):
    """serve_step(params, cache, tokens_last) → (next_tokens, logits, cache):
    greedy, ``argmax`` over all ``vocab_padded`` columns, padded ids included."""

    @torch.no_grad()
    def serve_step(params, cache, tokens_last):
        logits, cache = decode_step(cfg, params, cache, tokens_last)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, logits, cache

    return serve_step


def make_prefill_step(cfg):
    @torch.no_grad()
    def prefill_step(params, batch):
        return prefill(cfg, params, batch)

    return prefill_step
