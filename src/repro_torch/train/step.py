"""serve_step / prefill_step builders: the functions the serving driver calls.

The training step (gradients, the optimizer) comes with the port's training path.
"""

from __future__ import annotations

import torch

from ..models.model import decode_step, prefill


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
