"""Model orchestration: embed → blocks, one per layer in layer order → norm → logits.

The model is an ``nn.Module`` holding one :class:`Block` per layer (the ``prefix``
blocks, then the pattern repeated ``n_repeats`` times), and, for the
encoder-decoder, an :class:`Encoder`. Parameter names follow the JAX package's
dictionary keys (``layers.3.mixer.wq`` is ``params["blocks"]["pos0"]["mixer"]["wq"][r]``
there, see ``convert.py``).

The cache is ``{"pos": int, "layers": [one dict per layer], "enc_out": …}``: ``pos``
is a host int, so decode needs no device-to-host read per layer. Decode writes the
attention caches in place (the JAX driver donates them); whisper decoder blocks
carry self-attn + cross-attn (cross K/V computed at prefill).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import BlockSpec
from ..device import resolve_device
from ..distributed.ctx import shard
from .attention import (
    attn_apply,
    attn_decode,
    attn_kv_for_cache,
    attn_params,
    cross_decode,
    mla_apply,
    mla_decode,
    mla_latent,
    mla_params,
)
from .layers import (
    Init,
    apply_norm,
    cross_entropy,
    embed_apply,
    embed_params,
    grad_dtype_barrier,
    logits_apply,
    mlp_apply,
    mlp_params,
    norm_params,
    torch_dtype,
)
from .mamba import mamba_apply, mamba_decode, mamba_params, mamba_prefill
from .moe import moe_apply, moe_params

#: the whisper encoder's blocks: full bidirectional attention, dense FFN
ENCODER_SPEC = BlockSpec(mixer="attn", window=0)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One layer: norm → mixer (attn / mla / mamba) [→ norm → cross-attn] → norm → FFN."""

    def __init__(self, cfg, spec: BlockSpec, init: Init, with_cross: bool):
        super().__init__()
        self.spec = spec
        dt = torch_dtype(cfg)
        self.norm1 = norm_params(cfg, init, cfg.d_model, dt)
        if spec.mixer == "attn":
            self.mixer = attn_params(cfg, init, dt)
        elif spec.mixer == "mla":
            self.mixer = mla_params(cfg, init, dt)
        elif spec.mixer == "mamba":
            self.mixer = mamba_params(cfg, init, dt)
        else:
            raise ValueError(spec.mixer)
        if with_cross and spec.mixer in ("attn", "mla"):
            self.norm_cross = norm_params(cfg, init, cfg.d_model, dt)
            self.cross = attn_params(cfg, init, dt)
        if spec.ffn:
            self.norm2 = norm_params(cfg, init, cfg.d_model, dt)
            if spec.moe:
                self.moe = moe_params(cfg, init, dt)
            else:
                self.ffn = mlp_params(cfg, init, cfg.d_model, cfg.d_ff, dt)


class Encoder(nn.Module):
    """The whisper-style encoder over stub frame embeddings."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        self.layers = nn.ModuleList(Block(cfg, ENCODER_SPEC, init, with_cross=False)
                                    for _ in range(cfg.n_enc_layers))
        self.final_norm = norm_params(cfg, init, cfg.d_model, torch_dtype(cfg))


class Model(nn.Module):
    """The parameters of one architecture; ``model(batch)`` is :func:`model_forward`."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg)
        self.embed = embed_params(cfg, init, dt)
        self.final_norm = norm_params(cfg, init, cfg.d_model, dt)
        self.layers = nn.ModuleList(Block(cfg, cfg.block_at(i), init, cfg.is_encdec)
                                    for i in range(cfg.n_layers))
        if cfg.is_encdec:
            self.encoder = Encoder(cfg, init)

    def forward(self, batch: Dict[str, torch.Tensor]):
        return model_forward(self.cfg, self, batch)


def init_params(cfg, seed: int = 0, device=None) -> Model:
    """Random weights drawn on ``device`` (the card unless the caller names
    another) from a ``torch.Generator`` seeded with ``seed``. On the ``meta``
    device nothing is drawn or allocated: the model carries shapes and dtypes."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return Model(cfg, Init(dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, Init(dev, gen))


# ---------------------------------------------------------------------------
# forward (train / eval)
# ---------------------------------------------------------------------------


def _block_apply(cfg, spec, p: Block, x, positions, *, causal: bool = True, enc_out=None,
                 enc_positions=None):
    """Returns (x, aux_loss). The residual stream's layout is pinned (sequence over
    the model axis under sequence parallelism) after each sub-block, or with
    ``sp_boundary="layer"`` once per block, as the JAX package pins it."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    sub = cfg.sp_boundary != "layer"

    def reshard(t):
        return shard(t, "dp", "sp", None) if sub else t

    h = apply_norm(cfg, x, p.norm1)
    if spec.mixer == "attn":
        h = attn_apply(cfg, p.mixer, h, positions=positions, causal=causal,
                       window=spec.window, rope_theta=spec.rope_theta)
    elif spec.mixer == "mla":
        h = mla_apply(cfg, p.mixer, h, positions=positions, rope_theta=spec.rope_theta)
    else:
        h = mamba_apply(cfg, p.mixer, h)
    x = reshard(x + h)

    if enc_out is not None and hasattr(p, "cross"):
        h = apply_norm(cfg, x, p.norm_cross)
        h = attn_apply(cfg, p.cross, h, positions=positions, causal=False, window=0,
                       rope_theta=spec.rope_theta, kv_override=(enc_out, enc_positions))
        x = reshard(x + h)

    if spec.ffn:
        h = apply_norm(cfg, x, p.norm2)
        if spec.moe:
            h, aux = moe_apply(cfg, p.moe, h)
        else:
            h = mlp_apply(cfg, p.ffn, h)
        x = x + h
    x = shard(x, "dp", "sp", None)         # block boundary: always pinned
    return grad_dtype_barrier(x), aux      # caps fp32 gradient contagion per block


#: the matrix products whose outputs ``remat="dots"`` keeps (the twin of
#: ``jax.checkpoint_policies.checkpoint_dots``); every other op is recomputed
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_call(cfg, fn, *args):
    """``fn(*args)`` under the config's rematerialisation while gradients are
    recorded (the JAX package's ``_remat_wrap``): ``"none"`` keeps every
    activation; ``"nothing"`` keeps only ``fn``'s inputs and runs ``fn``'s forward
    again in the backward; ``"dots"`` keeps the matrix products' outputs too. The
    blocks draw no random numbers, so no RNG state is stashed for the recompute."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=partial(create_selective_checkpoint_contexts, _dots_policy))
    if cfg.remat == "nothing":
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)[None, :]


def _run_encoder(cfg, params: Model, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings (B, F, d)."""
    x = shard(frames.to(torch_dtype(cfg)), "dp", None, None)
    positions = _positions(frames.shape[1], x.device)
    enc = params.encoder
    for layer in enc.layers:
        x, _ = _remat_call(cfg, partial(_block_apply, cfg, ENCODER_SPEC, layer, causal=False),
                           x, positions)
    return apply_norm(cfg, x, enc.final_norm)


def _embed_input(cfg, params: Model, batch):
    """tokens (+ frontend stubs) → x (B, S_total, d), positions (1, S_total)."""
    x = embed_apply(cfg, params.embed, batch["tokens"])
    if cfg.frontend == "prefix_embeds":
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    return shard(x, "dp", "sp", None), _positions(x.shape[1], x.device)


def _encode(cfg, params: Model, batch):
    if not cfg.is_encdec:
        return None, None
    enc_out = _run_encoder(cfg, params, batch["frames"])
    return enc_out, _positions(enc_out.shape[1], enc_out.device)


def model_forward(cfg, params: Model, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits (B, S_total, vocab_padded), aux_loss scalar fp32)."""
    x, positions = _embed_input(cfg, params, batch)
    enc_out, enc_positions = _encode(cfg, params, batch)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    n_pre, period = len(cfg.prefix), len(cfg.pattern)
    for layer in params.layers[:n_pre]:
        x, aux = _block_apply(cfg, layer.spec, layer, x, positions, enc_out=enc_out,
                              enc_positions=enc_positions)
        aux_total = aux_total + aux

    def repeat(group, x, enc_out):
        aux_step = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in group:
            x, aux = _block_apply(cfg, layer.spec, layer, x, positions, enc_out=enc_out,
                                  enc_positions=enc_positions)
            aux_step = aux_step + aux
        return x, aux_step

    # one rematerialised region per repeat of the pattern (the JAX package's scan body)
    for r in range(cfg.n_repeats):
        group = params.layers[n_pre + r * period:n_pre + (r + 1) * period]
        x, aux_step = _remat_call(cfg, partial(repeat, group), x, enc_out)
        aux_total = aux_total + aux_step
    x = apply_norm(cfg, x, params.final_norm)
    return logits_apply(cfg, params.embed, x), aux_total


def loss_fn(cfg, params: Model, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE on the text region (frontend prefix positions excluded) plus
    0.01 × the MoE aux loss → (loss, {"loss", "ce", "aux"}); differentiable."""
    logits, aux = model_forward(cfg, params, batch)
    s_text = batch["labels"].shape[1]
    logits_text = logits[:, -s_text:, :]
    ce = cross_entropy(cfg, logits_text[:, :-1], batch["labels"][:, 1:])
    loss = ce + 0.01 * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# cache + decode
# ---------------------------------------------------------------------------


def _block_cache(cfg, spec, batch: int, s_max: int, dt, device, with_cross: bool):
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    s_c = min(spec.window, s_max) if spec.window > 0 else s_max

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    if spec.mixer == "attn":
        c = {"k": zeros(batch, s_c, kv, hd), "v": zeros(batch, s_c, kv, hd)}
    elif spec.mixer == "mla":
        c = {"c": zeros(batch, s_max, cfg.kv_lora), "kr": zeros(batch, s_max, cfg.qk_rope_dim)}
    else:
        gn = cfg.ssm_ngroups * cfg.d_state
        c = {"conv_x": zeros(batch, cfg.conv_k - 1, cfg.d_inner),
             "conv_B": zeros(batch, cfg.conv_k - 1, gn),
             "conv_C": zeros(batch, cfg.conv_k - 1, gn),
             "state": zeros(batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.d_state)}
    if with_cross and spec.mixer in ("attn", "mla"):
        c["cross_k"] = zeros(batch, cfg.n_frontend, kv, hd)
        c["cross_v"] = zeros(batch, cfg.n_frontend, kv, hd)
    return c


def init_cache(cfg, batch: int, s_max: int, device=None) -> Dict[str, Any]:
    """Zero cache sized for a context of s_max tokens, on ``device`` (the card
    unless the caller names another)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    cache: Dict[str, Any] = {
        "pos": 0,
        "layers": [_block_cache(cfg, cfg.block_at(i), batch, s_max, dt, dev, cfg.is_encdec)
                   for i in range(cfg.n_layers)],
    }
    if cfg.is_encdec:
        cache["enc_out"] = torch.zeros((batch, cfg.n_frontend, cfg.d_model), dtype=dt,
                                       device=dev)
    return cache


def _block_decode(cfg, spec, p: Block, c: Dict[str, torch.Tensor], x, pos: int, enc_out):
    """One-token decode through one block. Returns (x, new_cache)."""
    h = apply_norm(cfg, x, p.norm1)
    new_c = dict(c)
    if spec.mixer == "attn":
        h = attn_decode(cfg, p.mixer, h, c["k"], c["v"], pos, window=spec.window,
                        rope_theta=spec.rope_theta)
    elif spec.mixer == "mla":
        h = mla_decode(cfg, p.mixer, h, c["c"], c["kr"], pos, rope_theta=spec.rope_theta)
    else:
        conv = {"x": c["conv_x"], "B": c["conv_B"], "C": c["conv_C"]}
        h, conv2, new_c["state"] = mamba_decode(cfg, p.mixer, h, conv, c["state"])
        new_c["conv_x"], new_c["conv_B"], new_c["conv_C"] = conv2["x"], conv2["B"], conv2["C"]
    x = x + h

    if enc_out is not None and hasattr(p, "cross"):
        h = apply_norm(cfg, x, p.norm_cross)
        x = x + cross_decode(cfg, p.cross, h, c["cross_k"], c["cross_v"], pos, spec.rope_theta)

    if spec.ffn:
        h = apply_norm(cfg, x, p.norm2)
        if spec.moe:
            h, _ = moe_apply(cfg, p.moe, h)
        else:
            h = mlp_apply(cfg, p.ffn, h)
        x = x + h
    return x, new_c


def decode_step(cfg, params: Model, cache, tokens_last: torch.Tensor):
    """tokens_last (B,) → (logits (B, vocab_padded), new cache). One serve step;
    the attention caches are updated in place."""
    pos = cache["pos"]
    x = embed_apply(cfg, params.embed, tokens_last[:, None])          # (B,1,d)
    enc_out = cache.get("enc_out") if cfg.is_encdec else None
    layers = []
    for layer, c in zip(params.layers, cache["layers"]):
        x, c2 = _block_decode(cfg, layer.spec, layer, c, x, pos, enc_out)
        layers.append(c2)
    x = apply_norm(cfg, x, params.final_norm)
    logits = logits_apply(cfg, params.embed, x)[:, 0, :]
    new_cache = dict(cache)
    new_cache["layers"] = layers
    new_cache["pos"] = pos + 1
    return logits, new_cache


# ---------------------------------------------------------------------------
# prefill: forward + cache construction
# ---------------------------------------------------------------------------


def _attn_cache_entry(k: torch.Tensor, v: torch.Tensor, window: int, s_total: int,
                      c_len: int) -> Dict[str, torch.Tensor]:
    """The last ``s_c`` keys/values, in the rotating-buffer layout on windowed
    layers (position q at slot q % s_c), or zero-padded to ``c_len``."""
    s_c = min(window, c_len) if window > 0 else c_len
    if s_total >= s_c:
        k_c, v_c = k[:, -s_c:], v[:, -s_c:]
        if 0 < window and s_total % s_c:
            shift = s_total % s_c
            k_c, v_c = torch.roll(k_c, shift, dims=1), torch.roll(v_c, shift, dims=1)
    else:
        pad = (0, 0, 0, 0, 0, s_c - s_total)
        k_c, v_c = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    return {"k": k_c, "v": v_c}


def _block_prefill(cfg, p: Block, x, positions, s_total: int, c_len: int, enc_out,
                   enc_positions):
    """One block of :func:`prefill` → (x, the block's cache entry)."""
    spec = p.spec
    h = apply_norm(cfg, x, p.norm1)
    if spec.mixer == "attn":
        k, v = attn_kv_for_cache(cfg, p.mixer, h, positions, spec.rope_theta)
        entry = _attn_cache_entry(k, v, spec.window, s_total, c_len)
        h = attn_apply(cfg, p.mixer, h, positions=positions, causal=True,
                       window=spec.window, rope_theta=spec.rope_theta)
    elif spec.mixer == "mla":
        c_lat, kr = mla_latent(cfg, p.mixer, h, positions, spec.rope_theta)
        if c_len > s_total:
            pad = (0, 0, 0, c_len - s_total)
            c_lat, kr = (torch.nn.functional.pad(c_lat, pad),
                         torch.nn.functional.pad(kr, pad))
        entry = {"c": c_lat, "kr": kr}
        h = mla_apply(cfg, p.mixer, h, positions=positions, rope_theta=spec.rope_theta)
    else:
        h, conv_state, st = mamba_prefill(cfg, p.mixer, h)
        entry = {"conv_x": conv_state["x"], "conv_B": conv_state["B"],
                 "conv_C": conv_state["C"], "state": st}
    x = shard(x + h, "dp", "sp", None)

    if enc_out is not None and hasattr(p, "cross"):
        hc = apply_norm(cfg, x, p.norm_cross)
        entry["cross_k"], entry["cross_v"] = attn_kv_for_cache(
            cfg, p.cross, enc_out, enc_positions, spec.rope_theta)
        x = x + attn_apply(cfg, p.cross, hc, positions=positions, causal=False, window=0,
                           rope_theta=spec.rope_theta, kv_override=(enc_out, enc_positions))
        x = shard(x, "dp", "sp", None)

    if spec.ffn:
        h2 = apply_norm(cfg, x, p.norm2)
        if spec.moe:
            h2, _ = moe_apply(cfg, p.moe, h2)
        else:
            h2 = mlp_apply(cfg, p.ffn, h2)
        x = shard(x + h2, "dp", "sp", None)
    return x, entry


def prefill(cfg, params: Model, batch,
            cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the context through the model, returning (last-token logits, cache).
    ``cache_len`` reserves decode headroom (defaults to the context length)."""
    x, positions = _embed_input(cfg, params, batch)
    s_total = x.shape[1]
    c_len = cache_len if cache_len is not None else s_total
    enc_out, enc_positions = _encode(cfg, params, batch)

    entries = []
    for p in params.layers:
        x, entry = _block_prefill(cfg, p, x, positions, s_total, c_len, enc_out, enc_positions)
        entries.append(entry)

    x = apply_norm(cfg, x, params.final_norm)
    logits = logits_apply(cfg, params.embed, x[:, -1:, :])[:, 0, :]
    cache: Dict[str, Any] = {"pos": s_total, "layers": entries}
    if cfg.is_encdec:
        cache["enc_out"] = enc_out
    return logits, cache
