"""Architecture config schema + shape cells (assigned architectures × input shapes).

Every assigned arch is expressed as a repeating ``pattern`` of BlockSpecs (period P),
optionally preceded by ``prefix`` blocks (e.g. DeepSeek's first dense layer). The
port's model runs the ``prefix`` blocks, then the pattern ``n_repeats`` times, as one
Python loop over its layers in layer order. A copy of the JAX package's schema: the
fields, defaults and derived sizes are the same.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockSpec:
    """One transformer/SSM block position inside the repeating pattern."""

    mixer: str = "attn"          # "attn" | "mla" | "mamba"
    window: int = 0              # 0 = full causal attention; >0 = sliding window
    rope_theta: float = 1e4
    moe: bool = False            # MoE FFN instead of dense FFN
    ffn: bool = True             # Mamba2 backbone has no FFN


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)
    prefix: Tuple[BlockSpec, ...] = ()

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_dispatch: str = "a2a"        # "a2a" (shard_map EP) | "dense" (naive baseline) | "loop"
    capacity_factor: float = 1.25

    # MLA (DeepSeek-V2)
    kv_lora: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # SSM (Mamba2 / SSD)
    d_state: int = 0
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_expand: int = 2
    conv_k: int = 4
    ssd_chunk: int = 256

    # encoder-decoder / frontend stubs
    is_encdec: bool = False
    n_enc_layers: int = 0
    n_frontend: int = 0              # stub length: ViT patches / audio frames
    frontend: str = "none"           # "none" | "prefix_embeds" | "encoder_frames"

    norm: str = "rms"                # "rms" | "ln"
    act: str = "swiglu"              # "swiglu" | "geglu" (gated) | "gelu" (2-matrix)
    rope_theta: float = 1e4
    tie_embeddings: bool = True

    # distribution / memory knobs (hillclimb levers; see EXPERIMENTS §Perf)
    sequence_parallel: bool = False
    sp_boundary: str = "subblock"    # "subblock" (Megatron SP) | "layer" (1 AG+RS/layer)
    remat: str = "nothing"           # "none" | "dots" | "nothing"
    shard_attn_heads: bool = True    # False: replicate attention (tiny models, 12H<16)
    dtype: str = "bfloat16"

    # ---------------------------------------------------------------

    @property
    def vocab_padded(self) -> int:
        return int(math.ceil(self.vocab / 256) * 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def n_repeats(self) -> int:
        n = self.n_layers - len(self.prefix)
        assert n % len(self.pattern) == 0, (self.name, n, len(self.pattern))
        return n // len(self.pattern)

    @property
    def n_dec_layers(self) -> int:
        return self.n_layers

    def block_at(self, layer: int) -> BlockSpec:
        if layer < len(self.prefix):
            return self.prefix[layer]
        return self.pattern[(layer - len(self.prefix)) % len(self.pattern)]

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k: every block is SSM or windowed attention, except
        for a bounded fraction of global layers (hybrid / local:global patterns)."""
        blocks = list(self.prefix) + list(self.pattern)
        full_attn = sum(1 for b in blocks if b.mixer in ("attn", "mla") and b.window == 0)
        return full_attn < len(blocks) / 2

    def param_count(self) -> int:
        """Total parameters (embedding + blocks); used for 6·N·D model-FLOPs."""
        d = self.d_model
        total = self.vocab_padded * d
        if not self.tie_embeddings:
            total += self.vocab_padded * d
        for layer in range(self.n_layers):
            total += self._block_params(self.block_at(layer))
        if self.is_encdec:
            for _ in range(self.n_enc_layers):
                total += self._block_params(BlockSpec()) + self._cross_attn_params()
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared experts only)."""
        d = self.d_model
        total = self.vocab_padded * d
        for layer in range(self.n_layers):
            b = self.block_at(layer)
            total += self._block_params(b, active_only=True)
        if self.is_encdec:
            for _ in range(self.n_enc_layers):
                total += self._block_params(BlockSpec()) + self._cross_attn_params()
        return total

    def _attn_params(self) -> int:
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        return d * h * hd + 2 * d * kv * hd + h * hd * d

    def _mla_params(self) -> int:
        d, h = self.d_model, self.n_heads
        qd = self.qk_nope_dim + self.qk_rope_dim
        out = d * h * qd                        # q proj
        out += d * (self.kv_lora + self.qk_rope_dim)   # kv down + shared k_rope
        out += self.kv_lora * h * (self.qk_nope_dim + self.v_head_dim)  # up-proj
        out += h * self.v_head_dim * d          # o proj
        return out

    def _mamba_params(self) -> int:
        d, di = self.d_model, self.d_inner
        g, s, nh = self.ssm_ngroups, self.d_state, self.ssm_nheads
        out = d * (2 * di + 2 * g * s + nh)     # z, x, B, C, dt projections
        out += self.conv_k * (di + 2 * g * s)   # depthwise conv
        out += nh * 2                           # A_log, D
        out += di * d                           # out proj
        return out

    def _ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        return mult * self.d_model * d_ff

    def _cross_attn_params(self) -> int:
        return self._attn_params()

    def _block_params(self, b: BlockSpec, active_only: bool = False) -> int:
        if b.mixer == "attn":
            total = self._attn_params()
        elif b.mixer == "mla":
            total = self._mla_params()
        elif b.mixer == "mamba":
            total = self._mamba_params()
        else:
            raise ValueError(b.mixer)
        if self.is_encdec and b.mixer == "attn":
            total += self._cross_attn_params()
        if b.ffn:
            if b.moe:
                n_live = (self.top_k + self.n_shared_experts) if active_only else (
                    self.n_experts + self.n_shared_experts
                )
                total += n_live * self._ffn_params(self.d_ff_expert)
                total += self.d_model * self.n_experts      # router
            else:
                total += self._ffn_params(self.d_ff)
        return total


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Cell applicability per the assignment (skips documented in DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "long_500k requires sub-quadratic attention (pure full-attention arch)"
    return True, ""


def reduced_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests: few layers (≥ one full pattern
    period), small width/vocab/experts — the structure is preserved."""
    small_pattern = tuple(
        replace(b, window=min(b.window, 16) if b.window else 0) for b in cfg.pattern
    )
    small_prefix = tuple(
        replace(b, window=min(b.window, 16) if b.window else 0) for b in cfg.prefix
    )
    n_layers = len(small_prefix) + 2 * len(small_pattern)
    return replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        n_experts=4 if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        vocab=512,
        kv_lora=32 if cfg.kv_lora else 0,
        qk_rope_dim=8 if cfg.kv_lora else cfg.qk_rope_dim,
        qk_nope_dim=16 if cfg.kv_lora else cfg.qk_nope_dim,
        v_head_dim=16 if cfg.kv_lora else cfg.v_head_dim,
        d_state=16 if cfg.d_state else 0,
        ssm_headdim=16 if cfg.d_state else cfg.ssm_headdim,
        ssd_chunk=8,
        n_enc_layers=2 if cfg.is_encdec else 0,
        n_frontend=8 if cfg.n_frontend else 0,
        pattern=small_pattern,
        prefix=small_prefix,
        remat="none",
        shard_attn_heads=True,
    )
