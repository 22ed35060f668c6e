"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536 [arXiv:2403.19887; hf].

Pattern period 8: [attn, mamba×7] (1:7 attn:mamba as assigned); MoE FFN on every other
layer (period-2, as in released Jamba), dense FFN otherwise. SSM blocks use the SSD
(Mamba-2) formulation, chunked matmuls (released Jamba uses Mamba-1 selective scan).
Hybrid → long_500k applies."""

from .base import ArchConfig, BlockSpec

_P = []
for i in range(8):
    mixer = "attn" if i == 0 else "mamba"
    _P.append(BlockSpec(mixer=mixer, moe=(i % 2 == 1)))

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    pattern=tuple(_P),
    n_experts=16,
    n_shared_experts=0,
    top_k=2,
    d_ff_expert=24576,
    d_state=128,
    ssm_headdim=128,
    ssm_expand=2,
    sequence_parallel=True,
)
