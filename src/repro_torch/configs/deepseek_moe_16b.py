"""deepseek-moe-16b [moe] — fine-grained experts: 2 shared + 64 routed, top-6.
28L d_model=2048 16H (kv=16, MHA) d_ff(expert)=1408 vocab=102400 [arXiv:2401.06066; hf].
First layer dense (d_ff=10944), remaining 27 MoE."""

from .base import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,
    vocab=102400,
    prefix=(BlockSpec(mixer="attn", moe=False),),
    pattern=(BlockSpec(mixer="attn", moe=True),),
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
)
