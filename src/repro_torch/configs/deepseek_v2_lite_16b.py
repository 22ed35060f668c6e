"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + fine-grained MoE.
27L d_model=2048 16H d_ff(expert)=1408 vocab=102400, 2 shared + 64 routed top-6
[arXiv:2405.04434; hf]. (The assignment note "160 routed" matches DeepSeek-V2-236B;
V2-*Lite* has 64 routed experts — we follow the hf config, noted in DESIGN.md.)
First layer uses a dense FFN (d_ff=10944), remaining 26 are MoE — hence prefix+pattern.
MLA caches only the 512-d latent + 64-d rope key per token (the paper's point)."""

from .base import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,
    vocab=102400,
    prefix=(BlockSpec(mixer="mla", moe=False),),
    pattern=(BlockSpec(mixer="mla", moe=True),),
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    kv_lora=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
)
