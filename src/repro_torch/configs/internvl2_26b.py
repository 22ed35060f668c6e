"""internvl2-26b [vlm] — InternViT frontend (stub) + InternLM2-20B backbone.
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 [arXiv:2404.16821; hf].

The assignment specifies the transformer BACKBONE only; the ViT frontend is a stub:
``input_specs()`` provides 256 precomputed patch embeddings per sample, prepended to the
token sequence (total sequence = shape seq_len; text tokens = seq_len - 256)."""

from .base import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    pattern=(BlockSpec(mixer="attn"),),
    n_frontend=256,
    frontend="prefix_embeds",
    rope_theta=1e6,
    sequence_parallel=True,
)
