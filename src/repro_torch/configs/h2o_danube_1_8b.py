"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 [arXiv:2401.16818; hf].
SWA window 4096 (the danube v1 training window)."""

from .base import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    pattern=(BlockSpec(mixer="attn", window=4096),),
)
