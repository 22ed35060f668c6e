"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544
[arXiv:2403.17297; hf]. Pure full attention → long_500k skipped."""

from .base import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92544,
    pattern=(BlockSpec(mixer="attn"),),
    rope_theta=1e6,
    sequence_parallel=True,
)
