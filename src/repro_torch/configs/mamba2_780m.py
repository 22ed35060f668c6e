"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
48L d_model=1536 vocab=50280, d_state=128, headdim=64 → d_inner=3072, 48 SSD heads
[arXiv:2405.21060]. No FFN (the Mamba backbone is norm→mixer→residual only).
SSM → long_500k applies (constant-size recurrent state)."""

from .base import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,           # unused (attention-free)
    n_kv_heads=1,
    head_dim=1,
    d_ff=0,
    vocab=50280,
    pattern=(BlockSpec(mixer="mamba", ffn=False),),
    d_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
)
