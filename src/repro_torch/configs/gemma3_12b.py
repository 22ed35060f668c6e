"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.
48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144 [hf:google/gemma-3 family].

Pattern period 6: five sliding-window (1024) layers then one global layer
(rope_theta 1e4 local / 1e6 global, as in the released configs). The 5:1 local:global
mix makes the arch sub-quadratic-dominated → long_500k applies (DESIGN.md §5)."""

from .base import ArchConfig, BlockSpec

_LOCAL = BlockSpec(mixer="attn", window=1024, rope_theta=1e4)
_GLOBAL = BlockSpec(mixer="attn", window=0, rope_theta=1e6)

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    act="geglu",
    sequence_parallel=True,
)
