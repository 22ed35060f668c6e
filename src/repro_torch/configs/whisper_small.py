"""whisper-small [audio] — encoder-decoder; conv/mel frontend is a STUB.
12L d_model=768 12H (kv=12, i.e. MHA) d_ff=3072 vocab=51865 [arXiv:2212.04356].

Interpreted as 12 encoder + 12 decoder layers (the standard Whisper-small split).
``input_specs()`` provides 1500 precomputed frame embeddings (post-conv stub) for the
encoder; the decoder cross-attends to the encoder output. 12 heads do not divide the
16-way model axis, so attention activations stay replicated over TP (weights and FFN
remain sharded) — see DESIGN.md §5."""

from .base import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    pattern=(BlockSpec(mixer="attn"),),
    is_encdec=True,
    n_enc_layers=12,
    n_frontend=1500,
    frontend="encoder_frames",
    norm="ln",
    act="gelu",
    shard_attn_heads=False,
)
