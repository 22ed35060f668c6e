"""Model substrate: the ten assigned architectures as PyTorch modules.

Layout: one block module per layer, in layer order (the ``prefix`` blocks, then
the pattern repeated). Forward = embed → blocks → norm → logits; prefill builds a
per-layer cache that decode carries. ``convert.params_from_numpy`` carries the
JAX package's weights across.
"""

from .model import (
    init_params,
    model_forward,
    init_cache,
    prefill,
    decode_step,
)
