"""The port's whole model in the configs' own bf16 ≡ the JAX package's, on the CPU,
for all ten reduced archs: ``model_forward`` logits, ``prefill``'s last-token
logits and four ``decode_step``s (both fed the JAX package's greedy tokens), within
the JAX suite's 2e-2 (``tests/test_models_smoke.py``), by the rule of
``torch_lm_parity.assert_bf16_logits``: where the JAX package's own bf16 logits of
an arch in ``BF16_ROUNDING_DECIDED`` leave 2e-2 of its float32 logits on the same
weights, the port's may be no further from those than twice the JAX ones are.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_lm_parity import (ARCH_NAMES, BF16_ROUNDING_DECIDED, Built, assert_bf16_logits,
                             batches, jax_bf16_error)

from repro.models import model as jm
from repro_torch.models import model as tm


@pytest.fixture(scope="module")
def built():
    return Built()


def _f32_twin(cfg, params):
    """The same weights, upcast (exactly), in the float32 variant of the config."""
    return (dataclasses.replace(cfg, dtype="float32"),
            jax.tree.map(lambda a: a.astype(jnp.float32), params))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_bf16_matches_reference(built, name):
    """model_forward logits, S = 32, batch 2."""
    cfg, params, model = built(name)
    jb, tb = batches(cfg)
    with torch.no_grad():
        logits, _ = tm.model_forward(cfg, model, tb)
    jlogits, _ = jax.jit(lambda p, b: jm.model_forward(cfg, p, b))(params, jb)
    c32, p32 = _f32_twin(cfg, params)
    truth, _ = jax.jit(lambda p, b: jm.model_forward(c32, p, b))(p32, jb)
    assert_bf16_logits(name, logits, jlogits, truth, "logits")
    # the archs whose bf16 logits rounding decides are exactly the listed two
    assert bool(jax_bf16_error(jlogits, truth).any()) == (name in BF16_ROUNDING_DECIDED)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_bf16_match_reference(built, name):
    """prefill (S = 32, cache headroom 8) then 4 decode steps, every step's logits
    held; both packages decode the JAX package's greedy tokens."""
    cfg, params, model = built(name)
    jb, tb = batches(cfg)
    jlogits, jcache = jax.jit(lambda p, b: jm.prefill(cfg, p, b, cache_len=40))(params, jb)
    step = jax.jit(lambda p, s, t: jm.decode_step(cfg, p, s, t))
    # the float32 twin's logits matter only where rounding may decide (the rule)
    twin = name in BF16_ROUNDING_DECIDED
    if twin:
        c32, p32 = _f32_twin(cfg, params)
        truth, tcache = jax.jit(lambda p, b: jm.prefill(c32, p, b, cache_len=40))(p32, jb)
        step32 = jax.jit(lambda p, s, t: jm.decode_step(c32, p, s, t))
    with torch.no_grad():
        logits, cache = tm.prefill(cfg, model, tb, cache_len=40)
    assert_bf16_logits(name, logits, jlogits, truth if twin else None, "prefill")
    for i in range(4):
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        jlogits, jcache = step(params, jcache, jtok)
        if twin:
            truth, tcache = step32(p32, tcache, jtok)
        with torch.no_grad():
            logits, cache = tm.decode_step(cfg, model, cache, torch.from_numpy(np.array(jtok)))
        assert_bf16_logits(name, logits, jlogits, truth if twin else None, f"decode step {i}")
