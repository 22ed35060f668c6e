"""Shared helpers of the LM parity tests (``test_torch_models*.py``,
``test_torch_serve.py``): the JAX package's reduced models, their weights carried
into the port through ``params_from_numpy``, and the tolerances.

Tolerances: float32 variants within 1e-4 absolute plus 1e-4 relative; the
configs' own bf16 within the JAX suite's 2e-2 (``tests/test_models_smoke.py``).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS, reduced_for_smoke
from repro.models import model as jm
from repro.train.data import synth_batch
from repro_torch.models.convert import params_from_numpy

ARCH_NAMES = sorted(ARCHS)
F32_TOL = 1e-4
BF16_TOL = 2e-2

# In bf16 these two reduced archs' logits are decided by rounding: the JAX
# package's own bf16 forward differs from its float32 forward on the same weights
# by more than BF16_TOL (deepseek-moe-16b: one token's top-k routing flips;
# jamba-1.5-large-398b: 16 layers, 8 of them MoE, 14 Mamba, its residual stream
# grown past 14, where one bf16 ulp is 0.0625). Wherever that happens, the tests
# hold the port to the float32 logits instead: no further from them than twice the
# JAX package's bf16 logits are. test_torch_models.py asserts that the two do
# exceed BF16_TOL, so the list cannot hide an arch that would pass.
BF16_ROUNDING_DECIDED = ("deepseek-moe-16b", "jamba-1.5-large-398b")


def np_tree(tree):
    """JAX arrays → numpy, bf16 leaves upcast to float32 (exact)."""
    return jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), tree)


def f32(a) -> np.ndarray:
    """A JAX array or a torch tensor as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def reduced(name: str, dtype=None):
    cfg = reduced_for_smoke(ARCHS[name])
    return replace(cfg, dtype=dtype) if dtype else cfg


class Built:
    """One reduced arch in both packages: JAX weights from PRNGKey(0), the port's
    through ``params_from_numpy``; each (name, dtype) built once."""

    def __init__(self):
        self._cache = {}

    def __call__(self, name: str, dtype=None):
        key = (name, dtype)
        if key not in self._cache:
            cfg = reduced(name, dtype)
            params = jm.init_params(cfg, jax.random.PRNGKey(0))
            self._cache[key] = (cfg, params, params_from_numpy(cfg, np_tree(params), "cpu"))
        return self._cache[key]


def batches(cfg, seq: int = 32, batch: int = 2, step: int = 0):
    """The same synth_batch for both packages: (jax batch, torch batch)."""
    raw = synth_batch(cfg, step=step, global_batch=batch, seq=seq)
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.from_numpy(v) for k, v in raw.items()})


def assert_close(got, want, tol: float, what: str = "") -> float:
    """|got - want| <= tol + tol·|want| elementwise; returns the largest |Δ|."""
    g, w = f32(got), f32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=what)
    return float(np.abs(g - w).max()) if g.size else 0.0


def jax_bf16_error(jax_bf16, jax_f32) -> np.ndarray:
    """Where the JAX package's bf16 logits leave BF16_TOL of its float32 logits."""
    j, t = f32(jax_bf16), f32(jax_f32)
    return np.abs(j - t) > BF16_TOL + BF16_TOL * np.abs(t)


def assert_bf16_logits(name: str, port, jax_bf16, jax_f32, what: str = "") -> float:
    """Within BF16_TOL of the JAX package's bf16 logits; for an arch of
    BF16_ROUNDING_DECIDED whose JAX bf16 logits leave BF16_TOL of the float32 ones
    here, no further from the float32 logits than twice the JAX bf16 logits are
    (``jax_f32`` may be None for the other archs). Returns the largest |Δ| held."""
    if name not in BF16_ROUNDING_DECIDED or not jax_bf16_error(jax_bf16, jax_f32).any():
        return assert_close(port, jax_bf16, BF16_TOL, what)
    p, j, t = f32(port), f32(jax_bf16), f32(jax_f32)
    port_err, jax_err = float(np.abs(p - t).max()), float(np.abs(j - t).max())
    assert port_err <= 2 * jax_err, (what, port_err, jax_err)
    return port_err
