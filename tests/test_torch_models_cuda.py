"""The port's LM serve path on the card ≡ on the CPU: reduced h2o-danube-1.8b and
mamba2-780m in float32, the same weights on both, within 1e-4; and the
``flash_attention`` / ``ssd_chunk`` kernels launched once per attention / Mamba
layer per prefill (counted in ``_build.launches``).

Marked ``cuda``: without a CUDA card every test here skips. The file imports
neither jax nor the JAX package, so it runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_models_cuda.py
"""

import copy
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced_for_smoke
from repro_torch.kernels import _build
from repro_torch.models import model as tm
from repro_torch.train.data import synth_batch

CASES = ["h2o-danube-1.8b", "mamba2-780m"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model_and_batch(name, seq):
    cfg = replace(reduced_for_smoke(ARCHS[name]), dtype="float32")
    model = tm.init_params(cfg, seed=3, device="cpu")
    raw = synth_batch(cfg, step=0, global_batch=2, seq=seq)
    return cfg, model, {k: torch.from_numpy(v) for k, v in raw.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_reduced_model_on_card_equals_cpu(cuda_device, name):
    """Prefill of 16 tokens (within danube's reduced 16-token window, so attention
    takes the kernel) and 4 greedy decode steps fed the CPU's tokens: logits within
    1e-4 absolute plus 1e-4 relative."""
    cfg, model, batch = _model_and_batch(name, seq=16)
    card = copy.deepcopy(model).to(cuda_device)
    with torch.no_grad():
        want, cache = tm.prefill(cfg, model, batch, cache_len=20)
        got, gcache = tm.prefill(cfg, card, {k: v.to(cuda_device) for k, v in batch.items()},
                                 cache_len=20)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
        tok = torch.argmax(want, -1).to(torch.int32)
        for i in range(4):
            want, cache = tm.decode_step(cfg, model, cache, tok)
            got, gcache = tm.decode_step(cfg, card, gcache, tok.to(cuda_device))
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {i}")
            tok = torch.argmax(want, -1).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernel", [("h2o-danube-1.8b", "flash_attention"),
                                         ("mamba2-780m", "ssd_chunk")])
def test_kernel_launches_once_per_layer_per_prefill(cuda_device, name, kernel):
    cfg, model, batch = _model_and_batch(name, seq=16)
    model = model.to(cuda_device)
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    with torch.no_grad():
        tm.prefill(cfg, model, batch)            # build the kernels first
        _build.launches.clear()
        tm.prefill(cfg, model, batch)
        torch.cuda.synchronize()
    mixer = "attn" if kernel == "flash_attention" else "mamba"
    n_layers = sum(cfg.block_at(i).mixer == mixer for i in range(cfg.n_layers))
    assert _build.launches[kernel] == n_layers > 0
