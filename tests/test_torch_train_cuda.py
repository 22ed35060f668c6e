"""The port's training path on the card ≡ on the CPU: the two kernel routes'
autograd Functions (the kernel's forward, the recomputed plain backward) against
the CPU's (the plain forward), and one training step of reduced h2o-danube-1.8b and
mamba2-780m in float32, where every parameter gets a finite gradient that is not
identically zero, equal to the CPU's, with the kernel launched once per layer.

Tolerances: float32 with TF32 off, 1e-4 absolute plus 1e-4 relative for outputs
and masters, gradients within 1e-4 of their leaf's largest |g| + 1e-4·|g|. A
master whose gradient is zero within that limit takes a first AdamW update,
lr·g/(|g| + 1e-8), decided by rounding: such elements may leave the masters'
limit, at most one in 10^5 (as in ``test_torch_train_steps.py``).

Marked ``cuda``: without a CUDA card every test here skips. The file imports
neither jax nor the JAX package, so it runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_train_cuda.py
"""

import copy
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, reduced_for_smoke
from repro_torch.kernels import _build
from repro_torch.models import attention as ta
from repro_torch.models import mamba as tmb
from repro_torch.models import model as tm
from repro_torch.train import step as tstep
from repro_torch.train.data import synth_batch
from repro_torch.train.optimizer import AdamWConfig

TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grads_on(fn, inputs, g, device):
    leaves = [t.to(device).requires_grad_(t.is_floating_point()) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs[0], [t for t in leaves if t.requires_grad], g.to(device))
    return outs[0].detach().cpu(), [x.cpu() for x in grads]


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=TOL,
                               atol=TOL * max(float(want.abs().max()), 1.0), err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_on_card_equals_cpu(cuda_device, causal):
    """GQA attention (B 2, S 64, H 8, KV 2, D 64), float32: the kernel's output and
    the recomputed backward's dq, dk, dv against the CPU's; one kernel launch."""
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((2, 64, 8, 64), (2, 64, 2, 64), (2, 64, 2, 64), (2, 64, 8, 64)))
    fn = lambda q, k, v: ta.flash_attn(q, k, v, causal=causal)
    want, wgrads = _grads_on(fn, (q, k, v), g, "cpu")
    _build.launches.clear()
    got, ggrads = _grads_on(fn, (q, k, v), g, cuda_device)
    torch.cuda.synchronize()
    assert _build.launches["flash_attention"] == 1
    _close(got, want, "out")
    for name, a, b in zip("qkv", ggrads, wgrads):
        _close(a, b, f"d{name}")


@pytest.mark.cuda
def test_ssd_function_on_card_equals_cpu(cuda_device):
    """The SSD route (B 2, S 64, H 4, P 16, G 2, N 16, chunk 16), float32: y, the
    final state and the gradients of all five inputs against the CPU's."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 64, 4, 16)).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((2, 64, 4)))).astype(np.float32))
    a = -torch.from_numpy(np.exp(rng.standard_normal(4) * 0.5).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 64, 2, 16)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((2, 64, 2, 16)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 64, 4, 16)).astype(np.float32))
    fn = lambda *t: tmb.ssd_chunked(*t, chunk=16)
    want, wgrads = _grads_on(fn, (x, dt, a, b, c), g, "cpu")
    _build.launches.clear()
    got, ggrads = _grads_on(fn, (x, dt, a, b, c), g, cuda_device)
    torch.cuda.synchronize()
    assert _build.launches["ssd_chunk"] == 1
    _close(got, want, "y")
    for name, p, q in zip(("x", "dt", "a", "b", "c"), ggrads, wgrads):
        _close(p, q, f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernel,mixer", [("h2o-danube-1.8b", "flash_attention", "attn"),
                                               ("mamba2-780m", "ssd_chunk", "mamba")])
@pytest.mark.parametrize("remat", ["none", "nothing"])
def test_train_step_on_card_equals_cpu(cuda_device, name, kernel, mixer, remat):
    """One ``make_train_step`` of the reduced model in float32 (batch 2 × 16, within
    danube's reduced 16-token window so attention takes the kernel), the same
    weights on both: every gradient finite and not identically zero on the card and
    within 1e-4 of the CPU's; loss and masters within 1e-4; the kernel launched once
    per layer per forward (twice with ``remat="nothing"``)."""
    cfg = replace(reduced_for_smoke(ARCHS[name]), dtype="float32", remat=remat)
    cpu_model = tm.init_params(cfg, seed=3, device="cpu")
    card = copy.deepcopy(cpu_model).to(cuda_device)
    raw = synth_batch(cfg, step=0, global_batch=2, seq=16)
    tcfg = tstep.TrainConfig(adamw=AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10))
    step_fn = tstep.make_train_step(cfg, tcfg)
    out = {}
    for side, model, dev in (("cpu", cpu_model, "cpu"), ("card", card, cuda_device)):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        grads, _ = tstep.loss_and_grads(cfg, model, batch)
        state = tstep.init_train_state(cfg, tcfg, model)
        _build.launches.clear()
        model, state, metrics = step_fn(model, state, batch)
        if dev != "cpu":
            torch.cuda.synchronize()
        out[side] = ({k: g.detach().cpu() for k, g in grads.items()}, state, metrics,
                     _build.launches[kernel])
    n_mixer = sum(cfg.block_at(i).mixer == mixer for i in range(cfg.n_layers))
    assert out["card"][3] == n_mixer * (1 if remat == "none" else 2) > 0
    for k, g in out["card"][0].items():
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), k
        w = out["cpu"][0][k]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL,
                                   atol=TOL * float(w.abs().max()), err_msg=k)
    np.testing.assert_allclose(float(out["card"][2]["loss"]), float(out["cpu"][2]["loss"]),
                               rtol=TOL, atol=TOL)
    outside = 0
    for k, m in out["cpu"][1]["adamw"]["master"].items():
        err = (out["card"][1]["adamw"]["master"][k].cpu() - m).abs()
        bad = err > TOL + TOL * m.abs()
        outside += int(bad.sum())
        g = out["cpu"][0][k].abs()
        assert not bool((bad & (g > TOL * float(g.max()))).any()), k
    assert outside <= 1e-5 * sum(p.numel() for p in cpu_model.parameters())
