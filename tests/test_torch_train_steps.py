"""The port's ``make_train_step`` ≡ the JAX package's, on the CPU: three AdamW steps
on all ten reduced archs in float32, with one and with two microbatches, the JAX
weights carried across; and the rematerialisation modes (``cfg.remat``), which
change no gradient and run the repeated layers' forward, kernels included, a
second time in the backward.

Tolerance: the fp32 masters after three steps within 1e-4 + 1e-4·|ref| (the serve
parity's), the metrics (loss, ce, aux, grad_norm, lr) likewise. One exception,
counted: AdamW's first update of an element is lr·g/(|g| + 1e-8), so where an
element's gradient is zero within the gradient parity's own limit (1e-4 of its
leaf's largest |g|, ``test_torch_train.py``) the size and sign of that update are
decided by rounding, not by the algorithm. Such elements may leave the limit,
at most one in 10^5 of an arch's parameters; every other element is held.
"""

import copy
from dataclasses import replace

import chip_smoke
import jax
import numpy as np
import pytest
import torch
from torch_lm_parity import ARCH_NAMES, F32_TOL, Built, assert_close, batches, f32, np_tree

from repro.train import step as jstep
from repro.train.optimizer import AdamWConfig as JAdamW
from repro_torch.configs import ARCHS, reduced_for_smoke
from repro_torch.kernels import ref
from repro_torch.models import model as tm
from repro_torch.models.convert import by_name
from repro_torch.train import step as tstep
from repro_torch.train.data import synth_batch
from repro_torch.train.optimizer import AdamWConfig as TAdamW

ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
ROUNDING_DECIDED_MAX = 1e-5


@pytest.fixture(scope="module")
def built():
    return Built()


class GradLog:
    """Keeps the gradients each ``adamw_update`` of the port's train step receives."""

    def __init__(self, monkeypatch):
        self.steps = []
        orig = tstep.adamw_update

        def logged(cfg, params, grads, state):
            self.steps.append({k: g.detach().float().clone() for k, g in grads.items()})
            return orig(cfg, params, grads, state)

        monkeypatch.setattr(tstep, "adamw_update", logged)

    def near_zero(self, name: str) -> np.ndarray:
        """Elements whose gradient was zero within the gradient limit at some step."""
        out = None
        for g in self.steps:
            a = g[name].abs()
            hit = (a <= F32_TOL * float(a.max())).numpy()
            out = hit if out is None else out | hit
        return out


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_three_train_steps_match_reference(built, monkeypatch, name, microbatches):
    """Three steps of batch 4 × 32 (``synth_batch`` steps 0-2), AdamW lr 1e-3 with
    one warmup step: each step's metrics, then every fp32 master, moment and the
    step count against the reference's ``jax.jit(make_train_step)``."""
    cfg, params, model = built(name, "float32")
    model = copy.deepcopy(model)
    jt = jstep.TrainConfig(adamw=JAdamW(**ADAMW), microbatches=microbatches)
    tt = tstep.TrainConfig(adamw=TAdamW(**ADAMW), microbatches=microbatches)
    jfn, tfn = jax.jit(jstep.make_train_step(cfg, jt)), tstep.make_train_step(cfg, tt)
    jstate, tstate = jstep.init_train_state(cfg, jt, params), tstep.init_train_state(cfg, tt, model)
    log = GradLog(monkeypatch)
    jp = params
    for i in range(3):
        jb, tb = batches(cfg, step=i, batch=4)
        jp, jstate, jmet = jfn(jp, jstate, jb)
        model, tstate, tmet = tfn(model, tstate, tb)
        assert sorted(tmet) == sorted(jmet) == ["aux", "ce", "grad_norm", "loss", "lr"]
        for k in jmet:
            assert_close(tmet[k], jmet[k], F32_TOL, f"step {i} {k}")
    assert int(tstate["adamw"]["step"]) == int(jstate["adamw"]["step"]) == 3
    excused = total = 0
    for part in ("master", "m", "v"):
        want = by_name(cfg, np_tree(jstate["adamw"][part]))
        for k, w in want.items():
            got = f32(tstate["adamw"][part][k])
            out = np.abs(got - w) > F32_TOL + F32_TOL * np.abs(w)
            if part == "master":
                total += w.size
                excused += int(out.sum())
                out &= ~log.near_zero(k)
            assert not out.any(), (part, k, np.argwhere(out)[:4], got[out][:4], w[out][:4])
    assert excused <= ROUNDING_DECIDED_MAX * total, (excused, total)
    for k, p in model.named_parameters():
        assert torch.equal(p, tstate["adamw"]["master"][k].to(p.dtype)), k


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "mamba2-780m", "jamba-1.5-large-398b",
                                  "deepseek-moe-16b"])
def test_remat_modes_change_no_gradient_and_count_kernel_calls(monkeypatch, name):
    """``remat="nothing"`` and ``"dots"`` give the gradients of ``"none"`` bit for
    bit, and one gradient computation calls each kernel route once per layer of its
    mixer per forward: ``chip_smoke.kernel_calls_per_step``, the count the card's
    train phase asserts (the prefix layers once, the repeated layers twice when
    rematerialised)."""
    base = replace(reduced_for_smoke(ARCHS[name]), dtype="float32")
    model = tm.init_params(base, seed=0, device="cpu")
    raw = synth_batch(base, step=0, global_batch=2, seq=16)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    calls = {"flash_attention": 0, "ssd_chunk": 0}

    def counted(kernel, fn):
        def wrapped(*a, **k):
            calls[kernel] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ref, "flash_attention_ref", counted("flash_attention",
                                                            ref.flash_attention_ref))
    monkeypatch.setattr(ref, "ssd_chunked_ref", counted("ssd_chunk", ref.ssd_chunked_ref))
    grads = {}
    for remat in ("none", "nothing", "dots"):
        cfg = replace(base, remat=remat)
        calls.update(flash_attention=0, ssd_chunk=0)
        grads[remat], _ = tstep.loss_and_grads(cfg, model, batch)
        want = {"flash_attention": chip_smoke.kernel_calls_per_step(cfg, "attn"),
                "ssd_chunk": chip_smoke.kernel_calls_per_step(cfg, "mamba")}
        assert calls == want, (remat, calls, want)
    assert sum(want.values()) > 0
    for remat in ("nothing", "dots"):
        for k, g in grads["none"].items():
            assert torch.equal(grads[remat][k], g), (remat, k)


def test_dots_remat_keeps_the_matmul_outputs():
    """``remat="dots"`` recomputes no matrix product in the backward (the backward
    runs as many as with ``"none"``); ``"nothing"`` recomputes every forward one."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountDots(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in tm._DOT_OPS:
                self.n += 1
            return func(*args, **(kwargs or {}))

    base = replace(reduced_for_smoke(ARCHS["h2o-danube-1.8b"]), dtype="float32")
    model = tm.init_params(base, seed=0, device="cpu").requires_grad_(True)
    raw = synth_batch(base, step=0, global_batch=2, seq=16)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    counts, forward = {}, None
    for remat in ("none", "nothing", "dots"):
        cfg = replace(base, remat=remat)
        with CountDots() as fwd:
            loss, _ = tm.loss_fn(cfg, model, batch)
        with CountDots() as bwd:
            torch.autograd.grad(loss, list(model.parameters()))
        counts[remat], forward = bwd.n, fwd.n
    assert counts["dots"] == counts["none"]
    assert counts["nothing"] > counts["none"]
    assert forward > 0
