"""The port's ``make_train_step`` ≡ the JAX package's in bf16, on the CPU: reduced
h2o-danube-1.8b in its own bf16 (every leaf bf16, so the reference's recast of
parameters to its first leaf's dtype does not arise), three AdamW steps through
both packages from the same weights, the reference's float32 step from those
weights upcast as the yardstick.

The limits come from bf16 rounding, after ``ref.flash_attention_bf16_tolerance``:

* **Loss, each step.** bf16's unit roundoff is 2^-8 and each side rounds every
  logit once: |δz_j| ≤ 2^-7·|z_j| between the two. Cross entropy's gradient in
  the logits is p − onehot(label), so the loss moves by at most
  L = 2^-7 · mean over tokens of (|z_label| + Σ_j p_j·|z_j|), computed from the
  reference's bf16 logits at that step's parameters. ``ce`` is held to the same
  L; ``aux`` is 0 for a dense model on both sides.
* **Each fp32 master, elementwise.** Where a gradient element is zero within
  its bf16 rounding, the sign and size of its update are decided by rounding;
  AdamW's normalised step caps how far that carries it: |m̂_t/√v̂_t| ≤ U_t =
  sqrt(Σ_i a_i²/b_i) (Cauchy–Schwarz over the moments' weights a_i =
  (1−b1)·b1^(t−i)/(1−b1^t), b_i = (1−b2)·b2^(t−i)/(1−b2^t)), so two runs' masters
  part by at most D_t = D_{t−1}·(1 + lr_t·wd) + 2·lr_t·U_t, plus 2^-22·|w| for the
  fp32 arithmetic.
* **Each leaf's masters, together.** No further from the float32 step's masters,
  in L2, than twice the reference's bf16 masters are (plus 2^-22 of their norm):
  the rule ``torch_lm_parity.BF16_ROUNDING_DECIDED`` applies to logits, with the
  reference's own bf16 rounding as the yardstick.
"""

import copy
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_lm_parity import Built, batches, f32, np_tree

from repro.models import model as jm
from repro.train import step as jstep
from repro.train.optimizer import AdamWConfig as JAdamW
from repro_torch.models.convert import by_name
from repro_torch.train import step as tstep
from repro_torch.train.optimizer import AdamWConfig as TAdamW

ARCH = "h2o-danube-1.8b"
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
STEPS = 3


def loss_limit(cfg, params, jbatch) -> float:
    """2^-7 · mean(|z_label| + Σ_j p_j |z_j|) over the loss's tokens."""
    logits, _ = jm.model_forward(cfg, params, jbatch)
    z = np.asarray(logits.astype(jnp.float32))[:, :-1].astype(np.float64)
    labels = np.asarray(jbatch["labels"])[:, 1:]
    p = np.exp(z - z.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    z_label = np.abs(np.take_along_axis(z, labels[..., None], -1))[..., 0]
    return 2.0 ** -7 * float(np.mean(z_label + (p * np.abs(z)).sum(-1)))


def adam_direction_bound(t: int, b1: float, b2: float) -> float:
    """U_t: the largest |m̂_t / √v̂_t| over any gradients."""
    a = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
    b = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
    return math.sqrt(sum(x * x / y for x, y in zip(a, b)))


@pytest.fixture(scope="module")
def runs():
    cfg, params, model = Built()(ARCH)
    assert {str(a.dtype) for a in jax.tree.leaves(params)} == {"bfloat16"}
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    model = copy.deepcopy(model)
    jt = jstep.TrainConfig(adamw=JAdamW(**ADAMW))
    tt = tstep.TrainConfig(adamw=TAdamW(**ADAMW))
    cfg32 = replace(cfg, dtype="float32")
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    jfn, jfn32 = jax.jit(jstep.make_train_step(cfg, jt)), jax.jit(jstep.make_train_step(cfg32, jt))
    tfn = tstep.make_train_step(cfg, tt)
    js, js32 = jstep.init_train_state(cfg, jt, params), jstep.init_train_state(cfg32, jt, p32)
    ts = tstep.init_train_state(cfg, tt, model)
    jp, steps = params, []
    for i in range(STEPS):
        jb, tb = batches(cfg, step=i, batch=4)
        limit = loss_limit(cfg, jp, jb)
        jp, js, jmet = jfn(jp, js, jb)
        p32, js32, _ = jfn32(p32, js32, jb)
        model, ts, tmet = tfn(model, ts, tb)
        steps.append({"limit": limit, "ref": {k: float(v) for k, v in jmet.items()},
                      "port": {k: float(v) for k, v in tmet.items()}})
    return {"cfg": cfg, "steps": steps, "model": model, "port": ts, "ref": js, "f32": js32,
            "w0": by_name(cfg, np_tree(params))}


@pytest.mark.parametrize("step", range(STEPS))
def test_bf16_loss_within_the_logits_rounding_limit(runs, step):
    s = runs["steps"][step]
    assert 0 < s["limit"] < 1e-2, s["limit"]
    for k in ("loss", "ce"):
        assert abs(s["port"][k] - s["ref"][k]) <= s["limit"], (k, s)
    assert s["port"]["aux"] == s["ref"]["aux"] == 0.0
    assert s["port"]["lr"] == pytest.approx(s["ref"]["lr"], rel=1e-6)


def test_bf16_masters_within_adamw_rounding_decided_bound(runs):
    a = ADAMW | {"b1": 0.9, "b2": 0.95, "wd": 0.1}
    bound = 0.0
    for t, s in enumerate(runs["steps"], start=1):
        lr = s["ref"]["lr"]
        bound = bound * (1 + lr * a["wd"]) + 2 * lr * adam_direction_bound(t, a["b1"], a["b2"])
    cfg = runs["cfg"]
    want = by_name(cfg, np_tree(runs["ref"]["adamw"]["master"]))
    moved = 0
    for k, w in want.items():
        got = f32(runs["port"]["adamw"]["master"][k])
        err = np.abs(got - w)
        assert (err <= bound + 2.0 ** -22 * np.abs(w)).all(), (k, float(err.max()), bound)
        moved += int((got != runs["w0"][k]).sum())
    assert moved > 0
    assert int(runs["port"]["adamw"]["step"]) == int(runs["ref"]["adamw"]["step"]) == STEPS
    for k, p in runs["model"].named_parameters():
        assert torch.equal(p, runs["port"]["adamw"]["master"][k].to(p.dtype)), k


def test_bf16_masters_no_further_from_float32_than_twice_the_reference(runs):
    cfg = runs["cfg"]
    ref = by_name(cfg, np_tree(runs["ref"]["adamw"]["master"]))
    exact = by_name(cfg, np_tree(runs["f32"]["adamw"]["master"]))
    for k, e in exact.items():
        port = np.linalg.norm(f32(runs["port"]["adamw"]["master"][k]) - e)
        theirs = np.linalg.norm(ref[k] - e)
        assert port <= 2 * theirs + 2.0 ** -22 * np.linalg.norm(e), (k, port, theirs)
