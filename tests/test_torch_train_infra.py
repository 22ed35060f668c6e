"""Twins of the reference's training-infrastructure tests (``test_train_infra.py``,
and ``test_models_smoke.py``'s ``test_train_step`` / ``test_loss_decreases``) on the
port, on the CPU: checkpoint restart bit for bit, async saves and garbage
collection, a torn write never becoming the resume point, ``retry``, the lr
schedule, int8 round trip and error feedback, compressed training converging,
microbatch accumulation, and one step of every reduced arch. Where a value is
compared, it is held against the JAX package's (tolerances stated per test).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_lm_parity import ARCH_NAMES, reduced

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_for_smoke as jreduced
from repro.models import model as jm
from repro.train import optimizer as jopt
from repro_torch.models.model import init_params
from repro_torch.train.checkpoint import CheckpointManager, named_leaves
from repro_torch.train.data import synth_batch
from repro_torch.train.fault import retry
from repro_torch.train.optimizer import (
    AdamWConfig,
    compress_int8,
    compressed_grads_with_ef,
    decompress_int8,
    init_ef_state,
    lr_at,
)
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step


@pytest.fixture(scope="module")
def tiny():
    cfg = reduced("h2o-danube-1.8b")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _batch(cfg, step, batch=2, seq=16):
    return {k: torch.from_numpy(v)
            for k, v in synth_batch(cfg, step=step, global_batch=batch, seq=seq).items()}


def _same_state(a, b) -> None:
    la, lb = list(named_leaves(a)), list(named_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y), k


def test_checkpoint_restart_bitexact(tmp_path, tiny):
    """Train 5 steps (bf16); checkpoint at step 2; restart from it → steps 3-4 give
    the same losses and the same final parameters and optimizer state, bit for bit."""
    cfg, params0 = tiny
    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20))
    step_fn = make_train_step(cfg, tcfg)
    mgr = CheckpointManager(tmp_path / "ckpt")

    params = copy.deepcopy(params0)
    state = init_train_state(cfg, tcfg, params)
    trace = []
    for i in range(5):
        params, state, m = step_fn(params, state, _batch(cfg, i))
        trace.append(float(m["loss"]))
        if i == 2:
            mgr.save(i, {"params": params, "opt": state}, {"arch": cfg.name})

    latest = mgr.latest_step()
    assert latest == 2
    restored, meta = mgr.restore(latest, {"params": params, "opt": state})
    assert meta["step"] == 2 and meta["arch"] == cfg.name
    params2, state2 = restored["params"], restored["opt"]
    assert params2 is not params
    trace2 = []
    for i in range(3, 5):
        params2, state2, m = step_fn(params2, state2, _batch(cfg, i))
        trace2.append(float(m["loss"]))
    assert trace[3:] == trace2
    _same_state({"params": params, "opt": state}, {"params": params2, "opt": state2})


def test_checkpoint_async_and_gc(tmp_path, tiny):
    cfg, params = tiny
    mgr = CheckpointManager(tmp_path / "c2", keep=2)
    for s in range(4):
        mgr.save_async(s, {"params": params}, {"arch": cfg.name})
    mgr.wait()
    assert sorted(mgr.all_steps()) == [2, 3]
    restored, meta = mgr.restore(3, {"params": params})
    assert meta["step"] == 3
    _same_state({"params": params}, restored)


def test_checkpoint_restores_onto_the_template_dtype_and_device(tmp_path, tiny):
    """bf16 leaves go through the file as float32 (exactly) and come back bf16; an
    int32 step stays int32; a leaf missing from the file or of another shape raises."""
    cfg, params = tiny
    state = {"params": params, "opt": {"step": torch.tensor(7, dtype=torch.int32),
                                       "w": torch.randn(3, 4, dtype=torch.bfloat16)}}
    mgr = CheckpointManager(tmp_path / "c4")
    mgr.save(0, state)
    restored, _ = mgr.restore(0, state)
    _same_state(state, restored)
    assert restored["opt"]["step"].dtype == torch.int32
    with pytest.raises(KeyError):
        mgr.restore(0, {**state, "extra": torch.zeros(2)})
    with pytest.raises(ValueError):
        mgr.restore(0, {**state, "opt": {**state["opt"], "w": torch.zeros(4, 3)}})


def test_checkpoint_corruption_safe(tmp_path, tiny):
    """A torn write (tmp file) never becomes the resume point."""
    cfg, params = tiny
    mgr = CheckpointManager(tmp_path / "c3")
    mgr.save(1, {"params": params})
    (tmp_path / "c3" / "ckpt_00000002.npz.tmp").write_bytes(b"garbage")
    assert mgr.latest_step() == 1


def test_retry():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return 42

    assert retry(flaky, attempts=4, backoff_s=0.001) == 42
    assert len(calls) == 3


def test_retry_gives_up_and_passes_other_errors():
    calls = []

    def always():
        calls.append(1)
        raise OSError("down")

    with pytest.raises(OSError):
        retry(always, attempts=2, backoff_s=0.001)
    assert len(calls) == 2
    with pytest.raises(ValueError):
        retry(lambda: int("x"), attempts=3, backoff_s=0.001)


def test_lr_schedule():
    """The reference test's points, equal to the reference's ``lr_at``."""
    c = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    jc = jopt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    assert float(lr_at(c, torch.tensor(5))) == pytest.approx(0.5)
    assert float(lr_at(c, torch.tensor(110))) == pytest.approx(0.1, abs=1e-3)
    for s in (5, 110):
        assert float(lr_at(c, torch.tensor(s))) == pytest.approx(
            float(jopt.lr_at(jc, jnp.array(s))), rel=1e-6)


def test_int8_roundtrip_error_bounded():
    """Within half a quantization step, with the reference's codes."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 64)).astype(np.float32)
    q, s = compress_int8(torch.from_numpy(x))
    err = (decompress_int8(q, s) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6
    jq, _ = jopt.compress_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_error_feedback_accumulates():
    """EF makes the *sum* of compressed grads converge to the sum of true grads,
    within one quantization step, and the sum sent equals the reference's within
    1e-6 of the largest |g|."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(128,)).astype(np.float32) * 1e-3
    ef = init_ef_state({"w": torch.from_numpy(w)})
    jef = jopt.init_ef_state({"w": jnp.asarray(w)})
    total_true = np.zeros(128, np.float32)
    total_sent = np.zeros(128, np.float32)
    jsent = np.zeros(128, np.float32)
    for _ in range(50):
        deq, ef = compressed_grads_with_ef({"w": torch.from_numpy(w)}, ef)
        jdeq, jef = jopt.compressed_grads_with_ef({"w": jnp.asarray(w)}, jef)
        total_true += w
        total_sent += deq["w"].numpy()
        jsent += np.asarray(jdeq["w"])
    resid = np.abs(total_true - total_sent).max()
    one_step = float(np.abs(w).max()) / 127 * 2
    assert resid <= one_step + 1e-5
    np.testing.assert_allclose(total_sent, jsent, rtol=0, atol=1e-6 * np.abs(w).max())


def test_compressed_training_converges(tiny):
    cfg, params = tiny
    params = copy.deepcopy(params)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=50),
                       compress_grads=True)
    step_fn = make_train_step(cfg, tcfg)
    state = init_train_state(cfg, tcfg, params)
    assert sorted(state) == ["adamw", "ef"]
    batch = _batch(cfg, 0)
    losses = []
    for _ in range(8):
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
    assert any(bool(e.abs().max() > 0) for e in state["ef"].values())


def test_microbatch_accumulation_matches_full_batch(tiny):
    """Gradient accumulation over 2 microbatches ≈ the single-batch step on the same
    data (bf16; the reference test's 5e-2)."""
    cfg, params = tiny
    batch = _batch(cfg, 0)
    t1 = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20))
    t2 = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20), microbatches=2)
    p1, p2 = copy.deepcopy(params), copy.deepcopy(params)
    p1, _, _ = make_train_step(cfg, t1)(p1, init_train_state(cfg, t1, p1), batch)
    p2, _, _ = make_train_step(cfg, t2)(p2, init_train_state(cfg, t2, p2), batch)
    for (k, a), (_, b) in zip(p1.named_parameters(), p2.named_parameters()):
        np.testing.assert_allclose(a.detach().float().numpy(), b.detach().float().numpy(),
                                   atol=5e-2, rtol=5e-2, err_msg=k)


# -- test_models_smoke.py's training half -------------------------------------------


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_train_step(name):
    """One step of each reduced arch in its bf16 (batch 2 × 32): finite loss and
    grad norm, the parameters moved, each kept its dtype, and as many parameters
    as the reference's ``init_params`` makes."""
    cfg = reduced(name)
    params = init_params(cfg, seed=0, device="cpu")
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    state = init_train_state(cfg, tcfg, params)
    new, state, metrics = make_train_step(cfg, tcfg)(params, state, _batch(cfg, 0, seq=32))
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    delta = sum(float((p.detach().float() - before[k].float()).abs().max())
                for k, p in new.named_parameters())
    assert delta > 0
    assert all(p.dtype == before[k].dtype for k, p in new.named_parameters())
    shapes = jax.eval_shape(lambda: jm.init_params(jreduced(JARCHS[name]), jax.random.PRNGKey(0)))
    assert sum(p.numel() for p in new.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))


def test_loss_decreases():
    """A few steps on the tiny dense arch: loss must drop on a repeated batch."""
    cfg = reduced("h2o-danube-1.8b")
    params = init_params(cfg, seed=3, device="cpu")
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=50))
    step = make_train_step(cfg, tcfg)
    state = init_train_state(cfg, tcfg, params)
    batch = _batch(cfg, 0, batch=4, seq=32)
    losses = []
    for _ in range(8):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
