"""The port's prefill, cache and decode ≡ the JAX package's, on the CPU, for all ten
reduced archs in their float32 variants: the JAX weights carried across by
``params_from_numpy``, ``prefill``'s last-token logits and every cache leaf, then
four greedy ``decode_step``s, within 1e-4 absolute plus 1e-4 relative and with
identical greedy tokens; the rotating window buffer; and the port's twins of the
JAX suite's decode-matches-forward tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_lm_parity import ARCH_NAMES, F32_TOL, Built, assert_close, batches, f32, np_tree, reduced

from repro.models import model as jm
from repro_torch.models import model as tm
from repro_torch.models.convert import cache_from_numpy


@pytest.fixture(scope="module")
def built():
    return Built()


def _assert_cache_equal(cfg, cache, jcache, what):
    """Every leaf of the port's cache against the JAX one's, unstacked per layer."""
    want = cache_from_numpy(cfg, np_tree(jcache), "cpu")
    assert cache["pos"] == want["pos"] == int(jcache["pos"])
    assert len(cache["layers"]) == len(want["layers"]) == cfg.n_layers
    for j, (got, ref) in enumerate(zip(cache["layers"], want["layers"])):
        assert sorted(got) == sorted(ref), (j, sorted(got), sorted(ref))
        for k in ref:
            assert_close(got[k], ref[k], F32_TOL, f"{what}: layer {j} {k}")
    if cfg.is_encdec:
        assert_close(cache["enc_out"], want["enc_out"], F32_TOL, f"{what}: enc_out")


def _prefill_then_decode(name, built, seq, cache_len, steps=4):
    cfg, params, model = built(name, "float32")
    jb, tb = batches(cfg, seq=seq)
    jlogits, jcache = jax.jit(lambda p, b: jm.prefill(cfg, p, b, cache_len=cache_len))(params, jb)
    with torch.no_grad():
        logits, cache = tm.prefill(cfg, model, tb, cache_len=cache_len)
    assert_close(logits, jlogits, F32_TOL, "prefill logits")
    _assert_cache_equal(cfg, cache, jcache, "prefill")
    jstep = jax.jit(lambda p, c, t: jm.decode_step(cfg, p, c, t))
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok), err_msg=f"step {i}")
        jlogits, jcache = jstep(params, jcache, jtok)
        with torch.no_grad():
            logits, cache = tm.decode_step(cfg, model, cache, tok)
        assert_close(logits, jlogits, F32_TOL, f"decode step {i}")
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        tok = torch.argmax(logits, -1).to(torch.int32)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _assert_cache_equal(cfg, cache, jcache, f"after {steps} steps")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_f32_match_reference(built, name):
    """S = 32 (internvl2: 8 vision embeddings + 24 tokens), batch 2, cache
    headroom 8; within 1e-4, identical greedy tokens over 4 steps."""
    _prefill_then_decode(name, built, seq=32, cache_len=40)


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "gemma3-12b"])
def test_rotating_window_cache_matches_reference(built, name):
    """A 20-token prompt into 16-slot windowed caches (20 % 16 = 4: the prefill
    rolls them, decode writes slot pos % 16), then 4 steps; within 1e-4."""
    _prefill_then_decode(name, built, seq=20, cache_len=24)


def test_init_cache_layout():
    """init_cache mirrors prefill's cache: per-layer leaves of the same shapes."""
    cfg = reduced("jamba-1.5-large-398b", "float32")
    model = tm.init_params(cfg, seed=0, device="cpu")
    zero = tm.init_cache(cfg, batch=2, s_max=32, device="cpu")
    _, cache = tm.prefill(cfg, model, batches(cfg, seq=32)[1])
    assert zero["pos"] == 0 and cache["pos"] == 32
    for z, c in zip(zero["layers"], cache["layers"]):
        shapes = {k: tuple(v.shape) for k, v in c.items()}
        assert {k: tuple(v.shape) for k, v in z.items()} == shapes
        assert all(not bool(v.any()) for v in z.values())


def test_decode_matches_forward_dense():
    """internlm2-20b (full attention), cache sized for the whole sequence."""
    cfg = reduced("internlm2-20b")
    model = tm.init_params(cfg, seed=1, device="cpu")
    _check_teacher_forced(cfg, model, cache_len=16)


def test_decode_matches_forward_ssm():
    """mamba2-780m: recurrent decode ≡ the chunked-parallel forward."""
    cfg = reduced("mamba2-780m")
    model = tm.init_params(cfg, seed=2, device="cpu")
    _check_teacher_forced(cfg, model, cache_len=None)


def _check_teacher_forced(cfg, model, cache_len, seq=16):
    """Teacher-forced decode reproduces the forward logits, bf16, within 2e-2
    (the JAX suite's tolerance, ``tests/test_models_smoke.py``)."""
    _, tb = batches(cfg, seq=seq, batch=1)
    with torch.no_grad():
        full, _ = tm.model_forward(cfg, model, tb)
        pre = {"tokens": tb["tokens"][:, :seq - 4], "labels": tb["labels"][:, :seq - 4]}
        logits, cache = tm.prefill(cfg, model, pre, cache_len=cache_len)
        np.testing.assert_allclose(f32(logits), f32(full[:, seq - 5]), rtol=2e-2, atol=2e-2)
        for i in range(seq - 4, seq):
            logits, cache = tm.decode_step(cfg, model, cache, tb["tokens"][:, i])
            np.testing.assert_allclose(f32(logits), f32(full[:, i]), rtol=2e-2, atol=2e-2)


def test_cross_attention_sees_every_frame(built):
    """Whisper's decoder cross-attends to all encoder frames, also when it has
    fewer tokens than frames (4 tokens, 8 frames): the port's teacher-forced
    decode then equals its forward within 1e-4. The JAX package's forward slices
    the keys of a bidirectional span to [0, S) (``chunked_attention``), so its
    forward sees 4 of the 8 frames while its decode sees all 8, and the two differ
    by more than 1e-2 (a fault of the reference, not ported; equal S ≥ frames is
    held in ``test_prefill_and_decode_f32_match_reference``)."""
    cfg, params, model = built("whisper-small", "float32")
    jb, tb = batches(cfg, seq=4, batch=1)
    assert cfg.n_frontend == 8
    jpre = {k: v[:, :3] if k in ("tokens", "labels") else v for k, v in jb.items()}
    tpre = {k: v[:, :3] if k in ("tokens", "labels") else v for k, v in tb.items()}
    with torch.no_grad():
        full, _ = tm.model_forward(cfg, model, tb)
        _, cache = tm.prefill(cfg, model, tpre, cache_len=4)
        logits, _ = tm.decode_step(cfg, model, cache, tb["tokens"][:, 3])
    assert_close(logits, full[:, 3], F32_TOL, "port decode vs port forward")
    jfull, _ = jm.model_forward(cfg, params, jb)
    _, jcache = jm.prefill(cfg, params, jpre, cache_len=4)
    jlogits, _ = jm.decode_step(cfg, params, jcache, jb["tokens"][:, 3])
    assert float(np.abs(f32(jlogits) - f32(jfull[:, 3])).max()) > 1e-2
