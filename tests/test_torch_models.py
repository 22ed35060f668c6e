"""The port's LM substrate (``repro_torch.configs``, ``repro_torch.models``) ≡ the
JAX package's, on the CPU: the configs field by field, each module on the same
numpy inputs, and the whole forward of all ten reduced archs with the JAX weights
carried across by ``params_from_numpy``.

Tolerances (stated per test): float32 within 1e-4 absolute plus 1e-4 relative;
bf16 within the JAX suite's 2e-2. The whole model in bf16 is held in
``test_torch_models_bf16.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_lm_parity import (ARCH_NAMES, BF16_TOL, F32_TOL, Built, assert_close, batches, f32,
                             np_tree, reduced)

from repro import configs as jconfigs
from repro.models import attention as ja
from repro.models import layers as jl
from repro.models import mamba as jmb
from repro.models import model as jm
from repro.models import moe as jmo
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import mamba as tmb
from repro_torch.models import model as tm
from repro_torch.models import moe as tmo
from repro_torch.models.convert import layer_trees, params_from_numpy
from repro_torch.models.layers import Init, Params


@pytest.fixture(scope="module")
def built():
    return Built()


def _pair(rng, shape, scale=1.0, dtype="float32"):
    """The same numpy draw as a JAX array and a torch tensor of ``dtype``."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return (jnp.asarray(a).astype(jnp.dtype(dtype)),
            torch.from_numpy(a).to(tl.DTYPES[dtype]))


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_arch_config_fields_equal_reference(name):
    ref, port = jconfigs.get_arch(name), tconfigs.get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(tconfigs.reduced_for_smoke(port))
            == dataclasses.asdict(jconfigs.reduced_for_smoke(ref)))
    for prop in ("vocab_padded", "d_inner", "ssm_nheads", "n_repeats", "is_subquadratic"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    for shape in jconfigs.SHAPES:
        assert (tconfigs.shape_applicable(port, tconfigs.SHAPES[shape])
                == jconfigs.shape_applicable(ref, jconfigs.SHAPES[shape]))


def test_registry_and_shapes_equal_reference():
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    assert ({k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})
    with pytest.raises(KeyError):
        tconfigs.get_arch("no-such-arch")


# -- layers ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_norms_match_reference(dtype, tol):
    """rms_norm (eps 1e-6, scale 1 + s) and layer_norm (eps 1e-5), fp32 statistics;
    within 1e-4 in float32, 2e-2 in bf16."""
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (2, 8, 64), dtype=dtype)
    js, ts = _pair(rng, (64,), 0.1, dtype)
    jb, tb = _pair(rng, (64,), 0.1, dtype)
    assert_close(tl.rms_norm(tx, ts), jl.rms_norm(jx, js), tol, "rms_norm")
    assert_close(tl.layer_norm(tx, 1 + ts, tb), jl.layer_norm(jx, 1 + js, jb), tol, "layer_norm")


def test_rope_matches_reference():
    """rope_cos_sin and apply_rope (half rotation, fp32) at positions up to 511,
    within 1e-4."""
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (2, 512, 4, 16))
    pos = np.arange(512)[None, :]
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), 16, 1e4)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), 16, 1e4)
    assert_close(tc, jc, F32_TOL, "cos")
    assert_close(ts, js, F32_TOL, "sin")
    assert_close(tl.apply_rope(tx, tc, ts), jl.apply_rope(jx, jc, js), F32_TOL, "apply_rope")


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    """The MLP in each activation (gelu: the tanh approximation), float32 within
    1e-4; and bf16 bit for bit (the activations round as the JAX package does)."""
    cfg = dataclasses.replace(reduced("h2o-danube-1.8b", "float32"), act=act)
    rng = np.random.default_rng(2)
    p = Params({k: torch.from_numpy((rng.standard_normal(s) * 0.2).astype(np.float32))
                for k, s in (("w_gate", (64, 128)), ("w_up", (64, 128)),
                             ("w_out", (128, 64)))})
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.named_parameters()}
    jx, tx = _pair(rng, (2, 8, 64))
    assert_close(tl.mlp_apply(cfg, p, tx), jl.mlp_apply(cfg, jp, jx), F32_TOL, act)
    bf = torch.bfloat16
    got = {"swiglu": tl.silu, "geglu": tl.gelu, "gelu": tl.gelu}[act](tx.to(bf))
    want = {"swiglu": jax.nn.silu, "geglu": jax.nn.gelu, "gelu": jax.nn.gelu}[act](
        jx.astype(jnp.bfloat16))
    np.testing.assert_array_equal(f32(got), f32(want))


def test_cross_entropy_matches_reference():
    """Mean CE with the padded vocab masked out of the logsumexp, within 1e-4."""
    cfg = reduced("h2o-danube-1.8b", "float32")
    rng = np.random.default_rng(3)
    jlog, tlog = _pair(rng, (2, 8, cfg.vocab_padded))
    labels = rng.integers(0, cfg.vocab, (2, 8))
    assert_close(tl.cross_entropy(cfg, tlog, torch.from_numpy(labels)),
                 jl.cross_entropy(cfg, jlog, jnp.asarray(labels)), F32_TOL)


# -- attention ------------------------------------------------------------------


@pytest.mark.parametrize("s,window,causal", [(32, 0, True), (16, 16, True), (32, 16, True),
                                             (40, 12, True), (32, 0, False)])
def test_chunked_attention_matches_reference(s, window, causal):
    """chunked_attention (GQA, 4 query heads on 2 KV heads) at S <= window and
    S > window, a chunk that does not divide the window, and bidirectional, with
    the same chunk as the reference (8), within 1e-4."""
    rng = np.random.default_rng(s + window)
    jq, tq = _pair(rng, (2, s, 4, 16))
    jk, tk = _pair(rng, (2, s, 2, 16))
    jv, tv = _pair(rng, (2, s, 2, 16))
    kw = dict(causal=causal, window=window, chunk=8)
    assert_close(ta.chunked_attention(tq, tk, tv, **kw), ja.chunked_attention(jq, jk, jv, **kw),
                 F32_TOL)


@pytest.mark.parametrize("case,args,want", [
    ("full causal", dict(q_len=4096, dk=80, dv=80, causal=True, window=0), True),
    ("S = window", dict(q_len=4096, dk=80, dv=80, causal=True, window=4096), True),
    ("S = window + 1", dict(q_len=4097, dk=80, dv=80, causal=True, window=4096), False),
    ("windowed, S < window", dict(q_len=16, dk=16, dv=16, causal=True, window=1024), True),
    ("non-causal cross", dict(q_len=32, dk=64, dv=64, causal=False, window=0), True),
    ("non-causal, windowed", dict(q_len=64, dk=64, dv=64, causal=False, window=16), True),
    ("MLA (Dk != Dv)", dict(q_len=32, dk=192, dv=128, causal=True, window=0), False),
    ("head dim not compiled", dict(q_len=32, dk=24, dv=24, causal=True, window=0), False),
])
def test_flash_eligible_decision_table(case, args, want):
    kw = dict(args)
    assert ta._flash_eligible(kw.pop("q_len"), **kw) is want, case


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the model's calls of ``ops.flash_attention``."""
    calls = []
    orig = ops.flash_attention

    def counted(*a, **k):
        calls.append(tuple(a[0].shape))
        return orig(*a, **k)

    monkeypatch.setattr(ta.ops, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("route,window,kv_heads", [("flash", 0, 2), ("flash", 32, 4),
                                                   ("chunked", 8, 2)])
def test_attn_apply_routes_match_reference(flash_calls, route, window, kv_heads):
    """attn_apply through the kernel's route (its plain version on the CPU) and
    the chunked route, GQA and MHA, S = 32, within 1e-4."""
    cfg = dataclasses.replace(reduced("h2o-danube-1.8b", "float32"), n_kv_heads=kv_heads)
    rng = np.random.default_rng(4)
    p = ta.attn_params(cfg, Init(torch.device("cpu"), torch.Generator().manual_seed(4)),
                       torch.float32)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.named_parameters()}
    jx, tx = _pair(rng, (2, 32, 64))
    pos = np.arange(32)[None, :]
    kw = dict(causal=True, window=window, rope_theta=1e4)
    got = ta.attn_apply(cfg, p, tx, positions=torch.from_numpy(pos), **kw)
    want = ja.attn_apply(cfg, jp, jx, positions=jnp.asarray(pos), **kw)
    assert_close(got, want, F32_TOL, route)
    assert flash_calls == ([(2 * 4, 32, 16)] if route == "flash" else [])


def test_cross_attention_goes_through_flash(flash_calls):
    """Non-causal cross-attention over 8 frames from 32 tokens (Sq != Sk) takes
    the kernel's route and matches the reference within 1e-4."""
    cfg = reduced("whisper-small", "float32")
    rng = np.random.default_rng(5)
    p = ta.attn_params(cfg, Init(torch.device("cpu"), torch.Generator().manual_seed(5)),
                       torch.float32)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.named_parameters()}
    jx, tx = _pair(rng, (2, 32, 64))
    jm_, tm_ = _pair(rng, (2, 8, 64))
    pos, mpos = np.arange(32)[None, :], np.arange(8)[None, :]
    got = ta.attn_apply(cfg, p, tx, positions=torch.from_numpy(pos), causal=False, window=0,
                        rope_theta=1e4, kv_override=(tm_, torch.from_numpy(mpos)))
    want = ja.attn_apply(cfg, jp, jx, positions=jnp.asarray(pos), causal=False, window=0,
                         rope_theta=1e4, kv_override=(jm_, jnp.asarray(mpos)))
    assert_close(got, want, F32_TOL)
    assert flash_calls == [(2 * 4, 32, 16)]


# -- Mamba-2 / SSD ------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk,groups", [(32, 8, 1), (24, 16, 2), (64, 64, 1)])
def test_ssd_chunked_kernel_route_matches_reference(s, chunk, groups):
    """The port's ssd_chunked (the ssd_chunk kernel's route; its plain version on
    the CPU) against the JAX package's ssd_chunked and ssd_reference, and the
    port's ssd_reference against the JAX one, float32, within 1e-4 (S = 24 with
    chunk 16 halves to 8, the reference's rule)."""
    rng = np.random.default_rng(s + chunk)
    h, p, n = 4, 16, 8
    jx, tx = _pair(rng, (2, s, h, p))
    dt = rng.uniform(0.01, 0.2, (2, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, h).astype(np.float32)
    jb, tb = _pair(rng, (2, s, groups, n))
    jc, tc = _pair(rng, (2, s, groups, n))
    want_y, want_s = jmb.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc, chunk)
    ref_y, ref_s = jmb.ssd_reference(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc)
    got_y, got_s = tmb.ssd_chunked(tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc, chunk)
    port_ref = tmb.ssd_reference(tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc)
    for got, want, what in ((got_y, want_y, "y"), (got_s, want_s, "state"),
                            (got_y, ref_y, "y vs ssd_reference"),
                            (got_s, ref_s, "state vs ssd_reference"),
                            (port_ref[0], ref_y, "port ssd_reference y"),
                            (port_ref[1], ref_s, "port ssd_reference state")):
        assert_close(got, want, F32_TOL, what)


def test_mamba_block_matches_reference():
    """mamba_apply, mamba_prefill's conv windows and state, and one mamba_decode
    step, reduced mamba2-780m in float32, within 1e-4."""
    cfg = reduced("mamba2-780m", "float32")
    p = tmb.mamba_params(cfg, Init(torch.device("cpu"), torch.Generator().manual_seed(6)),
                         torch.float32)
    with torch.no_grad():
        p.A_log.copy_(torch.linspace(-1.0, 1.0, cfg.ssm_nheads))
        p.dt_bias.copy_(torch.linspace(-2.0, 0.5, cfg.ssm_nheads))
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.named_parameters()}
    rng = np.random.default_rng(6)
    ju, tu = _pair(rng, (2, 16, 64))
    assert_close(tmb.mamba_apply(cfg, p, tu),
                 jax.jit(lambda q, u: jmb.mamba_apply(cfg, q, u))(jp, ju), F32_TOL, "apply")
    out, conv, state = tmb.mamba_prefill(cfg, p, tu)
    jout, jconv, jstate = jax.jit(lambda q, u: jmb.mamba_prefill(cfg, q, u))(jp, ju)
    assert_close(out, jout, F32_TOL, "prefill out")
    assert_close(state, jstate, F32_TOL, "prefill state")
    for k in ("x", "B", "C"):
        assert_close(conv[k], jconv[k], F32_TOL, f"conv {k}")
    ju1, tu1 = _pair(rng, (2, 1, 64))
    got = tmb.mamba_decode(cfg, p, tu1, conv, state)
    want = jax.jit(lambda *a: jmb.mamba_decode(cfg, *a))(jp, ju1, jconv, jstate)
    assert_close(got[0], want[0], F32_TOL, "decode out")
    assert_close(got[2], want[2], F32_TOL, "decode state")
    for k in ("x", "B", "C"):
        assert_close(got[1][k], want[1][k], F32_TOL, f"decode conv {k}")


def test_softplus_matches_reference():
    """dt's softplus: torch's, linear above 20, equals jax.nn.softplus in float32
    within 1e-6 relative (an ulp or two; log1p(e^-x) is below half an ulp of x past
    20), over [-30, 60]."""
    x = np.linspace(-30, 60, 2001).astype(np.float32)
    np.testing.assert_allclose(f32(torch.nn.functional.softplus(torch.from_numpy(x))),
                               f32(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=0)


# -- MoE ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("dispatch", ["loop", "dense", "a2a"])
def test_moe_matches_reference(built, name, dispatch):
    """moe_apply through _moe_loop and _moe_dense ("a2a" resolves to the loop
    without a mesh, in both packages): output and aux loss, float32, within 1e-4."""
    cfg, params, model = built(name, "float32")
    cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    layer = next(i for i in range(cfg.n_layers) if cfg.block_at(i).moe)
    jp = layer_trees(cfg, params["prefix"], params["blocks"])[layer]["moe"]
    rng = np.random.default_rng(7)
    jx, tx = _pair(rng, (2, 16, 64))
    got, aux = tmo.moe_apply(cfg, model.layers[layer].moe, tx)
    want, jaux = jax.jit(lambda q, x: jmo.moe_apply(cfg, q, x))(jp, jx)
    assert_close(got, want, F32_TOL, "out")
    assert_close(aux, jaux, F32_TOL, "aux")
    if dispatch == "loop":      # the two port paths agree with the reference's oracle
        want_loop = jax.jit(lambda q, x: jmo._moe_loop(cfg, q, x))(jp, jx.reshape(32, 64))[0]
        assert_close(tmo._moe_dense(cfg, model.layers[layer].moe, tx.reshape(32, 64))[0],
                     want_loop, F32_TOL, "dense vs loop")


# -- whole model ------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_and_loss_f32_match_reference(built, name):
    """model_forward logits and aux, loss_fn's value (CE and aux), float32 variant,
    S = 32, batch 2, within 1e-4."""
    cfg, params, model = built(name, "float32")
    jb, tb = batches(cfg)
    with torch.no_grad():
        logits, aux = tm.model_forward(cfg, model, tb)
        loss, metrics = tm.loss_fn(cfg, model, tb)
    (jlogits, jaux), (jloss, jmetrics) = jax.jit(
        lambda p, b: (jm.model_forward(cfg, p, b), jm.loss_fn(cfg, p, b)))(params, jb)
    assert_close(logits, jlogits, F32_TOL, "logits")
    assert_close(aux, jaux, F32_TOL, "aux")
    for k in ("loss", "ce", "aux"):
        assert_close(metrics[k], jmetrics[k], F32_TOL, k)
    assert_close(model(tb)[0], jlogits, F32_TOL, "Model.forward")


def test_params_from_numpy_layer_order():
    """Pattern position i of repeat r lands in layer len(prefix) + r·P + i: each
    layer's first weight equals the reference's stacked slice (jamba: P = 8)."""
    cfg = reduced("jamba-1.5-large-398b")
    params = jm.init_params(cfg, jax.random.PRNGKey(1))
    model = params_from_numpy(cfg, np_tree(params), "cpu")
    assert len(model.layers) == cfg.n_layers == 16
    for r in range(cfg.n_repeats):
        for i, spec in enumerate(cfg.pattern):
            layer = model.layers[r * len(cfg.pattern) + i]
            assert layer.spec == spec
            want = np_tree(params["blocks"][f"pos{i}"]["norm1"]["scale"])[r]
            np.testing.assert_array_equal(f32(layer.norm1.scale), want)
    assert model.layers[1].mixer.A_log.dtype == torch.float32    # kept fp32, as in JAX
    with pytest.raises(ValueError, match="parameter trees differ"):
        bad = np_tree(params)
        del bad["final_norm"]["scale"]
        params_from_numpy(cfg, bad, "cpu")
