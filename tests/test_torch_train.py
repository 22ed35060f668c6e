"""The port's training path's pieces ≡ the JAX package's, on the CPU: the loss's
gradients for all ten reduced archs (through the two kernel routes' autograd
Functions, whose forward is the plain version here), the bf16 barrier and the
RMSNorm backward against the reference's ``custom_vjp``s, the Functions against
plain autograd, the matmul-form SSD against the reference's ``ssd_chunked``, and
the optimizer (``lr_at``, clipping, ``adamw_update``, int8 with error feedback).

Tolerances (stated per test): float32 gradients within 1e-4 of the leaf's largest
|g| plus 1e-4·|g| (the serve parity's 1e-4 + 1e-4·|ref|, with the absolute part
scaled to the leaf: gradients of different leaves differ by orders of
magnitude); the custom VJPs bit for bit in bf16, within 1e-5 of the largest
magnitude in float32 (XLA's rsqrt and summation order); the optimizer within
1e-6 relative (fp32 rounding of the same formulas; the masters also 1e-6·lr
absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_lm_parity import ARCH_NAMES, F32_TOL, Built, assert_close, batches, f32, np_tree

from repro.models import layers as jl
from repro.models import mamba as jmb
from repro.models import model as jm
from repro.train import optimizer as jopt
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import mamba as tmb
from repro_torch.models.convert import by_name
from repro_torch.train import optimizer as topt
from repro_torch.train.step import loss_and_grads

OPT_TOL = 1e-6


@pytest.fixture(scope="module")
def built():
    return Built()


def assert_grads_close(got: dict, want: dict, tol: float = F32_TOL) -> float:
    """Every leaf within tol·max|want leaf| + tol·|want|; returns the largest
    |Δ| over the leaf's largest |want|."""
    assert sorted(got) == sorted(want)
    worst = 0.0
    for k, w in want.items():
        g, w = f32(got[k]), np.asarray(w, np.float32)
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale, err_msg=k)
        if scale:
            worst = max(worst, float(np.abs(g - w).max()) / scale)
    return worst


# -- the loss's gradients -------------------------------------------------------


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_grads_match_reference(built, name):
    """``loss_and_grads`` ≡ ``jax.value_and_grad`` of the reference's ``loss_fn``,
    float32, batch 2 × 32, the JAX weights carried across: the loss and metrics
    within 1e-4, every gradient leaf within 1e-4 of its largest |g| + 1e-4·|g|."""
    cfg, params, model = built(name, "float32")
    jb, tb = batches(cfg)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(cfg, p, jb), has_aux=True)(params)
    grads, metrics = loss_and_grads(cfg, model, tb)
    for k in ("loss", "ce", "aux"):
        assert_close(metrics[k], jmetrics[k], F32_TOL, k)
    for k, g in grads.items():
        p = dict(model.named_parameters())[k]
        assert g.dtype == p.dtype and g.shape == p.shape, k
        assert bool(torch.isfinite(g).all()), k
    assert assert_grads_close(grads, by_name(cfg, np_tree(jgrads))) < F32_TOL


# -- the custom VJPs --------------------------------------------------------------


def _pairs(rng, dtype, *shapes_scales):
    out = []
    for shape, scale in shapes_scales:
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        out.append((jnp.asarray(a).astype(jnp.dtype(dtype)), torch.from_numpy(a).to(tl.DTYPES[dtype])))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_backward_matches_reference_custom_vjp(dtype):
    """``layers.rms_norm``'s forward and closed-form backward (d_x in the stream
    dtype, d_scale summed in fp32) against the reference's ``_rms_core`` VJP on the
    same numpy draw: bit for bit in bf16; in float32 within 1e-5 of the largest
    magnitude (XLA's rsqrt and its summation order round differently)."""
    rng = np.random.default_rng(0)
    (jx, tx), (js, ts), (jg, tg) = _pairs(rng, dtype, ((2, 8, 64), 3.0), ((64,), 0.1),
                                          ((2, 8, 64), 1.0))
    y, vjp = jax.vjp(jl.rms_norm, jx, js)
    dx, ds = vjp(jg)
    tx.requires_grad_(True)
    ts.requires_grad_(True)
    ty = tl.rms_norm(tx, ts)
    tdx, tds = torch.autograd.grad(ty, (tx, ts), tg)
    for name, got, want in (("y", ty, y), ("d_x", tdx, dx), ("d_scale", tds, ds)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        if dtype == "bfloat16":
            np.testing.assert_array_equal(f32(got), f32(want), err_msg=name)
        else:
            w = f32(want)
            np.testing.assert_allclose(f32(got), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_dtype_barrier_matches_reference(dtype):
    """Identity forward; the backward hands back the cotangent in bf16 for a bf16
    input (and the float32 input passes through untouched), as the reference's."""
    rng = np.random.default_rng(1)
    (jx, tx), (jg, tg) = _pairs(rng, dtype, ((4, 16), 1.0), ((4, 16), 1.0))
    y, vjp = jax.vjp(jl.grad_dtype_barrier, jx)
    (gx,) = vjp(jg)
    tx.requires_grad_(True)
    ty = tl.grad_dtype_barrier(tx)
    (tgx,) = torch.autograd.grad(ty, (tx,), tg)
    np.testing.assert_array_equal(f32(ty), f32(y))
    np.testing.assert_array_equal(f32(tgx), f32(gx))
    assert tgx.dtype == tl.DTYPES[dtype] and str(gx.dtype) == dtype
    if dtype == "float32":
        assert tl.grad_dtype_barrier(tx) is tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_stream_gradient_stays_in_its_dtype(dtype):
    """The bf16 stream's gradient through ``apply_norm`` is bf16 end to end (no
    fp32 cotangent reaches the residual stream), equal to the reference's."""
    from repro_torch.configs import ARCHS, reduced_for_smoke
    from repro.configs import ARCHS as JARCHS, reduced_for_smoke as jreduced

    cfg, jcfg = reduced_for_smoke(ARCHS["h2o-danube-1.8b"]), jreduced(JARCHS["h2o-danube-1.8b"])
    rng = np.random.default_rng(2)
    (jx, tx), (js, ts), (jg, tg) = _pairs(rng, dtype, ((2, 4, 64), 2.0), ((64,), 0.1),
                                          ((2, 4, 64), 1.0))
    _, vjp = jax.vjp(lambda x, s: jl.apply_norm(jcfg, x, {"scale": s}), jx, js)
    dx, ds = vjp(jg)
    p = tl.Params({"scale": ts})
    p.scale.requires_grad_(True)
    tx.requires_grad_(True)
    tdx, tds = torch.autograd.grad(tl.apply_norm(cfg, tx, p), (tx, p.scale), tg)
    assert tdx.dtype == tl.DTYPES[dtype] and tds.dtype == tl.DTYPES[dtype]
    tol = 0 if dtype == "bfloat16" else 1e-5
    for got, want in ((tdx, dx), (tds, ds)):
        w = f32(want)
        np.testing.assert_allclose(f32(got), w, rtol=0, atol=tol * np.abs(w).max())


# -- the kernel routes' autograd Functions -----------------------------------------


@pytest.mark.parametrize("case", ["causal-gqa", "causal-mha", "bidirectional", "cross"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_function_grads_equal_chunked_autograd(case, dtype):
    """``attention.flash_attn`` (the kernel route) differentiates as plain autograd
    through ``chunked_attention`` over the full span does, bit for bit (the
    backward recomputes it); its forward, the plain flash version here, within
    1e-5 (float32) / 2e-2 (bf16) of chunked_attention's."""
    rng = np.random.default_rng(3)
    b, s, h, kv, d = 2, 16, 4, 2, 16
    sk, causal = s, True
    if case == "causal-mha":
        kv = h
    elif case == "bidirectional":
        causal = False
    elif case == "cross":
        sk, causal = 24, False
    dt = tl.DTYPES[dtype]
    q = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)).to(dt)
    k = torch.from_numpy(rng.standard_normal((b, sk, kv, d)).astype(np.float32)).to(dt)
    v = torch.from_numpy(rng.standard_normal((b, sk, kv, d)).astype(np.float32)).to(dt)
    g = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)).to(dt)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ta.flash_attn(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, g)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_out = ta.chunked_attention(*plain, causal=causal)
    want = torch.autograd.grad(want_out, plain, g)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dt, name
        assert torch.equal(a, w), name
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(f32(out), f32(want_out), rtol=tol, atol=tol)


def _ssd_inputs(rng, dtype, b=2, s=32, h=4, p=8, g=2, n=8):
    dt = tl.DTYPES[dtype]
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32)).to(dt)
    dtv = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32))
    a = -torch.from_numpy(np.exp(rng.standard_normal(h) * 0.5).astype(np.float32))
    bb = torch.from_numpy(rng.standard_normal((b, s, g, n)).astype(np.float32)).to(dt)
    cc = torch.from_numpy(rng.standard_normal((b, s, g, n)).astype(np.float32)).to(dt)
    return x, dtv, a, bb, cc


@pytest.mark.parametrize("with_state_grad", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_function_grads_equal_matmul_autograd(dtype, with_state_grad):
    """``mamba.ssd_chunked`` (the kernel route) differentiates as plain autograd
    through ``ssd_chunked_matmul`` does, bit for bit, for all five inputs, with and
    without a gradient on the final state."""
    rng = np.random.default_rng(4)
    inputs = _ssd_inputs(rng, dtype)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    y, state = tmb.ssd_chunked(*leaves, chunk=8)
    gy = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32)).to(y.dtype)
    gs = torch.from_numpy(rng.standard_normal(tuple(state.shape)).astype(np.float32)).to(y.dtype)
    outs, gouts = ([y, state], [gy, gs]) if with_state_grad else ([y], [gy])
    got = torch.autograd.grad(outs, leaves, gouts)
    plain = [t.clone().requires_grad_(True) for t in inputs]
    py, pstate = tmb.ssd_chunked_matmul(*plain, chunk=8)
    want = torch.autograd.grad([py, pstate] if with_state_grad else [py], plain, gouts)
    for name, a, w in zip(("x", "dt", "a", "b", "c"), got, want):
        assert a.dtype == w.dtype and torch.equal(a, w), name


@pytest.mark.parametrize("shape", [(2, 32, 4, 8, 1, 8, 8), (1, 48, 6, 4, 3, 16, 16),
                                   (2, 24, 4, 8, 2, 8, 64)])
def test_ssd_matmul_matches_reference(shape):
    """``ssd_chunked_matmul`` ≡ the reference's ``ssd_chunked`` (zero initial state)
    in float32 within 1e-4 + 1e-4·|ref| (y and the final state), over groups
    G = 1, 3, 2, and a chunk larger than S (24 steps, chunk 64, halved to 24)."""
    b, s, h, p, g, n, chunk = shape
    rng = np.random.default_rng(5)
    x, dtv, a, bb, cc = _ssd_inputs(rng, "float32", b, s, h, p, g, n)
    y, st = tmb.ssd_chunked_matmul(x, dtv, a, bb, cc, chunk)
    jy, jst = jmb.ssd_chunked(*(jnp.asarray(t.numpy()) for t in (x, dtv, a, bb, cc)), chunk)
    assert_close(y, jy, F32_TOL, "y")
    assert_close(st, jst, F32_TOL, "state")


def test_ssd_matmul_gradients_match_reference():
    """The gradient of Σ y·w + Σ state·u through ``ssd_chunked_matmul`` ≡
    ``jax.grad`` through the reference's ``ssd_chunked``, float32, every input
    within 1e-4 of its largest |g| + 1e-4·|g|."""
    rng = np.random.default_rng(6)
    inputs = _ssd_inputs(rng, "float32", 2, 32, 4, 8, 2, 8)
    w = rng.standard_normal((2, 32, 4, 8)).astype(np.float32)
    u = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)

    def jloss(*t):
        y, st = jmb.ssd_chunked(*t, 8)
        return jnp.sum(y * w) + jnp.sum(st * u)

    jg = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(t.numpy()) for t in inputs))
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    y, st = tmb.ssd_chunked_matmul(*leaves, 8)
    tg = torch.autograd.grad((y * torch.from_numpy(w)).sum() + (st * torch.from_numpy(u)).sum(),
                             leaves)
    assert_grads_close(dict(zip("xdabc", tg)), {k: np.asarray(v) for k, v in zip("xdabc", jg)})


# -- the optimizer -------------------------------------------------------------------


def _trees(rng, dtypes=("float32", "bfloat16", "float32")):
    """The same named leaves as a JAX dict and a torch dict."""
    jt, tt = {}, {}
    for i, dt in enumerate(dtypes):
        a = (rng.standard_normal((8, 5 + i)) * 0.5).astype(np.float32)
        jt[f"w{i}"] = jnp.asarray(a).astype(jnp.dtype(dt))
        tt[f"w{i}"] = torch.from_numpy(a).to(tl.DTYPES[dt])
    return jt, tt


def test_lr_at_matches_reference():
    cfgs = [dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1),
            dict(lr=3e-4, warmup_steps=2, total_steps=5), dict(lr=1e-3, warmup_steps=1,
                                                               total_steps=10)]
    for kw in cfgs:
        for step in (0, 1, 2, 5, 9, 10, 60, 110, 200):
            want = float(jopt.lr_at(jopt.AdamWConfig(**kw), jnp.array(step)))
            got = float(topt.lr_at(topt.AdamWConfig(**kw), torch.tensor(step)))
            assert got == pytest.approx(want, rel=OPT_TOL, abs=1e-12), (kw, step)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_global_norm_and_clipping_match_reference(max_norm):
    jt, tt = _trees(np.random.default_rng(7))
    jc, jn = jopt.clip_by_global_norm(jt, max_norm)
    tc, tn = topt.clip_by_global_norm(tt, max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=OPT_TOL)
    assert float(topt.global_norm(tt)) == pytest.approx(float(jopt.global_norm(jt)), rel=OPT_TOL)
    for k in jt:
        assert tc[k].dtype == torch.float32
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), rtol=OPT_TOL, atol=1e-9)


def test_adamw_update_matches_reference_and_keeps_each_dtype():
    """Four updates on a float32 / bf16 / float32 tree, gradients from one numpy
    draw per step (the first below the clip, the rest above it): masters, moments,
    step, grad_norm and lr within 1e-6 relative of the reference's (plus 1e-6·lr
    absolute: one fp32 rounding of an update of size lr); every
    parameter equals its master cast to its own dtype."""
    rng = np.random.default_rng(8)
    jp, tp = _trees(rng)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0)
    jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    js, ts = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    dtypes = {k: v.dtype for k, v in jp.items()}   # the reference recasts jp after a step
    for i in range(4):
        scale = 0.05 if i == 0 else 2.0
        grads = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32) for k, v in jp.items()}
        jg = {k: jnp.asarray(g).astype(dtypes[k]) for k, g in grads.items()}
        tg = {k: torch.from_numpy(g).to(tp[k].dtype) for k, g in grads.items()}
        jp, js, jmet = jopt.adamw_update(jcfg, jp, jg, js)
        tp, ts, tmet = topt.adamw_update(tcfg, tp, tg, ts)
        for k in ("grad_norm", "lr"):
            assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=OPT_TOL), (i, k)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for part in ("master", "m", "v"):
            for k in jp:
                np.testing.assert_allclose(f32(ts[part][k]), f32(js[part][k]), rtol=OPT_TOL,
                                           atol=OPT_TOL * tcfg.lr, err_msg=f"step {i} {part} {k}")
        for k, p in tp.items():
            assert p.dtype == (torch.bfloat16 if k == "w1" else torch.float32)
            assert torch.equal(p, ts["master"][k].to(p.dtype))


@pytest.mark.parametrize("name,bf16_before,recast_to", [
    ("mamba2-780m", 13, "float32"),
    ("deepseek-moe-16b", None, "bfloat16"),
])
def test_reference_optimizer_recasts_params_the_port_keeps_their_dtypes(built, name,
                                                                        bf16_before, recast_to):
    """The reference's ``adamw_update`` casts every new parameter to the dtype of
    its tree's first leaf (``repro/train/optimizer.py:107-108``): reduced bf16
    mamba2-780m's first leaf is the float32 ``A_log``, so one step turns its 13
    bf16 leaves into float32; deepseek-moe-16b's first leaf is bf16, so its
    float32 routers become bf16. The port keeps each parameter's dtype."""
    cfg, params, model = built(name)
    jb, tb = batches(cfg, seq=16)
    jg = jax.grad(lambda p: jm.loss_fn(cfg, p, jb)[0])(params)
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    new, _, _ = jopt.adamw_update(jcfg, params, jg, jopt.init_opt_state(params))
    before = [str(a.dtype) for a in jax.tree.leaves(params)]
    after = [str(a.dtype) for a in jax.tree.leaves(new)]
    if bf16_before is not None:
        assert before.count("bfloat16") == bf16_before
    assert "float32" in before and "bfloat16" in before
    assert set(after) == {recast_to}

    import copy

    model = copy.deepcopy(model)
    dtypes = {k: p.dtype for k, p in model.named_parameters()}
    grads, _ = loss_and_grads(cfg, model, tb)
    named = dict(model.named_parameters())
    topt.adamw_update(topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10), named, grads,
                      topt.init_opt_state(named))
    assert {k: p.dtype for k, p in model.named_parameters()} == dtypes
    assert {torch.float32, torch.bfloat16} <= set(dtypes.values())


def test_int8_compression_matches_reference():
    """``compress_int8`` gives the reference's int8 codes and scale (codes equal,
    scale within 1e-6), and five rounds of ``compressed_grads_with_ef`` carry the
    same residuals within 1e-6 of the largest |g|."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(256, 64)).astype(np.float32)
    jq, js = jopt.compress_int8(jnp.asarray(x))
    tq, ts = topt.compress_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == pytest.approx(float(js), rel=1e-6)
    np.testing.assert_allclose(topt.decompress_int8(tq, ts).numpy(),
                               np.asarray(jopt.decompress_int8(jq, js)), rtol=1e-6)
    g = {"a": rng.normal(size=(64,)).astype(np.float32) * 1e-3,
         "b": rng.normal(size=(8, 8)).astype(np.float32)}
    jef = jopt.init_ef_state({k: jnp.asarray(v) for k, v in g.items()})
    tef = topt.init_ef_state({k: torch.from_numpy(v) for k, v in g.items()})
    for _ in range(5):
        jd, jef = jopt.compressed_grads_with_ef({k: jnp.asarray(v) for k, v in g.items()}, jef)
        td, tef = topt.compressed_grads_with_ef({k: torch.from_numpy(v) for k, v in g.items()},
                                                tef)
        for k in g:
            big = float(np.abs(g[k]).max())
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), rtol=0, atol=1e-6 * big)
            np.testing.assert_allclose(tef[k].numpy(), np.asarray(jef[k]), rtol=0, atol=1e-6 * big)
