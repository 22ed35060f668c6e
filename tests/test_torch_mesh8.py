"""The port's virtual mesh ≡ the JAX package on a real mesh of eight host devices.

The JAX package's shard_map bodies need as many devices as the mesh has, so they
run in a subprocess — this file run as a script — with ``XLA_FLAGS`` asking for
eight CPU devices, which keeps the flag out of the test process. The script
writes the reference's outputs to an ``.npz``; the port runs here, on the CPU, on
the same numpy inputs:

* the twins of ``tests/subproc/dataplane_check.py``'s ``check_decode_attn``,
  ``check_hierarchical_grad_sync`` and ``check_pipeline``, at their seeds,
  shapes and tolerances (1e-5; 1e-6; 1e-4 relative + 1e-5 absolute);
* the expert-parallel MoE (``_moe_a2a`` through ``moe_apply``) on reduced
  deepseek-moe-16b at (data 2, model 4), x (2, 512, d), float32: equal to the
  reference at a dropless capacity factor, and equal to a plain capacity-bounded
  oracle (float64 numpy) at cf 1.0 and 1.25; the reference equals that oracle
  except on the tokens whose kept entry sat in the last slot of an expert that
  overflowed, which the reference's packing overwrites with zeros.
"""

import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_for_smoke as jreduced
from repro_torch.configs import ARCHS, reduced_for_smoke
from repro_torch.dataplane.decode_attn import reference_decode_attention, split_kv_decode_attention
from repro_torch.distributed.ctx import Mesh, MeshAxes, axes_context, set_mesh
from repro_torch.distributed.specs import P, gather, place
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import Init
from repro_torch.train.grad_sync import hierarchical_mean
from repro_torch.train.pipeline import pipelined_forward

torch.set_num_threads(1)

ARCH = "deepseek-moe-16b"
MOE_MESH = ((2, 4), ("data", "model"))
MOE_X = (2, 512)
MOE_DROPLESS_CF = 2.0            # ≥ E / top_k: no expert can overflow
MOE_CFS = (MOE_DROPLESS_CF, 1.25, 1.0)


# ---------------------------------------------------------------------------
# inputs, made from numpy seeds on both sides
# ---------------------------------------------------------------------------


def decode_inputs():
    rng = np.random.default_rng(1)
    b, h, kv, hd, s = 2, 8, 4, 16, 64
    return (rng.normal(size=(b, h, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32))


def grad_inputs():
    rng = np.random.default_rng(2)
    return {"w": rng.normal(size=(16, 8)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


PIPE = dict(n_stages=2, n_micro=4, bsz=4, d=16)


def pipe_inputs():
    rng = np.random.default_rng(3)
    s, m, b, d = PIPE["n_stages"], PIPE["n_micro"], PIPE["bsz"], PIPE["d"]
    w = rng.normal(size=(s, 1, d, d)).astype(np.float32) * 0.3
    x = rng.normal(size=(m, b, d)).astype(np.float32)
    return w, x


def moe_cfg(pkg_cfg):
    return replace(pkg_cfg, dtype="float32")


def moe_inputs(cfg):
    """Reduced deepseek-moe-16b's MoE weights (the JAX package's init scales) and
    x (2, 512, d)."""
    rng = np.random.default_rng(7)
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    dsh = f * cfg.n_shared_experts

    def normal(*shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    params = {"router": normal(d, e, scale=d ** -0.5),
              "w_gate": normal(e, d, f, scale=d ** -0.5),
              "w_up": normal(e, d, f, scale=d ** -0.5),
              "w_out": normal(e, f, d, scale=f ** -0.5),
              "shared": {"w_gate": normal(d, dsh, scale=d ** -0.5),
                         "w_up": normal(d, dsh, scale=d ** -0.5),
                         "w_out": normal(dsh, d, scale=dsh ** -0.5)}}
    return params, normal(*MOE_X, d, scale=1.0)


def port_moe_params(cfg, arrays):
    p = tmoe.moe_params(cfg, Init(torch.device("cpu")), torch.float32)
    with torch.no_grad():
        for name, t in p.named_parameters():
            a = arrays
            for part in name.split("."):
                a = a[part]
            t.copy_(torch.from_numpy(a))
    return p


# ---------------------------------------------------------------------------
# the reference, on eight host devices (this file run as a script)
# ---------------------------------------------------------------------------


def _reference_main(out_path: str) -> int:
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as JP

    from repro.dataplane.decode_attn import split_kv_decode_attention as jsplit
    from repro.distributed.ctx import MeshAxes as JMeshAxes
    from repro.distributed.ctx import axes_context as jaxes_context
    from repro.models import moe as jmoe
    from repro.train.grad_sync import hierarchical_mean as jhier
    from repro.train.pipeline import pipelined_forward as jpipe

    assert len(jax.devices()) == 8, jax.devices()
    out = {}
    q, k, v = map(jnp.asarray, decode_inputs())
    mesh = jax.make_mesh((8,), ("model",))
    out["decode"] = jax.jit(lambda q, k, v: jsplit(mesh, "model", q, k, v))(q, k, v)

    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    g = {k: jnp.asarray(a) for k, a in grad_inputs().items()}
    res = jax.jit(lambda g: jhier(g, mesh, {"w": JP(), "b": JP()}))(g)
    out["grad_w"], out["grad_b"] = res["w"], res["b"]

    w, x = map(jnp.asarray, pipe_inputs())
    mesh = jax.make_mesh((2, 4), ("stage", "dp"))
    out["pipe"] = jax.jit(lambda x, w: jpipe(mesh, "stage", PIPE["n_stages"], PIPE["n_micro"],
                                             lambda xm, sp: jnp.tanh(xm @ sp[0]), x, w))(x, w)

    cfg = moe_cfg(jreduced(JARCHS[ARCH]))
    arrays, xm = moe_inputs(cfg)
    p = jax.tree.map(jnp.asarray, arrays)
    _, idx, wts = jmoe._router(cfg, p, jnp.asarray(xm).reshape(-1, cfg.d_model))
    out["moe_topk_idx"], out["moe_topk_w"] = idx, wts
    mesh = jax.make_mesh(*MOE_MESH, axis_types=(AxisType.Auto,) * 2)
    with jax.set_mesh(mesh), jaxes_context(JMeshAxes(("data",), "model")):
        for cf in MOE_CFS:
            o, _ = jmoe.moe_apply(replace(cfg, capacity_factor=cf), p, jnp.asarray(xm))
            out[f"moe_a2a_{cf}"] = o
    out["moe_loop"] = jmoe.moe_apply(replace(cfg, moe_dispatch="loop"), p, jnp.asarray(xm))[0]
    np.savez(out_path, **{k: np.asarray(a) for k, a in out.items()})
    print("mesh8 reference written", flush=True)
    return 0


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh8") / "reference.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, __file__, str(path)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr[-3000:]}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the port against it
# ---------------------------------------------------------------------------


def test_split_kv_decode_attention_matches_reference_on_eight_devices(reference):
    q, k, v = map(torch.from_numpy, decode_inputs())
    out = split_kv_decode_attention(Mesh((8,), ("model",)), "model", q, k, v)
    np.testing.assert_allclose(out.numpy(), reference["decode"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(reference_decode_attention(q, k, v).numpy(), reference["decode"],
                               rtol=1e-5, atol=1e-5)


def test_hierarchical_mean_matches_reference_on_eight_devices(reference):
    """Replicated input: the mean over 2 × 2 identical replicas is the input."""
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"))
    g = {k: torch.from_numpy(a) for k, a in grad_inputs().items()}
    out = hierarchical_mean({k: place(t, mesh, P()) for k, t in g.items()}, mesh)
    for k in g:
        blocks = out[k]
        assert blocks.shape == (2, 2, 2) + g[k].shape
        got = gather(blocks, mesh, P()).numpy()
        np.testing.assert_allclose(got, reference[f"grad_{k}"], rtol=1e-6)
        np.testing.assert_allclose(got, g[k].numpy(), rtol=1e-6)
        assert torch.equal(blocks, blocks[:1, :1, :1].expand_as(blocks))


def test_pipelined_forward_matches_reference_on_eight_devices(reference):
    w, x = map(torch.from_numpy, pipe_inputs())
    mesh = Mesh((2, 4), ("stage", "dp"))
    out = pipelined_forward(mesh, "stage", PIPE["n_stages"], PIPE["n_micro"],
                            lambda xm, sp: torch.tanh(xm @ sp[0]), x, w)
    np.testing.assert_allclose(out.numpy(), reference["pipe"], rtol=1e-4, atol=1e-5)
    serial = x
    for s in range(PIPE["n_stages"]):
        serial = torch.tanh(serial @ w[s, 0])
    np.testing.assert_allclose(out.numpy(), serial.numpy(), rtol=1e-4, atol=1e-5)


def _port_moe(cf: float) -> np.ndarray:
    cfg = replace(moe_cfg(reduced_for_smoke(ARCHS[ARCH])), capacity_factor=cf)
    arrays, x = moe_inputs(cfg)
    p = port_moe_params(cfg, arrays)
    with set_mesh(Mesh(*MOE_MESH)), axes_context(MeshAxes(("data",), "model")):
        out, _ = tmoe.moe_apply(cfg, p, torch.from_numpy(x))
    return out.numpy()


def capacity_oracle(cf: float, idx: np.ndarray, wts: np.ndarray, overwrite_last: bool = False):
    """Float64 numpy: each of the mesh's 8 token slices (dp × tp, row-major)
    keeps, per expert, its first cap (token, k) entries in (token, k) order; a
    kept entry adds w · expert(x). With ``overwrite_last`` the kept entry in slot
    cap-1 of an expert that overflowed adds nothing (the reference's packing).
    Returns (out (2, 512, d), the (token, expert) pairs that overwrite removes)."""
    cfg = moe_cfg(reduced_for_smoke(ARCHS[ARCH]))
    arrays, x = moe_inputs(cfg)
    x = x.reshape(-1, cfg.d_model).astype(np.float64)
    f64 = {k: (np.asarray(v, np.float64) if not isinstance(v, dict)
               else {kk: np.asarray(vv, np.float64) for kk, vv in v.items()})
           for k, v in arrays.items()}

    def silu(a):
        return a / (1.0 + np.exp(-a))

    def ffn(w, rows):
        return (silu(rows @ w["w_gate"]) * (rows @ w["w_up"])) @ w["w_out"]

    n_tok, k, e = x.shape[0], cfg.top_k, cfg.n_experts
    n_shards = int(np.prod(MOE_MESH[0]))
    t_loc = n_tok // n_shards
    cap = max(int(np.ceil(t_loc * k / e * cf)), min(t_loc, 8), 1)
    out = ffn(f64["shared"], x)
    removed = set()
    for sh in range(n_shards):
        counts = np.zeros(e, np.int64)
        last = {}
        for t in range(sh * t_loc, (sh + 1) * t_loc):
            for j in range(k):
                ex = int(idx[t, j])
                slot = counts[ex]
                counts[ex] += 1
                if slot < cap:
                    if slot == cap - 1:
                        last[ex] = (t, j)
                    out[t] += wts[t, j] * ffn({n: f64[n][ex] for n in ("w_gate", "w_up", "w_out")},
                                              x[t:t + 1])[0]
        for ex in range(e):
            if counts[ex] > cap:
                removed.add((last[ex][0], ex))
                if overwrite_last:
                    t, j = last[ex]
                    out[t] -= wts[t, j] * ffn({n: f64[n][ex] for n in ("w_gate", "w_up", "w_out")},
                                              x[t:t + 1])[0]
    return out.reshape(*MOE_X, cfg.d_model), removed


def test_moe_a2a_matches_reference_at_dropless_capacity(reference):
    got = _port_moe(MOE_DROPLESS_CF)
    np.testing.assert_allclose(got, reference[f"moe_a2a_{MOE_DROPLESS_CF}"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, reference["moe_loop"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cf", [1.25, 1.0])
def test_moe_a2a_equals_capacity_bounded_oracle(reference, cf):
    want, removed = capacity_oracle(cf, reference["moe_topk_idx"], reference["moe_topk_w"])
    if cf == 1.0:
        assert removed, "cf 1.0 must overflow some expert at this size"
    np.testing.assert_allclose(_port_moe(cf), want, rtol=1e-5, atol=1e-5)


def test_reference_a2a_loses_the_last_kept_slot_of_overflowing_experts(reference):
    """The reference at cf 1.0 is the oracle with every overflowing expert's
    slot cap-1 entry removed, and differs from the plain oracle on exactly the
    tokens that held those entries."""
    idx, wts = reference["moe_topk_idx"], reference["moe_topk_w"]
    faulty, removed = capacity_oracle(1.0, idx, wts, overwrite_last=True)
    plain, _ = capacity_oracle(1.0, idx, wts)
    ref = reference["moe_a2a_1.0"]
    np.testing.assert_allclose(ref, faulty, rtol=1e-5, atol=1e-5)
    d = ref.shape[-1]
    differs = np.abs(ref.reshape(-1, d) - plain.reshape(-1, d)).max(-1) > 1e-4
    assert set(np.flatnonzero(differs)) == {t for t, _ in removed} != set()


if __name__ == "__main__":
    sys.exit(_reference_main(sys.argv[1]))
