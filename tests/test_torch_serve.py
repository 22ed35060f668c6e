"""The port's serve path ≡ the JAX package's, on the CPU: ``make_serve_step``'s
greedy tokens over 8 steps after ``make_prefill_step`` (reduced h2o-danube-1.8b and
mamba2-780m, float32, the JAX weights carried across), ``synth_batch``, and
``python -m repro_torch.launch.serve`` (runs on the CPU with ``--device cpu``, is
deterministic, returns the JAX driver's keys); without CUDA the entry points
raise unless the caller asks for the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_lm_parity import F32_TOL, Built, assert_close, batches, np_tree, reduced

from repro.launch import serve as jserve
from repro.models import model as jm
from repro.train import data as jdata
from repro.train import step as jstep
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import data as tdata
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def built():
    return Built()


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "mamba2-780m"])
def test_serve_step_tokens_match_reference(built, name):
    """Prefill (S = 32, batch 2, cache headroom 8) then 8 greedy serve steps:
    identical tokens, logits within 1e-4 (float32)."""
    cfg, params, model = built(name, "float32")
    jb, tb = batches(cfg)
    jlogits, jcache = jax.jit(lambda p, b: jm.prefill(cfg, p, b, cache_len=40))(params, jb)
    with torch.no_grad():
        logits, cache = tm.prefill(cfg, model, tb, cache_len=40)
    serve, jserve_step = tstep.make_serve_step(cfg), jax.jit(jstep.make_serve_step(cfg))
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(8):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok), err_msg=f"step {i}")
        jtok, jlogits, jcache = jserve_step(params, jcache, jtok)
        tok, logits, cache = serve(model, cache, tok)
        assert tok.dtype == torch.int32
        assert_close(logits, jlogits, F32_TOL, f"step {i}")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_prefill_step_matches_prefill(built):
    """make_prefill_step is prefill with the context-length cache."""
    cfg, params, model = built("mamba2-780m", "float32")
    _, tb = batches(cfg)
    logits, cache = tstep.make_prefill_step(cfg)(model, tb)
    with torch.no_grad():
        want, wcache = tm.prefill(cfg, model, tb)
    assert torch.equal(logits, want) and cache["pos"] == wcache["pos"] == 32


@pytest.mark.parametrize("name", ["whisper-small", "internvl2-26b", "h2o-danube-1.8b"])
@pytest.mark.parametrize("step,seed", [(0, 0), (3, 7)])
def test_synth_batch_equals_reference(name, step, seed):
    cfg = reduced(name)
    want = jdata.synth_batch(cfg, step=step, global_batch=4, seq=32, seed=seed, rank=1,
                             n_ranks=2)
    got = tdata.synth_batch(cfg, step=step, global_batch=4, seq=32, seed=seed, rank=1,
                            n_ranks=2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_launch_serve_cpu_is_deterministic():
    """The port's driver on the CPU: the JAX driver's keys, (batch, gen) int32
    tokens in the vocab, the same tokens on a second run."""
    argv = ["--arch", "mamba2-780m", "--reduced", "--batch", "2", "--prompt-len", "16",
            "--gen", "6", "--device", "cpu"]
    out = tserve.main(argv)
    assert sorted(out) == ["gen", "t_decode", "t_prefill"]
    assert out["gen"].shape == (2, 6) and out["gen"].dtype == np.int32
    assert ((0 <= out["gen"]) & (out["gen"] < reduced("mamba2-780m").vocab_padded)).all()
    np.testing.assert_array_equal(tserve.main(argv)["gen"], out["gen"])
    assert out["t_prefill"] > 0 and out["t_decode"] > 0


def test_launch_serve_module_entry_point():
    """``python -m repro_torch.launch.serve ... --device cpu`` runs to its end."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "h2o-danube-1.8b",
         "--reduced", "--batch", "1", "--prompt-len", "16", "--gen", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "[serve] decoded 3 tokens" in res.stdout


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    """No quiet CPU fallback: without CUDA, the driver, the model constructors
    and the converters raise unless the caller passes device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced("mamba2-780m", "float32")
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    for call in (lambda: tserve.main(["--arch", "mamba2-780m", "--reduced"]),
                 lambda: tm.init_params(cfg),
                 lambda: tm.init_cache(cfg, batch=1, s_max=8),
                 lambda: params_from_numpy(cfg, np_tree(params))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert tm.init_params(cfg, device="cpu").embed.embedding.device.type == "cpu"


def test_reference_driver_keys_match():
    """The JAX driver returns the same keys (the port mirrors its contract)."""
    out = jserve.main(["--arch", "mamba2-780m", "--reduced", "--batch", "1",
                       "--prompt-len", "16", "--gen", "3"])
    assert sorted(out) == ["gen", "t_decode", "t_prefill"] and out["gen"].shape == (1, 3)
