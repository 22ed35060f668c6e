"""The port's expert-parallel MoE dispatch (``models/moe.py`` "a2a") on the CPU,
in one process: the capacity-packing repair locked against the JAX package's
``_pack_capacity``, where ``moe_apply`` takes "a2a", the token-sharding fallbacks,
and the dispatch against the reference's on a one-device mesh. The eight-device
parity is ``test_torch_mesh8.py``'s."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_for_smoke as jreduced
from repro.distributed.ctx import MeshAxes as JMeshAxes
from repro.distributed.ctx import axes_context as jaxes_context
from repro.models import moe as jmoe
from repro_torch.configs import ARCHS, reduced_for_smoke
from repro_torch.distributed.ctx import Mesh, MeshAxes, axes_context, set_mesh
from repro_torch.models import moe as tmoe
from test_torch_mesh8 import moe_inputs, port_moe_params

ARCH = "deepseek-moe-16b"
AXES = MeshAxes(("data",), "model")


def _cfg(**kw):
    return replace(reduced_for_smoke(ARCHS[ARCH]), dtype="float32", **kw)


def test_pack_capacity_writes_only_kept_entries_where_the_reference_overwrites():
    """3 tokens, 1 expert, top-1, capacity 2: token 3 is dropped. The reference's
    buffer is [1, 0] — the dropped entry's zeros land in slot cap-1 over token 2,
    which is then lost though its combine weight stays — the port's [1, 2]."""
    jcfg = replace(jreduced(JARCHS[ARCH]), n_experts=1, top_k=1)
    x = np.array([[1.0], [2.0], [3.0]], np.float32)
    idx = np.zeros((3, 1), np.int32)
    w = np.ones((3, 1), np.float32)
    jbuf, (jslot, jkeep) = jmoe._pack_capacity(jcfg, jnp.asarray(x), jnp.asarray(idx),
                                               jnp.asarray(w), 2)
    tbuf, tslot, tkeep = tmoe._pack_capacity(replace(jcfg, dtype="float32"), torch.from_numpy(x),
                                             torch.from_numpy(idx).long(), 2)
    assert np.asarray(jbuf).ravel().tolist() == [1.0, 0.0]
    assert tbuf.ravel().tolist() == [1.0, 2.0]
    assert np.asarray(jslot).ravel().tolist() == tslot.ravel().tolist() == [0, 1, 2]
    assert np.asarray(jkeep).ravel().tolist() == tkeep.ravel().tolist() == [True, True, False]


def test_pack_capacity_positions_count_within_each_shard():
    """Two shards of 4 tokens, top-2 over 3 experts, capacity 2: each shard counts
    its own (token, k) entries in order, and each kept entry's row is its token."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 5, generator=g)
    idx = torch.tensor([[[0, 1], [0, 2], [0, 1], [2, 1]],
                        [[1, 2], [1, 0], [2, 0], [1, 2]]])
    buf, slot, keep = tmoe._pack_capacity(_cfg(n_experts=3, top_k=2), x, idx, 2)
    assert slot.tolist() == [[[0, 0], [1, 0], [2, 1], [1, 2]],
                             [[0, 0], [1, 0], [1, 1], [2, 2]]]
    assert keep.tolist() == (slot < 2).tolist()
    for s in range(2):
        for t in range(4):
            for j in range(2):
                if keep[s, t, j]:
                    assert torch.equal(buf[s, idx[s, t, j], slot[s, t, j]], x[s, t])


def _layer(cfg):
    arrays, x = moe_inputs(cfg)
    return port_moe_params(cfg, arrays), torch.from_numpy(x)


def test_moe_apply_takes_a2a_exactly_under_a_mesh_and_axes(monkeypatch):
    cfg = _cfg()
    p, x = _layer(cfg)
    seen = []
    for name in ("_moe_a2a", "_moe_loop"):
        orig = getattr(tmoe, name)
        monkeypatch.setattr(tmoe, name, lambda *a, _o=orig, _n=name: seen.append(_n) or _o(*a))
    tmoe.moe_apply(cfg, p, x)
    with set_mesh(Mesh((2, 4), ("data", "model"))):
        tmoe.moe_apply(cfg, p, x)                       # a mesh, but no axes
    with set_mesh(Mesh((2, 4), ("data", "model"))), axes_context(AXES):
        tmoe.moe_apply(cfg, p, x)
        tmoe.moe_apply(replace(cfg, moe_dispatch="loop"), p, x)
    assert seen == ["_moe_loop", "_moe_loop", "_moe_a2a", "_moe_loop"]
    with axes_context(AXES), pytest.raises(ValueError, match="ambient mesh"):
        tmoe.moe_apply(cfg, p, x)


@pytest.mark.parametrize("tokens,path", [(12, "tp-only"), (2, "dense")])
def test_small_batches_follow_the_reference_fallbacks(tokens, path):
    """12 tokens divide over the 4 model shards but not over 2 × 4: each data
    group dispatches the same slices, cap = max(ceil(3·2/4·1.25), min(3, 8)) = 3
    keeps every entry, so the result is the dropless loop's; 2 tokens divide over
    neither and take the dense path."""
    cfg = _cfg()
    p, x = _layer(cfg)
    x = x.reshape(-1, cfg.d_model)[:tokens].reshape(1, tokens, cfg.d_model)
    with set_mesh(Mesh((2, 4), ("data", "model"))), axes_context(AXES):
        got, _ = tmoe.moe_apply(cfg, p, x)
    want, _ = tmoe.moe_apply(replace(cfg, moe_dispatch="loop" if path == "tp-only" else "dense"),
                             p, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cf", [2.0, 1.25])
def test_a2a_matches_reference_on_a_one_device_mesh(cf):
    """The reference's ``_moe_a2a`` on this process's one device, (data 1, model
    1), at capacity factors with no overflow at this size: equal within 1e-5."""
    cfg = _cfg(capacity_factor=cf)
    arrays, x = moe_inputs(cfg)
    jcfg = replace(jreduced(JARCHS[ARCH]), dtype="float32", capacity_factor=cf)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    with jax.set_mesh(mesh), jaxes_context(JMeshAxes(("data",), "model")):
        want, jaux = jmoe.moe_apply(jcfg, jax.tree.map(jnp.asarray, arrays), jnp.asarray(x))
    with set_mesh(Mesh((1, 1), ("data", "model"))), axes_context(AXES):
        got, aux = tmoe.moe_apply(cfg, port_moe_params(cfg, arrays), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
