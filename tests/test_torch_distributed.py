"""The port's mesh layer ≡ the JAX package's, on the CPU.

* the twins of ``test_roofline_analysis.py``'s production-mesh shape test and
  ``::test_param_spec_rules_divisibility``;
* ``param_pspecs`` (fsdp on and off), ``opt_state_pspecs``, ``batch_pspecs`` and
  ``cache_pspecs`` for all ten archs at full width on both production meshes,
  equal entry for entry to the reference's over ``jax.eval_shape`` trees (a
  stacked leaf's spec, minus its repeats dim, against each of its layers,
  numbered as ``convert.layer_trees`` numbers them);
* ``input_specs``: shapes and dtypes equal to the reference's for every
  applicable (arch × shape) cell, everything on the meta device;
* the collectives and ``place`` / ``gather`` against their definitions written
  out as loops over the devices.
"""

import functools
import math
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.distributed import specs as jspecs
from repro.launch import inputs as jinputs
from repro.launch.mesh import axes_for as jaxes_for
from repro.train.step import TrainConfig as JTrainConfig
from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.distributed import collectives as col
from repro_torch.distributed import specs as tspecs
from repro_torch.distributed.ctx import Mesh, MeshAxes
from repro_torch.distributed.specs import P, gather, place
from repro_torch.launch import inputs as tinputs
from repro_torch.launch.mesh import axes_for, make_mesh, make_production_mesh
from repro_torch.models.convert import by_name, layer_trees
from repro_torch.train.step import TrainConfig

ARCH_NAMES = sorted(ARCHS)
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s) for a in ARCH_NAMES for s in SHAPES if shape_applicable(ARCHS[a], SHAPES[s])[0]]


def test_production_mesh_shapes():
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert make_mesh((2, 4), ("stage", "dp")).shape == {"stage": 2, "dp": 4}

    class FakeMesh:
        axis_names = ("pod", "data", "model")

    ax = axes_for(FakeMesh(), sequence_parallel=True)
    assert ax.data == ("pod", "data") and ax.model == "model" and ax.sequence_parallel
    assert axes_for(pod) == MeshAxes(("data",), "model")


def test_param_spec_rules_divisibility():
    """Non-divisible dims fall back to replication (whisper's 12-head case)."""
    class FakeMesh:
        shape = {"data": 16, "model": 16}

    assert tspecs._fit(FakeMesh(), (12, 64), ("model", None), stack_dims=0) == P(None, None)
    assert tspecs._fit(FakeMesh(), (768, 3072), ("data", "model"), stack_dims=0) == P("data", "model")
    spec = tspecs._fit(FakeMesh(), (4, 768, 3072), ("data", "model"), stack_dims=1)
    assert spec == P(None, "data", "model")
    for shape, s in (((12, 64), ("model", None)), ((768, 3072), ("data", "model"))):
        assert tuple(tspecs._fit(FakeMesh(), shape, s, 0)) == tuple(jspecs._fit(FakeMesh(), shape, s, 0))


# ---------------------------------------------------------------------------
# the reference's trees, mapped onto the port's names
# ---------------------------------------------------------------------------


class Stacked:
    """A leaf of the JAX package's tree, indexable the way ``convert.layer_trees``
    unstacks a repeats dim: a shape drops its first dim, a spec its (None) first
    entry."""

    def __init__(self, value):
        self.value = value

    def __getitem__(self, r):
        v = self.value
        if isinstance(v, tuple):                       # a spec's entries
            assert v[0] is None, v
            return Stacked(v[1:])
        return Stacked(jax.ShapeDtypeStruct(v.shape[1:], v.dtype))


def _wrap(tree):
    return jax.tree.map(lambda a: Stacked(tuple(a) if isinstance(a, JP) else a), tree,
                        is_leaf=lambda a: isinstance(a, JP))


def _named(cfg, tree):
    return {k: v.value for k, v in by_name(cfg, _wrap(tree)).items()}


def _layers(cfg, cache_tree):
    return [{k: v.value for k, v in t.items()}
            for t in layer_trees(cfg, _wrap(cache_tree["prefix"]), _wrap(cache_tree["blocks"]))]


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return jinputs.params_specs(JARCHS[arch])


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return tinputs.params_specs(ARCHS[arch])


def _meshes(which):
    shape, names = MESHES[which]
    jm = AbstractMesh(shape, names)
    return jm, jaxes_for(jm), Mesh(shape, names), axes_for(Mesh(shape, names))


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "nofsdp"])
@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_pspecs_match_reference(arch, which, fsdp):
    jm, jax_axes, tm, t_axes = _meshes(which)
    cfg = ARCHS[arch]
    want = _named(cfg, jspecs.param_pspecs(ref_params(arch), jm, jax_axes, fsdp=fsdp))
    got = tspecs.param_pspecs(port_params(arch), tm, t_axes, fsdp=fsdp)
    assert set(got) == set(want)
    assert {k: tuple(v) for k, v in got.items()} == want
    assert all(isinstance(v, P) for v in got.values())


@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_opt_state_pspecs_match_reference(arch, which):
    jm, jax_axes, tm, t_axes = _meshes(which)
    cfg = ARCHS[arch]
    jps = jspecs.param_pspecs(ref_params(arch), jm, jax_axes)
    jopt = jinputs.opt_specs(JARCHS[arch], JTrainConfig(), ref_params(arch))
    want = jspecs.opt_state_pspecs(jps, jopt, jm, jax_axes)
    model = port_params(arch)
    tps = tspecs.param_pspecs(model, tm, t_axes)
    got = tspecs.opt_state_pspecs(tps, tinputs.opt_specs(cfg, TrainConfig(), model), tm, t_axes)
    assert sorted(got) == sorted(want) == ["adamw"]
    assert tuple(got["adamw"]["step"]) == tuple(want["adamw"]["step"]) == ()
    for part in ("master", "m", "v"):
        assert {k: tuple(v) for k, v in got["adamw"][part].items()} == \
            _named(cfg, want["adamw"][part])


@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_pspecs_match_reference(arch, which):
    """At decode_32k (every arch) and long_500k (where it applies: batch 1, the
    DP axes idle)."""
    jm, jax_axes, tm, t_axes = _meshes(which)
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    for shape in ("decode_32k", "long_500k"):
        if not shape_applicable(cfg, SHAPES[shape])[0]:
            continue
        jcache = jinputs.cache_specs(jcfg, JSHAPES[shape])
        want = jspecs.cache_pspecs(jcache, jm, jax_axes, jcfg)
        got = tspecs.cache_pspecs(tinputs.cache_specs(cfg, SHAPES[shape]), tm, t_axes, cfg)
        assert tuple(got["pos"]) == tuple(want["pos"]) == ()
        want_layers = _layers(cfg, want)
        assert len(got["layers"]) == len(want_layers) == cfg.n_layers
        for j, (g, w) in enumerate(zip(got["layers"], want_layers)):
            assert {k: tuple(v) for k, v in g.items()} == w, (shape, j)
        assert ("enc_out" in got) == ("enc_out" in want) == cfg.is_encdec
        if cfg.is_encdec:
            assert tuple(got["enc_out"]) == tuple(want["enc_out"])


@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_pspecs_match_reference(arch, which):
    jm, jax_axes, tm, t_axes = _meshes(which)
    for shape in SHAPES:
        if not shape_applicable(ARCHS[arch], SHAPES[shape])[0]:
            continue
        want = jspecs.batch_pspecs(jinputs.batch_specs(JARCHS[arch], JSHAPES[shape]), jm, jax_axes)
        got = tspecs.batch_pspecs(tinputs.batch_specs(ARCHS[arch], SHAPES[shape]), tm, t_axes)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}, shape


def test_per_layer_spec_cannot_split_the_repeats_dim():
    """A rule that would split the JAX package's repeats dim has no per-layer
    twin: the port refuses it rather than replicate silently."""
    from dataclasses import replace

    cfg = replace(ARCHS["deepseek-moe-16b"], n_layers=17)      # 16 repeats: 16 % 16 == 0
    model = tinputs.params_specs(cfg)
    with pytest.raises(ValueError, match="repeats dim"):
        tspecs.param_pspecs(model, make_production_mesh(), MeshAxes())


# ---------------------------------------------------------------------------
# input_specs
# ---------------------------------------------------------------------------


def _sig(t):
    """(shape, dtype name) of a port meta tensor or a reference ShapeDtypeStruct."""
    if isinstance(t, torch.Tensor):
        assert t.device.type == "meta", t.device
        return tuple(t.shape), str(t.dtype).replace("torch.", "")
    return tuple(t.shape), str(np.dtype(t.dtype))


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_match_reference(arch, shape):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    got = tinputs.input_specs(cfg, SHAPES[shape])
    want = jinputs.input_specs(jcfg, JSHAPES[shape])
    assert sorted(got) == sorted(want)
    params = {k: _sig(p) for k, p in got["params"].named_parameters()}
    assert params == {k: _sig(v) for k, v in _named(cfg, want["params"]).items()}
    if "batch" in got:
        assert {k: _sig(v) for k, v in got["batch"].items()} == \
            {k: _sig(v) for k, v in want["batch"].items()}
    if "opt_state" in got:
        g, w = got["opt_state"]["adamw"], want["opt_state"]["adamw"]
        assert sorted(got["opt_state"]) == sorted(want["opt_state"])
        assert _sig(g["step"]) == _sig(w["step"])
        for part in ("master", "m", "v"):
            assert {k: _sig(v) for k, v in g[part].items()} == \
                {k: _sig(v) for k, v in _named(cfg, w[part]).items()}
    if "cache" in got:
        g, w = got["cache"], want["cache"]
        assert g["pos"] == 0 and _sig(w["pos"]) == ((), "int32")
        assert [{k: _sig(v) for k, v in c.items()} for c in g["layers"]] == \
            [{k: _sig(v) for k, v in c.items()} for c in _layers(cfg, w)]
        if cfg.is_encdec:
            assert _sig(g["enc_out"]) == _sig(w["enc_out"])
        assert _sig(got["tokens"]) == _sig(want["tokens"])


def _resident_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def test_input_specs_allocate_nothing():
    """Full-width jamba-1.5-large-398b's train_4k parameters and optimizer state
    (5.5 TB as described) live on the meta device: the process grows by less
    than 256 MiB making them."""
    before = _resident_bytes()
    specs = tinputs.input_specs(ARCHS["jamba-1.5-large-398b"], SHAPES["train_4k"])
    grown = _resident_bytes() - before
    params = list(specs["params"].parameters())
    leaves = params + [t for part in ("master", "m", "v")
                       for t in specs["opt_state"]["adamw"][part].values()]
    described = sum(t.numel() * t.element_size() for t in leaves)
    assert sum(p.numel() for p in params) > 390e9 and described > 5e12
    assert all(t.device.type == "meta" for t in leaves)
    assert grown < 256 * 2**20, grown


# ---------------------------------------------------------------------------
# collectives, place and gather, against loops over the devices
# ---------------------------------------------------------------------------

MESH = Mesh((2, 3, 4), ("pod", "data", "model"))


def _blocks(*local, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*MESH.sizes, *local, generator=g, dtype=torch.float64)


def _devices():
    return [tuple(i) for i in np.ndindex(*MESH.sizes)]


def _with(dev, axis, j):
    d = list(dev)
    d[MESH.dim(axis)] = j
    return tuple(d)


@pytest.mark.parametrize("axis", ["pod", "data", "model"])
def test_psum_and_pmax_reduce_over_one_axis(axis):
    x = _blocks(3, 2)
    s, m = col.psum(x, MESH, axis), col.pmax(x, MESH, axis)
    for dev in _devices():
        peers = [x[_with(dev, axis, j)] for j in range(MESH.shape[axis])]
        assert torch.allclose(s[dev], sum(peers))
        assert torch.equal(m[dev], torch.stack(peers).amax(0))


@pytest.mark.parametrize("split,concat", [(0, 0), (1, 0), (0, 2)])
def test_all_to_all_sends_chunk_j_to_device_j(split, concat):
    n = MESH.shape["model"]
    local = [5, 6, 7]
    local[split] = n
    x = _blocks(*local, seed=1)
    out = col.all_to_all(x, MESH, "model", split_axis=split, concat_axis=concat)
    for dev in _devices():
        j = dev[MESH.dim("model")]
        want = torch.stack([x[_with(dev, "model", i)].select(split, j) for i in range(n)],
                           dim=concat)
        assert torch.equal(out[dev], want)


def test_psum_scatter_and_all_gather():
    n = MESH.shape["data"]
    x = _blocks(2, n, 5, seed=2)
    rs = col.psum_scatter(x, MESH, "data", scatter_dimension=1)
    ag = col.all_gather(rs, MESH, "data", gather_axis=1)
    for dev in _devices():
        j = dev[MESH.dim("data")]
        want = sum(x[_with(dev, "data", i)][:, j] for i in range(n))
        assert torch.allclose(rs[dev], want)
        gathered = torch.stack([rs[_with(dev, "data", i)] for i in range(n)], dim=1)
        assert torch.equal(ag[dev], gathered)


def test_ppermute_shifts_and_zero_fills():
    x = _blocks(3, seed=3)
    perm = [(0, 1), (1, 2), (3, 0)]
    out = col.ppermute(x, MESH, "model", perm)
    src = {dst: s for s, dst in perm}
    for dev in _devices():
        j = dev[MESH.dim("model")]
        want = x[_with(dev, "model", src[j])] if j in src else torch.zeros(3, dtype=x.dtype)
        assert torch.equal(out[dev], want)
    with pytest.raises(ValueError):
        col.ppermute(x, MESH, "model", [(0, 1), (2, 1)])


@pytest.mark.parametrize("spec", [P(), P("model"), P(None, ("data", "model")),
                                  P(("pod", "model"), "data"), P("data", None, "pod")])
def test_place_and_gather_are_the_device_layout(spec):
    full = torch.arange(24 * 12 * 4, dtype=torch.float32).reshape(24, 12, 4)
    blocks = place(full, MESH, spec)
    entries = [() if e is None else ((e,) if isinstance(e, str) else e)
               for e in tuple(spec) + (None,) * (3 - len(spec))]
    for dev in _devices():
        idx = []
        for size, axes in zip(full.shape, entries):
            n = math.prod(MESH.shape[a] for a in axes)
            block = 0
            for a in axes:
                block = block * MESH.shape[a] + dev[MESH.dim(a)]
            idx.append(slice(block * size // n, (block + 1) * size // n))
        assert torch.equal(blocks[dev], full[tuple(idx)])
    assert torch.equal(gather(blocks, MESH, spec), full)
    with pytest.raises(ValueError):
        place(full[:, :5], MESH, P(None, "data"))


# ---------------------------------------------------------------------------
# the schedules over distinct replicas and stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,data", [((16, 8), 2), ((5,), 2), ((3, 7), 3)])
def test_hierarchical_mean_of_distinct_replicas_is_their_mean(shape, data):
    """Every (pod, data) replica holds its own gradient (and the model axis copies
    it); the result, on every device, is the mean over the replicas, padding
    included when the flat size does not divide over data."""
    from repro_torch.train.grad_sync import hierarchical_mean

    mesh = Mesh((2, data, 2), ("pod", "data", "model"))
    g = torch.Generator().manual_seed(5)
    reps = torch.randn(2, data, *shape, generator=g, dtype=torch.float64)
    blocks = reps[:, :, None].expand(2, data, 2, *shape)
    out = hierarchical_mean({"g": blocks}, mesh)["g"]
    want = reps.mean(dim=(0, 1))
    assert out.shape == blocks.shape
    for dev in np.ndindex(*mesh.sizes):
        torch.testing.assert_close(out[dev], want, rtol=1e-12, atol=1e-12)


def test_pipeline_runs_every_stage_on_every_tick():
    """GPipe's (M + S − 1)·S stage calls, bubbles included (their results masked),
    and the serial result for each microbatch."""
    from repro_torch.train.pipeline import pipelined_forward

    calls = []

    def stage_fn(xm, w):
        calls.append(float(w))
        return xm * w + 1

    x = torch.arange(5 * 3, dtype=torch.float64).reshape(5, 3)
    w = torch.tensor([2.0, 3.0, 5.0], dtype=torch.float64)
    out = pipelined_forward(Mesh((3, 2), ("stage", "dp")), "stage", 3, 5, stage_fn, x, w)
    assert len(calls) == (5 + 3 - 1) * 3
    want = x
    for s in range(3):
        want = want * w[s] + 1
    assert torch.equal(out, want)
    with pytest.raises(ValueError):
        pipelined_forward(Mesh((2,), ("stage",)), "stage", 3, 5, stage_fn, x, w)


@pytest.mark.parametrize("mesh_shape,names", [((4,), ("model",)), ((2, 4), ("data", "model")),
                                              ((4, 2), ("model", "pod"))])
def test_split_kv_decode_on_meshes_with_other_axes(mesh_shape, names):
    """The KV slices live on the model axis wherever it sits among the mesh's
    axes; the other axes hold copies, and the result is the single-device one."""
    from repro_torch.dataplane.decode_attn import (reference_decode_attention,
                                                   split_kv_decode_attention)

    g = torch.Generator().manual_seed(6)
    q = torch.randn(3, 8, 16, generator=g)
    k, v = (torch.randn(3, 32, 2, 16, generator=g) for _ in range(2))
    out = split_kv_decode_attention(Mesh(mesh_shape, names), "model", q, k, v)
    torch.testing.assert_close(out, reference_decode_attention(q, k, v), rtol=1e-5, atol=1e-5)
