"""The port's dry run (``repro_torch.launch.dryrun``, ``analysis/probes.py``)
against the JAX package's ``repro.launch.dryrun``.

The reference compiles each cell on 512 fake host devices, so it runs in a
subprocess with ``XLA_FLAGS`` set before jax starts (``REF_CODE``). Held equal
exactly: ``status``, ``reason``, ``n_chips``, ``model_flops_global`` and
``memory_analysis.argument_bytes`` on reduced cells, and the per-device argument
bytes of every arch x shape x production mesh at full width (the reference's
shard sum over its ``input_specs``, with no compile). FLOPs and bytes are counted
differently (XLA counts elementwise work and repeated work; the port's eager count
has neither), so their ratios are printed, not held; collective bytes (the port's
partitioner count, ``analysis/partition.py``) are held within [0.5, 2]x. Then the port alone: its count equal on CPU and
meta tensors, the probe identity, ``main``'s resume / --force / error cells, and
a run that builds only meta tensors.
"""

import dataclasses
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.cost import CostCounter
from repro_torch.configs import ARCHS, SHAPES, reduced_for_smoke
from repro_torch.distributed.ctx import Mesh, MeshAxes, axes_context, set_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import axes_for, make_production_mesh
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import init_params
from repro_torch.models.moe import moe_apply
from repro_torch.train.data import synth_batch
from repro_torch.train.step import TrainConfig, init_train_state, make_prefill_step, make_train_step

ROOT = Path(__file__).resolve().parents[1]

#: (arch, shape, multi_pod) of the reduced cells held against the reference
REDUCED_CELLS = [("h2o-danube-1.8b", "train_4k", False), ("h2o-danube-1.8b", "prefill_32k", False),
                 ("mamba2-780m", "decode_32k", True), ("whisper-small", "train_4k", False)]

REF_CODE = r"""
import os, sys, json, tempfile
from pathlib import Path
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, SHAPES, reduced_for_smoke
from repro.distributed.ctx import axes_context
from repro.distributed.specs import batch_pspecs, cache_pspecs, opt_state_pspecs, param_pspecs
from repro.launch import dryrun
from repro.launch.inputs import input_specs
from repro.launch.mesh import axes_for, make_production_mesh

cells = json.loads(sys.argv[1])
out = {"cells": {}, "args": {}}
for arch, shape, mp in cells:
    r = dryrun.run_cell(arch, shape, mp, cfg_override=reduced_for_smoke(ARCHS[arch]))
    out["cells"][f"{arch}|{shape}|{int(mp)}"] = {
        k: r.get(k) for k in ("status", "reason", "n_chips", "model_flops_global",
                              "memory_analysis", "flops_per_device", "bytes_per_device",
                              "coll_bytes_per_device")}

moe = reduced_for_smoke(ARCHS["deepseek-moe-16b"])
try:
    dryrun.run_cell("deepseek-moe-16b", "prefill_32k", False, cfg_override=moe)
    out["moe_error"] = None
except Exception as e:
    out["moe_error"] = f"{type(e).__name__}: {e}"
full_moe = ARCHS["deepseek-moe-16b"]
with tempfile.TemporaryDirectory() as tmp:
    dryrun.ART_DIR = Path(tmp)
    ARCHS["deepseek-moe-16b"] = moe
    sys.argv = ["dryrun", "--arch", "deepseek-moe-16b", "--shape", "prefill_32k"]
    try:
        dryrun.main()
        out["moe_main_exit"] = 0
    except SystemExit as e:
        out["moe_main_exit"] = e.code
    out["moe_main_cell"] = json.loads(next(Path(tmp).glob("*.json")).read_text())
    ARCHS["deepseek-moe-16b"] = full_moe


import dataclasses
out["variants"] = {v: {a: dataclasses.asdict(dryrun.apply_variant(c, v)) for a, c in ARCHS.items()}
                   for v in list(dryrun.VARIANTS) + ["baseline", "ssd64,spon"]}


def shard_sum(tree, specs, mesh):
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for d in NamedSharding(mesh, spec).shard_shape(leaf.shape):
            n *= d
        total += n * leaf.dtype.itemsize
    return total


for arch, cfg in sorted(ARCHS.items()):
    for name, shape in SHAPES.items():
        for mp in (False, True):
            mesh = make_production_mesh(multi_pod=mp)
            axes = axes_for(mesh, sequence_parallel=cfg.sequence_parallel)
            specs = input_specs(cfg, shape)
            with jax.sharding.set_mesh(mesh), axes_context(axes):
                p_specs = param_pspecs(specs["params"], mesh, axes)
                total = shard_sum(specs["params"], p_specs, mesh)
                if shape.kind == "train":
                    total += shard_sum(specs["opt_state"],
                                       opt_state_pspecs(p_specs, specs["opt_state"], mesh, axes), mesh)
                if shape.kind in ("train", "prefill"):
                    total += shard_sum(specs["batch"], batch_pspecs(specs["batch"], mesh, axes), mesh)
                else:
                    total += shard_sum(specs["cache"], cache_pspecs(specs["cache"], mesh, axes, cfg),
                                       mesh)
                    total += shard_sum(specs["tokens"], batch_pspecs(specs["tokens"], mesh, axes),
                                       mesh)
            out["args"][f"{arch}|{name}|{int(mp)}"] = total
print("REF_JSON " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    res = subprocess.run([sys.executable, "-c", REF_CODE, json.dumps(REDUCED_CELLS)],
                         capture_output=True, text=True, timeout=600, env=env, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    line = next(ln for ln in res.stdout.splitlines() if ln.startswith("REF_JSON "))
    return json.loads(line[len("REF_JSON "):])


def _reduced(arch, **kw):
    return replace(reduced_for_smoke(ARCHS[arch]), **kw)


@pytest.mark.parametrize("arch,shape,multi_pod", REDUCED_CELLS)
def test_run_cell_matches_reference(reference, arch, shape, multi_pod):
    want = reference["cells"][f"{arch}|{shape}|{int(multi_pod)}"]
    got = dryrun.run_cell(arch, shape, multi_pod, cfg_override=_reduced(arch))
    for key in ("status", "reason", "n_chips", "model_flops_global"):
        assert got.get(key) == want[key], key
    assert (got["memory_analysis"]["argument_bytes"]
            == want["memory_analysis"]["argument_bytes"])
    ratios = {k: got[k] / want[k] if want[k] else None
              for k in ("flops_per_device", "bytes_per_device", "coll_bytes_per_device")}
    print(f"\n{arch} {shape} {'pod2' if multi_pod else 'pod1'}: argument bytes "
          f"{got['memory_analysis']['argument_bytes']:,}; port / reference {ratios}")
    # collective bytes: the program's and the partitioner's (analysis/partition.py),
    # within the band tests/test_torch_partition.py holds at full width
    assert got["coll_bytes_per_device"] == got["collectives"]["total_bytes"] > 0
    assert 0.5 <= ratios["coll_bytes_per_device"] <= 2.0


def test_reduced_moe_on_a_production_mesh_is_refused_by_both(reference, tmp_path, monkeypatch):
    """4 experts do not divide over the model axis of 16: the reference asserts, the
    port raises a ValueError naming the experts and the model shards; ``main``
    records the cell as an error in both and exits 1."""
    assert reference["moe_error"].startswith("AssertionError")
    moe = _reduced("deepseek-moe-16b")
    with pytest.raises(ValueError, match="4 experts do not divide over 16 model shards"):
        dryrun.run_cell("deepseek-moe-16b", "prefill_32k", False, cfg_override=moe)
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    monkeypatch.setitem(dryrun.ARCHS, "deepseek-moe-16b", moe)
    with pytest.raises(SystemExit) as exit_info:
        dryrun.main(["--arch", "deepseek-moe-16b", "--shape", "prefill_32k"])
    assert exit_info.value.code == reference["moe_main_exit"] == 1
    cell = json.loads(next(tmp_path.glob("*.json")).read_text())
    ref_cell = reference["moe_main_cell"]
    assert cell["status"] == ref_cell["status"] == "error"
    assert cell["error"].startswith("ValueError") and ref_cell["error"].startswith("AssertionError")
    assert {k: cell[k] for k in ("arch", "shape", "multi_pod", "variant")} == {
        k: ref_cell[k] for k in ("arch", "shape", "multi_pod", "variant")}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_width_argument_bytes_equal_reference(reference, arch):
    """Every shape on both production meshes, at the published widths."""
    cfg = ARCHS[arch]
    for name, shape in SHAPES.items():
        for mp in (False, True):
            mesh = make_production_mesh(multi_pod=mp)
            axes = axes_for(mesh, sequence_parallel=cfg.sequence_parallel)
            got = dryrun.argument_bytes(cfg, shape, mesh, axes)
            assert got == reference["args"][f"{arch}|{name}|{int(mp)}"], (name, mp)


def test_variants_transform_configs_as_the_reference(reference):
    assert set(reference["variants"]) == set(dryrun.VARIANTS) | {"baseline", "ssd64,spon"}
    for variant, by_arch in reference["variants"].items():
        for arch, want in by_arch.items():
            got = dataclasses.asdict(dryrun.apply_variant(ARCHS[arch], variant))
            assert json.loads(json.dumps(got)) == want, (variant, arch)


def _meta_like(batch):
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}


@pytest.mark.parametrize("arch,remat", [("h2o-danube-1.8b", "nothing"), ("mamba2-780m", "nothing"),
                                        ("whisper-small", "none")])
def test_cost_counter_counts_the_same_on_cpu_and_meta(arch, remat):
    """A train step and a prefill of a reduced arch: FLOPs, bytes, kernel units and
    every aten op's count equal on CPU tensors (the plain versions run inside the
    units) and on meta stand-ins."""
    cfg = _reduced(arch, remat=remat)
    tcfg = TrainConfig()
    raw = synth_batch(cfg, step=0, global_batch=2, seq=16)    # within danube's 16-token window
    cpu_batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    counts = []
    for device, batch in (("cpu", cpu_batch), ("meta", _meta_like(cpu_batch))):
        model = init_params(cfg, seed=0, device=device)
        state = init_train_state(cfg, tcfg, model)
        with CostCounter() as train:
            make_train_step(cfg, tcfg)(model, state, batch)
        with CostCounter() as pre:
            make_prefill_step(cfg)(model, {k: v for k, v in batch.items() if k != "labels"})
        counts.append([(c.flops, c.bytes, c.units, c.by_op) for c in (train, pre)])
    assert counts[0] == counts[1]
    assert all(c[2] for c in counts[0])          # the path went through a kernel unit


def _cell(arch, shape, **kw):
    cfg = _reduced(arch, **kw)
    return cfg, dryrun.run_cell(arch, shape, False, cfg_override=cfg)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-780m"])
@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k", "decode_32k"])
def test_probe_is_the_cost_of_one_pattern_group(arch, shape):
    """count(step at 2R groups) - count(step at R groups) = R x probe, exactly:
    FLOPs in every kind, bytes in prefill and decode (a train step's optimizer and
    gradient bookkeeping add bytes outside the groups)."""
    cfg, small = _cell(arch, shape)
    r = cfg.n_repeats
    n_layers = len(cfg.prefix) + 2 * r * len(cfg.pattern)
    _, big = _cell(arch, shape, n_layers=n_layers)
    n = small["n_chips"]
    (extra, probe), = [(p["extra_repeats"], p) for p in small["probes"]]
    assert extra == r - 1
    keys = ("flops",) if shape == "train_4k" else ("flops", "bytes")
    for key in keys:
        diff = big["raw_module"][key] - small["raw_module"][key]
        assert diff == r * probe[key] * n > 0, key


def test_main_skips_cached_cells_recomputes_on_force_and_retries_errors(tmp_path, monkeypatch,
                                                                        capsys):
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    monkeypatch.setitem(dryrun.ARCHS, "mamba2-780m", _reduced("mamba2-780m"))
    args = ["--arch", "mamba2-780m", "--shape", "decode_32k"]
    dryrun.main(args)
    path = tmp_path / "mamba2-780m__decode_32k__pod1__baseline.json"
    first = json.loads(path.read_text())
    assert first["status"] == "ok" and "dry-run complete" in capsys.readouterr().out
    assert not list(tmp_path.glob("*.tmp"))              # written atomically
    dryrun.main(args)
    assert "[skip-cached]" in capsys.readouterr().out
    dryrun.main(args + ["--force"])
    assert "[ok] mamba2-780m__decode_32k__pod1" in capsys.readouterr().out
    path.write_text(json.dumps({"status": "error", "error": "earlier crash"}))
    dryrun.main(args)
    out = capsys.readouterr().out
    assert "[skip-cached]" not in out and json.loads(path.read_text())["status"] == "ok"
    dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k", "--multi-pod"])
    cell = json.loads((tmp_path / "mamba2-780m__long_500k__pod2__baseline.json").read_text())
    assert cell["status"] == "ok" and cell["n_chips"] == 512
    monkeypatch.setitem(dryrun.ARCHS, "whisper-small", _reduced("whisper-small"))
    dryrun.main(["--arch", "whisper-small", "--shape", "long_500k"])
    cell = json.loads((tmp_path / "whisper-small__long_500k__pod1__baseline.json").read_text())
    assert cell["status"] == "skipped" and "sub-quadratic" in cell["reason"]


class _Devices(TorchDispatchMode):
    """The device types of every tensor any aten op returns."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.add(t.device.type)
        return out


@pytest.mark.parametrize("arch,shape", [("h2o-danube-1.8b", "train_4k"),
                                        ("mamba2-780m", "decode_32k"),
                                        ("whisper-small", "prefill_32k"),
                                        ("internvl2-26b", "decode_32k")])
def test_run_cell_builds_only_meta_tensors(arch, shape):
    with _Devices() as devices:
        res = dryrun.run_cell(arch, shape, True, cfg_override=_reduced(arch))
    assert res["status"] == "ok"
    assert devices.seen == {"meta"}


def test_a2a_dispatch_counts_its_two_all_to_alls():
    """Reduced deepseek-moe-16b's MoE layer on a (data 2, model 4) mesh: "a2a"
    sends the capacity buffers out and back (the reference's two all_to_all)."""
    cfg = _reduced("deepseek-moe-16b")
    model = init_params(cfg, device="meta")
    moe_layer = next(layer for layer in model.layers if hasattr(layer, "moe"))
    x = torch.empty((2, 16, cfg.d_model), dtype=torch_dtype(cfg), device="meta")
    mesh = Mesh((2, 4), ("data", "model"))
    with set_mesh(mesh), axes_context(MeshAxes(data=("data",), model="model")):
        with CostCounter() as c:
            moe_apply(cfg, moe_layer.moe, x)
    coll = c.collectives
    assert coll["all-to-all_count"] == 2
    assert coll["total_bytes"] == coll["all-to-all_bytes"] > 0
