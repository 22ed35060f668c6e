"""Multi-pod dry run: count every (architecture × input shape) step on the
single-pod (16, 16) mesh and the 2-pod (2, 16, 16) mesh, and write per-cell JSON
artifacts for the roofline table.

The step runs once on ``meta`` tensors (``launch/inputs.py``'s stand-ins: shape
and dtype, no storage) under the production virtual mesh and its axes, inside
:class:`~..analysis.cost.CostCounter`: nothing is allocated on any device, and the
count is host arithmetic, as the JAX package's compile on fake host devices is.
The kernel-library ops count as one unit each, where the card runs its kernel.

    PYTHONPATH=src python -m repro_torch.launch.dryrun                      # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod --arch mamba2-780m ...

Idempotent and fault-tolerant: each cell's artifact is written atomically to
artifacts/dryrun_torch/; existing artifacts are skipped unless --force, and cells
that failed are always retried.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from dataclasses import replace as _replace
from pathlib import Path

import torch

from ..analysis.cost import CostCounter
from ..analysis.partition import Layout
from ..analysis.probes import probe_costs
from ..analysis.roofline import HW, HW_H100, model_flops, roofline_terms
from ..configs import ARCHS, SHAPES, shape_applicable
from ..distributed.ctx import axes_context, set_mesh
from ..distributed.specs import (
    P,
    batch_pspecs,
    cache_pspecs,
    opt_state_pspecs,
    param_pspecs,
    shard_shape,
)
from ..train.step import TrainConfig, make_prefill_step, make_serve_step, make_train_step
from .inputs import input_specs
from .mesh import axes_for, make_production_mesh

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# config transforms, comma-separated: --variant ssd64,spon → artifacts tagged "ssd64,spon"
VARIANTS = {
    "ssd64": lambda c: _replace(c, ssd_chunk=64),
    "ssd128": lambda c: _replace(c, ssd_chunk=128),
    "spon": lambda c: _replace(c, sequence_parallel=True),
    "spoff": lambda c: _replace(c, sequence_parallel=False),
    "cap100": lambda c: _replace(c, capacity_factor=1.0),
    "densemoe": lambda c: _replace(c, moe_dispatch="dense"),
    "rematdots": lambda c: _replace(c, remat="dots"),
    "rematnone": lambda c: _replace(c, remat="none"),
    "splayer": lambda c: _replace(c, sp_boundary="layer"),
    # the current source tree: identity
    "code": lambda c: c,
    # layer-boundary SP resharding where SP is on, capacity 1.0 for MoE dispatch
    "opt": lambda c: _replace(
        c,
        sp_boundary="layer" if c.sequence_parallel else c.sp_boundary,
        capacity_factor=1.0 if c.n_experts else c.capacity_factor,
    ),
}


def apply_variant(cfg, variant: str):
    if variant == "baseline":
        return cfg
    for name in variant.split(","):
        cfg = VARIANTS[name](cfg)
    return cfg


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes each device holds of ``tree`` (nested dicts and lists of tensors, a
    ``Model``) laid out by the matching ``specs``. A host int (the cache's
    ``pos``) is the JAX package's int32 scalar: 4 bytes."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(specs, P):
        if isinstance(tree, int):
            return 4
        n = 1
        for size in shard_shape(tree.shape, mesh, specs):
            n *= size
        return n * tree.element_size()
    if isinstance(specs, dict):
        return sum(shard_bytes(tree[k], s, mesh) for k, s in specs.items())
    return sum(shard_bytes(t, s, mesh) for t, s in zip(tree, specs, strict=True))


def _replicated(tree):
    return {k: P(*([None] * v.dim())) for k, v in tree.items()}


def step_inputs(cfg, shape, specs, mesh, axes, tcfg: TrainConfig):
    """The step a cell runs, its arguments (``specs``, from ``input_specs``) and
    the spec tree of each argument under the rules."""
    p_specs = param_pspecs(specs["params"], mesh, axes)
    if shape.kind == "train":
        o_specs = opt_state_pspecs(p_specs, specs["opt_state"], mesh, axes)
        return (make_train_step(cfg, tcfg),
                (specs["params"], specs["opt_state"], specs["batch"]),
                (p_specs, o_specs, batch_pspecs(specs["batch"], mesh, axes)))
    if shape.kind == "prefill":
        return (make_prefill_step(cfg), (specs["params"], specs["batch"]),
                (p_specs, batch_pspecs(specs["batch"], mesh, axes)))
    tokens = specs["tokens"]
    return (make_serve_step(cfg), (specs["params"], specs["cache"], tokens),
            (p_specs, cache_pspecs(specs["cache"], mesh, axes, cfg),
             batch_pspecs({"tokens": tokens}, mesh, axes)["tokens"]))


def argument_bytes(cfg, shape, mesh, axes, tcfg: TrainConfig | None = None) -> int:
    """Bytes each device holds of a cell's inputs (parameters, optimizer state and
    batch; or parameters, cache and tokens) under the spec rules: the figure XLA's
    ``memory_analysis().argument_size_in_bytes`` gives for the JAX package's step."""
    specs = input_specs(cfg, shape, tcfg or TrainConfig())
    _, args, arg_specs = step_inputs(cfg, shape, specs, mesh, axes, tcfg or TrainConfig())
    return sum(shard_bytes(a, s, mesh) for a, s in zip(args, arg_specs))


def run_cell(arch: str, shape_name: str, multi_pod: bool, tcfg: TrainConfig | None = None,
             variant: str = "baseline", cfg_override=None) -> dict:
    cfg = cfg_override if cfg_override is not None else apply_variant(ARCHS[arch], variant)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "variant": variant, "status": "skipped", "reason": why}

    mesh = make_production_mesh(multi_pod=multi_pod)
    axes = axes_for(mesh, sequence_parallel=cfg.sequence_parallel)
    tcfg = tcfg or TrainConfig()

    t0 = time.time()
    with set_mesh(mesh), axes_context(axes):
        specs = input_specs(cfg, shape, tcfg)
        step, args, arg_specs = step_inputs(cfg, shape, specs, mesh, axes, tcfg)
        args_bytes = sum(shard_bytes(a, s, mesh) for a, s in zip(args, arg_specs))
        if shape.kind == "decode":
            # a full context: the token at the last position, as the probe has it
            specs["cache"]["pos"] = shape.seq - 1
        t_lower = time.time() - t0

        cache = specs.get("cache") if shape.kind == "decode" else None
        layout = Layout(mesh, axes, args[0], arg_specs[0], arg_specs[-1], cache=cache,
                        cache_specs=arg_specs[1] if cache is not None else None)
        with CostCounter(layout=layout) as counter:
            outs = step(*args)
        t_compile = time.time() - t0 - t_lower

        # the outputs by the same rules (XLA's figure leaves out outputs that alias
        # donated inputs; this one counts every output)
        if shape.kind == "train":
            _, new_opt, metrics = outs
            out_bytes = (shard_bytes(args[0], arg_specs[0], mesh)
                         + shard_bytes(new_opt, arg_specs[1], mesh)
                         + shard_bytes(metrics, _replicated(metrics), mesh))
        else:
            *heads, cache = outs
            heads = dict(zip(("next", "logits")[-len(heads):], heads))
            out_bytes = (shard_bytes(heads, batch_pspecs(heads, mesh, axes), mesh)
                         + shard_bytes(cache, cache_pspecs(cache, mesh, axes, cfg), mesh))

        probes = probe_costs(
            cfg, shape, shape.kind, mesh, axes, args[0], arg_specs[0],
            cache=specs.get("cache"),
            cache_specs=arg_specs[1] if shape.kind == "decode" else None,
            layout=layout,
        )

    n_chips = mesh.size
    coll = counter.collectives
    flops_raw, bytes_raw = float(counter.flops), float(counter.bytes)
    coll_raw = float(coll["total_bytes"])
    # the count is global (every device's share of an eager step): per device, the
    # sharded ideal; the collectives are per device already. The probes are a
    # breakdown: eager counting ran every repeat, so nothing is added for them
    flops_dev, bytes_dev = flops_raw / n_chips, bytes_raw / n_chips
    probe_list = [{"extra_repeats": extra, **{k: v / n_chips if k != "coll_bytes" else v
                                              for k, v in c.items()}}
                  for extra, c in probes]

    terms = roofline_terms(flops_dev, bytes_dev, coll_raw, HW())
    mflops = model_flops(cfg, shape, shape.kind)
    useful = mflops / max(1.0, flops_dev * n_chips)

    return {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "multi_pod": multi_pod,
        "variant": variant,
        "status": "ok",
        "n_chips": int(n_chips),
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "coll_bytes_per_device": coll_raw,
        "raw_module": {"flops": flops_raw, "bytes": bytes_raw, "coll_bytes": coll_raw},
        "kernel_units": dict(counter.units),
        "probes": probe_list,
        "collectives": coll,
        "collectives_partitioner": counter.partitioner_collectives,
        "memory_analysis": {
            "argument_bytes": args_bytes,
            "output_bytes": out_bytes,
            # an eager meta run has no allocator plan: no temp or peak figure
            "temp_bytes": None,
            "peak_bytes": None,
        },
        "roofline": terms,
        "roofline_h100": roofline_terms(flops_dev, bytes_dev, coll_raw, HW_H100),
        "model_flops_global": mflops,
        "useful_flops_fraction": useful,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape cell (default: all)")
    ap.add_argument("--multi-pod", action="store_true", help="2-pod 512-chip mesh")
    ap.add_argument("--both-meshes", action="store_true", help="run single- AND multi-pod")
    ap.add_argument("--force", action="store_true", help="recompute existing artifacts")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)

    ART_DIR.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}__{args.variant}"
                path = ART_DIR / f"{tag}.json"
                if path.exists() and not args.force:
                    prev = json.loads(path.read_text())
                    if prev.get("status") != "error":  # errors always retried
                        print(f"[skip-cached] {tag}")
                        continue
                print(f"[cell] {tag} ...", flush=True)
                try:
                    res = run_cell(arch, shape, mp, variant=args.variant)
                except Exception as e:  # record the failure; keep going
                    res = {
                        "arch": arch, "shape": shape, "multi_pod": mp,
                        "variant": args.variant, "status": "error",
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:],
                    }
                    failures.append(tag)
                tmp = path.with_suffix(".tmp")
                tmp.write_text(json.dumps(res, indent=2, default=str))
                tmp.rename(path)
                status = res["status"]
                if status == "ok":
                    r = res["roofline_h100"]
                    extra = (
                        f" bottleneck={r['bottleneck']}"
                        f" t_c={r['t_compute_s']:.4f}s t_m={r['t_memory_s']:.4f}s"
                        f" t_x={r['t_collective_s']:.4f}s (H100) count={res['compile_s']:.1f}s"
                    )
                elif status == "skipped":
                    extra = f" ({res['reason']})"
                else:
                    extra = f" ({res['error'][:120]})"
                print(f"[{status}] {tag}{extra}", flush=True)

    if failures:
        print(f"FAILED cells: {failures}")
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
