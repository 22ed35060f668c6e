"""Pattern-group probes: the cost of one repeat of a step's repeated layers.

The JAX package scans the repeated layers, and XLA's cost analysis counts a scan
body once whatever its trip count, so its dry run lowers a standalone *probe* —
one pattern-group application with the same shapes, remat policy and (for train)
its VJP — and adds (R − 1) × probe to the module's count. The port runs eagerly:
:class:`~.cost.CostCounter` sees every repeat of the step, so its dry run needs
no such correction. It records the probes all the same, as the per-group
breakdown of the step, under the reference's contract:
``[(extra_repeats, {"flops", "bytes", "coll_bytes"}), ...]``.

Each probe is counted on ``meta`` tensors, under the mesh and axes the caller has
entered: one pattern group (the first repeat's layers) — for ``train`` through
``_block_apply`` under ``_remat_call`` with ``torch.autograd.grad`` with respect to
the group's input and parameters, for ``prefill`` through ``_block_prefill`` (the
step's own per-layer body, cache entries included), for ``decode`` through
``_block_decode`` with the group's cache slice; and for an encoder-decoder arch
one encoder block (R = ``n_enc_layers``). So a step of R groups less a step of R'
groups counts (R − R') × the probe, exactly (FLOPs; bytes too outside ``train``).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..distributed.ctx import shard
from ..models.layers import torch_dtype
from ..models.model import (ENCODER_SPEC, _block_apply, _block_decode, _block_prefill,
                            _positions, _remat_call)
from .cost import CostCounter
from .partition import Layout

META = torch.device("meta")


def _meta(shape, dtype, grad: bool = False) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META, requires_grad=grad)


def _count(fn, *args, layout=None) -> Dict[str, float]:
    with CostCounter(layout=layout) as c:
        fn(*args)
    return {k: float(v) for k, v in c.totals().items()}


def _train_probe(cfg, fn, layers, x_shape, dt, layout=None) -> Dict[str, float]:
    """``fn(x)`` under the config's remat, and its VJP with respect to ``x`` and
    the parameters of ``layers``."""
    params = [p for layer in layers for p in layer.parameters()]
    for p in params:
        p.requires_grad_(True)

    def probe():
        x = _meta(x_shape, dt, grad=True)
        with torch.enable_grad():
            y = _remat_call(cfg, fn, x)
            torch.autograd.grad(y, [x] + params, grad_outputs=_meta(x_shape, dt),
                                allow_unused=True)

    return _count(probe, layout=layout)


def probe_costs(
    cfg: ArchConfig,
    shape: ShapeSpec,
    kind: str,
    mesh,
    axes,
    params,
    p_specs,
    cache=None,
    cache_specs=None,
    layout: Optional[Layout] = None,
) -> List[Tuple[int, Dict[str, float]]]:
    """[(extra_repeats, {flops, bytes, coll_bytes}), ...], global counts on meta
    tensors, under the mesh and axes the caller has entered. ``mesh``, ``axes``,
    ``p_specs`` and ``cache_specs`` keep the reference's contract. With the step's
    ``layout`` (``analysis/partition.py``), each probe's ``coll_bytes`` also holds the
    collectives a partitioner adds to it, by the same rules."""
    out: List[Tuple[int, Dict[str, float]]] = []
    dt = torch_dtype(cfg)
    b, s_total, d = shape.batch, shape.seq, cfg.d_model
    n_pre, period = len(cfg.prefix), len(cfg.pattern)
    group = list(params.layers[n_pre:n_pre + period])
    enc_out = _meta((b, cfg.n_frontend, d), dt) if cfg.is_encdec else None
    enc_pos = _positions(cfg.n_frontend, META) if cfg.is_encdec else None

    if kind in ("train", "prefill"):
        positions = _positions(s_total, META)

        # a group's input has the layout every block leaves the residual stream in
        def group_fwd(x):
            x = shard(x, "dp", "sp", None)
            for layer in group:
                x, _ = _block_apply(cfg, layer.spec, layer, x, positions, enc_out=enc_out,
                                    enc_positions=enc_pos)
            return x

        def group_prefill(x):
            x = shard(x, "dp", "sp", None)
            for layer in group:
                x, _ = _block_prefill(cfg, layer, x, positions, s_total, s_total, enc_out,
                                      enc_pos)

        if kind == "train":
            costs = _train_probe(cfg, group_fwd, group, (b, s_total, d), dt, layout)
        else:
            costs = _count(torch.no_grad()(group_prefill), _meta((b, s_total, d), dt),
                           layout=layout)
        out.append((cfg.n_repeats - 1, costs))

        if cfg.is_encdec and cfg.n_enc_layers > 1:
            enc_layer = params.encoder.layers[0]
            xe_shape = (b, cfg.n_frontend, d)
            fwd = partial(_block_apply, cfg, ENCODER_SPEC, enc_layer, positions=enc_pos,
                          causal=False)

            def enc_fwd(x):
                return fwd(shard(x, "dp", "sp", None))[0]

            if kind == "train":
                costs = _train_probe(cfg, enc_fwd, [enc_layer], xe_shape, dt, layout)
            else:
                costs = _count(torch.no_grad()(enc_fwd), _meta(xe_shape, dt), layout=layout)
            out.append((cfg.n_enc_layers - 1, costs))
        return out

    # decode: one-token pass through one pattern group with its cache slice
    group_cache = cache["layers"][n_pre:n_pre + period]

    @torch.no_grad()
    def dec_group(x):
        for layer, c in zip(group, group_cache):
            x, _ = _block_decode(cfg, layer.spec, layer, c, x, s_total - 1, enc_out)

    out.append((cfg.n_repeats - 1, _count(dec_group, _meta((b, 1, d), dt), layout=layout)))
    return out
