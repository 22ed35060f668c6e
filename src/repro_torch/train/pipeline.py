"""Pipeline parallelism: a GPipe schedule over a "stage" axis of a virtual mesh.

Layers are split into S stages; M microbatches flow through; each tick every stage
computes its resident microbatch and ppermutes activations to the next stage.
Bubble fraction is the usual (S-1)/(M+S-1). On one device the stages are a
leading tensor dim: each tick runs ``stage_fn`` once per stage (bubble ticks
included, their results masked to zero, as on a real mesh), the ppermute is a
shift along that dim (``collectives.ppermute``), and the last stage's record is
broadcast by a masked psum over it."""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..distributed.collectives import ppermute, psum
from ..distributed.ctx import Mesh


def pipelined_forward(
    mesh: Mesh,
    stage_axis: str,
    n_stages: int,
    n_micro: int,
    stage_fn: Callable[[torch.Tensor, Any], torch.Tensor],
    x: torch.Tensor,           # (n_micro, B_micro, ...) microbatched input
    stage_params,              # indexable by stage: stage_params[s] is stage s's
) -> torch.Tensor:
    """GPipe forward: returns (n_micro, B_micro, ...) outputs from the last stage.

    stage_fn(x_micro, stage_params[s]) applies one stage's layers and keeps the
    microbatch's shape. ``x`` is replicated over every mesh axis and
    ``stage_params`` split over ``stage_axis`` alone, so the result does not
    depend on the other axes and the body runs over the stage dim only."""
    if mesh.shape[stage_axis] != n_stages:
        raise ValueError(f"axis {stage_axis!r} has {mesh.shape[stage_axis]} devices, "
                         f"not {n_stages} stages")
    stages = Mesh((n_stages,), (stage_axis,))
    ticks = n_micro + n_stages - 1
    buf = torch.zeros((n_stages,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    outs = torch.zeros((n_stages,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    last = n_stages - 1
    for t in range(ticks):
        # stage 0 injects microbatch t (when valid)
        inject = x[min(max(t, 0), n_micro - 1)]
        valid = [0 <= t - s < n_micro for s in range(n_stages)]
        ys = []
        for s in range(n_stages):
            y = stage_fn(inject if s == 0 else buf[s], stage_params[s])
            ys.append(y if valid[s] else torch.zeros_like(y))
        y = torch.stack(ys)
        # pass activations down the pipe
        buf = ppermute(y, stages, stage_axis, perm=[(i, i + 1) for i in range(last)])
        # last stage records its finished microbatch
        if valid[last]:
            outs[last, min(max(t - last, 0), n_micro - 1)] = y[last]
    # only the last stage's outs are real; broadcast via masked psum
    sid = stages.axis_index(stage_axis, x.device).reshape((-1,) + (1,) * x.dim())
    outs = psum(torch.where(sid == last, outs, torch.zeros_like(outs)), stages, stage_axis)
    return outs[0]
