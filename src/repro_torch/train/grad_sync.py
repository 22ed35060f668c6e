"""Hierarchical gradient synchronization for multi-pod meshes.

On a (pod, data, model) mesh the naive DP gradient all-reduce spans pod × data —
crossing the (slower, oversubscribed) inter-pod links with full payload. The
hierarchical schedule:

    1. reduce-scatter within the pod over "data"   (fast intra-pod links)
    2. all-reduce the 1/data shards across "pod"    (inter-pod traffic ÷ data)
    3. all-gather within the pod over "data"

moves 2/data of the payload across pods instead of 2×. On one device the mesh is
virtual: every gradient leaf is laid out with one leading dim per mesh axis
(``distributed.specs.place``; a replicated leaf is ``place(g, mesh, P())``), and
each step is a reduction or broadcast over those dims
(``distributed.collectives``).
"""

from __future__ import annotations

from typing import Any

import torch

from ..distributed.collectives import all_gather, psum, psum_scatter
from ..distributed.ctx import Mesh


def _hier_one(g: torch.Tensor, mesh: Mesh, data_size: int, n_rep: int) -> torch.Tensor:
    """g: one leaf's per-device blocks (*mesh sizes, *shape). The mean's division
    is applied to the reduced shard, before the all-gather: the same operation on
    the same values as dividing the gathered sum, once per element rather than once
    per replica. The result is a broadcast view over the replicas."""
    lead = g.shape[:len(mesh.axis_names)]
    # flatten so the scatter axis always divides
    flat = g.reshape(*lead, -1)
    n = flat.shape[-1]
    pad = (-n) % data_size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    # 1. reduce-scatter over data (psum_scatter)
    shard = psum_scatter(flat.reshape(*lead, data_size, -1), mesh, "data", scatter_dimension=0)
    # 2. all-reduce across pods
    shard = psum(shard, mesh, "pod")
    # 3. all-gather back over data
    full = all_gather(shard / n_rep, mesh, "data", gather_axis=0).reshape(*lead, -1)
    if pad:
        full = full[..., :n]
    return full.reshape(g.shape)


def hierarchical_mean(grads: Any, mesh: Mesh) -> Any:
    """{name: per-device gradient blocks} (each leaf leading with the mesh's dims,
    already divided by the global batch) → the cross-replica mean over (pod,
    data), in the same layout, by the hierarchical schedule."""
    n_rep = mesh.shape["pod"] * mesh.shape["data"]
    data_size = mesh.shape["data"]
    return {k: _hier_one(g, mesh, data_size, n_rep) for k, g in grads.items()}
