"""Collectives over a virtual mesh held on one device.

A tensor laid out on a :class:`~.ctx.Mesh` leads with one dimension per mesh
axis, in the mesh's order; the dimensions after them are each device's local
block (``specs.place`` builds such a layout). A collective over one axis is then
a reduction, transpose or shift along that axis's leading dimension. This module
is where the traffic that a real mesh sends over its interconnect happens, as
device-memory passes. Each function keeps its input's device and follows the
JAX collective of the same name with ``tiled=False``; local dimension numbers
(``split_axis``, ``scatter_dimension``, ...) count from the first local dimension.

A result that is the same on every device of an axis is returned as a broadcast
view along that axis (``expand``), not as copies. Every result is reported to
the cost counter (``analysis/cost.py``), if one is entered.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from ..analysis.cost import collective
from .ctx import Mesh


def _check(x: torch.Tensor, mesh: Mesh) -> int:
    n = len(mesh.axis_names)
    if x.dim() < n or tuple(x.shape[:n]) != mesh.sizes:
        raise ValueError(f"tensor of shape {tuple(x.shape)} is not laid out on {mesh!r}")
    return n


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum over the devices of ``axis``."""
    _check(x, mesh)
    return collective("psum", x.sum(dim=mesh.dim(axis), keepdim=True).expand_as(x), mesh.size)


def pmax(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Elementwise maximum over the devices of ``axis``."""
    _check(x, mesh)
    return collective("pmax", x.amax(dim=mesh.dim(axis), keepdim=True).expand_as(x), mesh.size)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Device i sends chunk j of its local ``split_axis`` (whose size is the axis
    size) to device j, which places it at index i of a new local ``concat_axis``:
    ``out[j][..., i (concat), ...] = x[i][..., j (split), ...]``."""
    n = _check(x, mesh)
    d = mesh.dim(axis)
    if x.shape[n + split_axis] != mesh.shape[axis]:
        raise ValueError(f"all_to_all: local dim {split_axis} of {tuple(x.shape[n:])} is not "
                         f"the size of axis {axis!r} ({mesh.shape[axis]})")
    out = x.transpose(d, n + split_axis).movedim(n + split_axis, n + concat_axis)
    return collective("all_to_all", out, mesh.size)


def psum_scatter(x: torch.Tensor, mesh: Mesh, axis: str,
                 scatter_dimension: int = 0) -> torch.Tensor:
    """Sum over ``axis``, device j keeping chunk j of local ``scatter_dimension``
    (whose size is the axis size; the dimension is removed)."""
    n = _check(x, mesh)
    d = mesh.dim(axis)
    if x.shape[n + scatter_dimension] != mesh.shape[axis]:
        raise ValueError(f"psum_scatter: local dim {scatter_dimension} of {tuple(x.shape[n:])} "
                         f"is not the size of axis {axis!r} ({mesh.shape[axis]})")
    return collective("psum_scatter", x.sum(dim=d).movedim(n - 1 + scatter_dimension, d),
                      mesh.size)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, gather_axis: int = 0) -> torch.Tensor:
    """Every device of ``axis`` gets the blocks of all of them, stacked along a new
    local dimension ``gather_axis`` in device order."""
    n = _check(x, mesh)
    d = mesh.dim(axis)
    out = x.movedim(d, n - 1 + gather_axis).unsqueeze(d)
    out = out.expand(*x.shape[:d], mesh.shape[axis], *out.shape[d + 1:])
    return collective("all_gather", out, mesh.size)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Iterable[Tuple[int, int]]) -> torch.Tensor:
    """Device ``dst`` receives device ``src``'s block for each (src, dst) pair;
    a device that is no destination gets zeros."""
    _check(x, mesh)
    d = mesh.dim(axis)
    src_of = {}
    for src, dst in perm:
        if dst in src_of:
            raise ValueError(f"ppermute: device {dst} receives twice")
        src_of[dst] = src
    zero = None
    parts = []
    for j in range(mesh.shape[axis]):
        if j in src_of:
            parts.append(x.select(d, src_of[j]))
        else:
            zero = torch.zeros_like(x.select(d, 0)) if zero is None else zero
            parts.append(zero)
    return collective("ppermute", torch.stack(parts, dim=d), mesh.size)
