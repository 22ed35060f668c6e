"""Sharding context: model code annotates activations with logical axes ("dp", "tp",
"sp", None); the context resolves them to mesh axis names.

Logical axes:
  dp — data-parallel: ("pod", "data") on the multi-pod mesh, ("data",) on one pod
  tp — tensor-parallel: "model"
  sp — sequence-parallel: "model" when cfg.sequence_parallel else None

The port holds a mesh on one device as a *virtual mesh*: a :class:`Mesh` names
its axes and their sizes, and a tensor laid out on it leads with one dimension
per axis, in the mesh's order (``specs.place``). :func:`set_mesh` makes one mesh
the ambient mesh (the JAX package's ``jax.set_mesh``), which the expert-parallel
MoE dispatch reads through :func:`current_mesh`.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..analysis.cost import constrain


@dataclass(frozen=True)
class MeshAxes:
    data: Tuple[str, ...] = ("data",)     # dp axes (includes "pod" when multi-pod)
    model: str = "model"
    sequence_parallel: bool = False

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical == "dp":
            return self.data if len(self.data) > 1 else self.data[0]
        if logical == "tp":
            return self.model
        if logical == "sp":
            return self.model if self.sequence_parallel else None
        raise ValueError(f"unknown logical axis {logical!r}")


class Mesh:
    """Named axes and their sizes, in order: shapes only, nothing allocated.
    ``mesh.shape[name]`` is an axis's size, as on a JAX mesh."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} differ")
        if any(int(n) < 1 for n in shape):
            raise ValueError(f"mesh axis sizes must be positive: {tuple(shape)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(n) for n in shape)))

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(self.shape.values())

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def dim(self, axis: str) -> int:
        """The leading tensor dimension that holds ``axis``."""
        if axis not in self.shape:
            raise ValueError(f"mesh {self!r} has no axis {axis!r}")
        return self.axis_names.index(axis)

    def axis_index(self, axis: str, device=None) -> torch.Tensor:
        """Each device's index along ``axis``, shaped to broadcast over the
        leading mesh dimensions (the twin of ``jax.lax.axis_index``)."""
        shape = [1] * len(self.axis_names)
        shape[self.dim(axis)] = self.shape[axis]
        return torch.arange(self.shape[axis], device=device).reshape(shape)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


_AXES: Optional[MeshAxes] = None
_MESH: Optional[Mesh] = None


def set_axes(axes: Optional[MeshAxes]) -> None:
    global _AXES
    _AXES = axes


def current_axes() -> Optional[MeshAxes]:
    return _AXES


@contextlib.contextmanager
def axes_context(axes: Optional[MeshAxes]):
    global _AXES
    prev = _AXES
    _AXES = axes
    try:
        yield
    finally:
        _AXES = prev


def current_mesh() -> Optional[Mesh]:
    """The ambient mesh, or None outside :func:`set_mesh`."""
    return _MESH


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the ambient mesh inside the block."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The JAX package's ``with_sharding_constraint``, called where its models call
    it: on one device there is no layout to constrain, so ``x`` itself, unless a
    cost counter follows a layout (``analysis/partition.py``), which then counts
    the collectives the constraint calls for."""
    return constrain(x, logical)
