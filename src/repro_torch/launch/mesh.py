"""The production meshes: shapes only. The port holds a mesh on one device as a
virtual mesh (``distributed/ctx.py``), so building one allocates nothing."""

from __future__ import annotations

from ..distributed.ctx import Mesh, MeshAxes


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16×16 = 256 devices (data, model). Multi-pod: 2×16×16 = 512
    devices (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def axes_for(mesh, sequence_parallel: bool = False) -> MeshAxes:
    names = mesh.axis_names
    data = tuple(n for n in names if n != "model")
    return MeshAxes(data=data, model="model", sequence_parallel=sequence_parallel)


def make_mesh(shape, axis_names) -> Mesh:
    """Elastic-scaling entry: a mesh of any geometry."""
    return Mesh(tuple(shape), tuple(axis_names))
