"""The port's cost analysis: FLOPs, bytes and collective bytes of a step, counted
as it runs (the counterpart of XLA's ``compiled.cost_analysis()``, which an eager
port does not have).

:class:`CostCounter` is a ``TorchDispatchMode``. Inside it every aten op adds:

- **flops**: ``torch.utils.flop_counter``'s registered formula for the op (mm,
  bmm, addmm, baddbmm, convolution, SDPA, ...); other ops add none;
- **bytes**: the bytes of its tensor inputs plus those of its tensor outputs, if
  it moves data. An op whose schema returns aliases of its inputs (``view``,
  ``expand``, ``permute``, ``slice``, ``select``, ``detach``, ...), or whose
  outputs share an input's storage without saying so (``_unsafe_view``), moves
  none; neither does an allocation (``empty``, ``empty_strided``, ...). An op
  that writes an argument (``copy_``, ``add_``, ``index_put_``) always does.
  This is what the eager port moves, unfused.

**A kernel-library op is one counted unit.** ``kernels.ops.flash_attention`` and
``ssd_chunk`` run inside :func:`kernel_unit`, which adds the op's
``roofline.kernel_costs`` and counts nothing inside it. So a count is the same
on ``meta`` tensors (the op returns empty outputs), on CPU tensors (its plain
version runs inside) and on CUDA tensors (the kernel launches).

**Collectives.** Every function of ``distributed/collectives.py`` reports its
result to :func:`collective` under ``roofline.collective_bytes``'s keys
(``psum``/``pmax`` → all-reduce, ``all_gather`` → all-gather, ``psum_scatter`` →
reduce-scatter, ``all_to_all`` → all-to-all, ``ppermute`` → collective-permute),
by its result bytes per device of the collective's own mesh.

**The partitioner's collectives.** A sharded step also needs the collectives
XLA's partitioner inserts into the JAX package's step (the FSDP all-gathers, the
tensor-parallel all-reduces, the gradient reductions). A one-card port runs none
of them; ``CostCounter(layout=Layout(...))`` counts them all the same, derived
from the spec rules by :class:`~.partition.Partitioner` op by op in the same run
(``analysis/partition.py`` states the rules), and :attr:`CostCounter.collectives`
then holds the program's collectives and the partitioner's. A bare
``CostCounter()`` counts the program's alone.

What XLA counts and this does not: elementwise FLOPs and work that every device
of a mesh repeats. FLOPs and bytes are global: per device, the dry run divides
them by the mesh's device count (the sharded ideal); collective bytes are per
device already.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .partition import Layout, Partitioner
from .roofline import COLLECTIVES, kernel_costs

_aten = torch.ops.aten
#: allocations: their outputs hold no data yet
_ALLOCATIONS = frozenset({_aten.empty.memory_format, _aten.empty_strided.default,
                          _aten.empty_like.default, _aten.new_empty.default,
                          _aten.new_empty_strided.default})

#: the collective kinds of ``distributed/collectives.py``'s functions
COLLECTIVE_KIND = {"psum": "all-reduce", "pmax": "all-reduce", "all_gather": "all-gather",
                   "psum_scatter": "reduce-scatter", "all_to_all": "all-to-all",
                   "ppermute": "collective-permute"}

_ACTIVE: List["CostCounter"] = []


def _tensors(xs, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors among ``xs``, in lists and tuples too, appended to ``out``."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


#: per op, from its schema: (writes an argument, returns only aliases)
_SCHEMA_ALIASES: Dict[object, Tuple[bool, bool]] = {}


def _moves_data(func, ins, outs) -> bool:
    """Whether an op reads or writes tensor data, from its schema's alias
    annotations (and, for outputs it leaves unannotated, their storage)."""
    aliases = _SCHEMA_ALIASES.get(func)
    if aliases is None:
        schema = func._schema
        aliases = _SCHEMA_ALIASES[func] = (
            any(a.alias_info is not None and a.alias_info.is_write for a in schema.arguments),
            all(r.alias_info is not None for r in schema.returns))
    writes, only_aliases = aliases
    if writes:
        return True
    if only_aliases or func in _ALLOCATIONS or not outs:
        return False
    held = {StorageWeakRef(t.untyped_storage()) for t in ins}
    return any(StorageWeakRef(t.untyped_storage()) not in held for t in outs)


class CostCounter(TorchDispatchMode):
    """``with CostCounter() as c: step(...)`` → ``c.flops``, ``c.bytes``,
    ``c.collectives`` (``collective_bytes``'s keys, per device), ``c.units``
    (kernel-library calls by name) and ``c.by_op`` ({aten op: [calls, flops,
    bytes]}). One counter at a time: entering a second one raises.

    With a :class:`~.partition.Layout`, the counter also counts the collectives a
    partitioner adds to the step laid out so (``analysis/partition.py``):
    ``c.collectives`` then holds the program's and the partitioner's, and
    ``c.partitioner_collectives`` the partitioner's alone."""

    def __init__(self, layout: Optional[Layout] = None):
        super().__init__()
        self.partition = None if layout is None else Partitioner(layout)
        self.flops = 0
        self.bytes = 0
        self.units: Dict[str, int] = {}
        self.by_op: Dict[str, List[int]] = {}
        self._coll = {k: 0 for k in COLLECTIVES}
        self._coll_n = {k: 0 for k in COLLECTIVES}
        self._inside = 0

    def __enter__(self):
        if _ACTIVE:
            raise RuntimeError("a CostCounter is already counting")
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        if self.partition is not None:
            self.partition.close()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        formula = flop_registry.get(func._overloadpacket)
        flops = 0 if formula is None else int(formula(*args, **kwargs, out_val=out))
        ins = _tensors(kwargs.values(), _tensors(args, []))
        outs = _tensors((out,), [])
        nbytes = _nbytes(ins) + _nbytes(outs) if _moves_data(func, ins, outs) else 0
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op.setdefault(str(func), [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        if self.partition is not None:
            self.partition.op(func, args, kwargs, out)
        return out

    @property
    def collectives(self) -> Dict[str, int]:
        coll, n = dict(self._coll), dict(self._coll_n)
        if self.partition is not None:
            for k in COLLECTIVES:
                coll[k] += self.partition.bytes[k]
                n[k] += self.partition.count[k]
        return {**{f"{k}_bytes": v for k, v in coll.items()},
                **{f"{k}_count": v for k, v in n.items()},
                "total_bytes": sum(coll.values())}

    @property
    def partitioner_collectives(self) -> Dict[str, int]:
        """The partitioner's part of :attr:`collectives` (zeros without a layout)."""
        if self.partition is None:
            return {**{f"{k}_bytes": 0 for k in COLLECTIVES},
                    **{f"{k}_count": 0 for k in COLLECTIVES}, "total_bytes": 0}
        return self.partition.totals()

    def totals(self) -> Dict[str, int]:
        return {"flops": self.flops, "bytes": self.bytes,
                "coll_bytes": self.collectives["total_bytes"]}


@contextlib.contextmanager
def kernel_unit(name: str, *tensors: torch.Tensor, **kw):
    """The body of a kernel-library op: to the counter entered, if any, one unit of
    ``kernel_costs(name, *tensors, **kw)`` and nothing of what runs inside."""
    counter = _ACTIVE[-1] if _ACTIVE else None
    if counter is None or counter._inside:
        yield
        return
    costs = kernel_costs(name, *tensors, **kw)
    counter.flops += costs["flops"]
    counter.bytes += costs["bytes"]
    counter.units[name] = counter.units.get(name, 0) + 1
    if counter.partition is not None:
        counter.partition.reduce_inputs(tensors)
    counter._inside += 1
    try:
        yield
    finally:
        counter._inside -= 1


def collective(name: str, result: torch.Tensor, n_devices: int) -> torch.Tensor:
    """Report a collective's result (laid out on a mesh of ``n_devices``) to the
    counter entered, if any; returns ``result``."""
    if _ACTIVE and not _ACTIVE[-1]._inside:
        counter = _ACTIVE[-1]
        kind = COLLECTIVE_KIND[name]
        counter._coll[kind] += result.numel() * result.element_size() // n_devices
        counter._coll_n[kind] += 1
        if counter.partition is not None:
            counter.partition.forget(result)
    return result


def constrain(x: torch.Tensor, logical) -> torch.Tensor:
    """``distributed.ctx.shard``'s body: ``x`` itself, unless the counter entered
    follows a layout, which then meets the constraint (``Partitioner.constrain``)."""
    counter = _ACTIVE[-1] if _ACTIVE else None
    if counter is None or counter.partition is None or counter._inside:
        return x
    return counter.partition.constrain(x, logical)
