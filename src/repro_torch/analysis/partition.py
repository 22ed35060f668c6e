"""The collectives a GSPMD partitioner adds to a sharded step, derived from the spec
rules (the port's counterpart of what XLA's SPMD partitioner inserts into the JAX
package's jitted step, which its dry run reads off the compiled HLO).

The JAX package lays every input of a step out by ``distributed/specs.py``, pins a
few activations with ``with_sharding_constraint``, and lets the partitioner insert
the communication the layouts call for. The port runs the step eagerly on one
device, so nothing inserts it: :class:`Partitioner` follows the same layouts through
the eager run, op by op, on the same tensors (``meta``, CPU or CUDA alike), inside
:class:`~.cost.CostCounter` (``CostCounter(layout=Layout(...))``), and counts a
collective wherever an operand's layout does not fit its op. A bare
``CostCounter()`` has no partitioner.

**What it tracks.** For every tensor of the step: which of its dims is split over the
model axis (None: replicated over it), and whether it is a partial sum over the model
axis that no op has reduced yet. Parameters and cache entries start from their specs
(found by storage, so every view of one is one too); the step's inputs and
everything made on the host start replicated; views map the split dim by strides,
elementwise ops align it by broadcasting, products by their roles (batch, free or
contracted dim), reductions, gathers and concatenations by their dims. The data
axes shard every activation's batch dim and the parameters' ``fsdp`` dims, as the
rules place them; they are not tracked op by op.

**Rules.** Each collective is counted under ``roofline.COLLECTIVES``' keys as its
result bytes per device (the convention of ``roofline.collective_bytes``): an
activation's bytes over the data-axis shard of its leading batch dim
(``batch_pspecs``), a parameter's over its model-axis shard.

- *FSDP all-gather.* Each product (``mm``, ``addmm``, ``bmm``, ``baddbmm``) that
  reads a parameter whose spec names the data axes, directly or through a view or a
  cast of it, all-gathers it over those axes: its model-axis shard, once per read
  (so again in each recompute and in the backward).
- *Model-axis partial sums.* A product whose contracted dim is split over the model
  axis on both operands (or on one, the other replicated) leaves a partial sum: the
  row-parallel products (``wo``, ``w_out``, Mamba's out projection, MLA's ``wo``) in
  the forward, and in the backward the input gradient of every column-parallel
  product (``W.T`` contracts the split ``f`` dim). So does a sum over a split dim,
  and a gather or index along one (the vocab-parallel embedding lookup; the loss's
  picked logit). The first op that is not a view or a cast to read a partial sum
  all-reduces it over the model axis, once. As in XLA's HLO, partial sums are not
  added before the reduction (three input gradients summed into one are three
  all-reduces), except scalars: a sum with a partial scalar stays one (the gradient
  norm's per-parameter sums of squares add up to one all-reduce). A partial sum
  nothing reads (a recompute that stops early) is never reduced.
- *Reductions over a split dim.* A log-sum-exp or softmax (its max and its sum),
  a softmax's gradient (its sum) or an argmax over a split dim all-reduces its
  reduced result: the loss's max and sum-exp over the vocab-sharded logits, a
  softmax over a model-split cache's sequence in decode (whose output the
  partial-sum rule then reduces).
- *Gradient reduction.* Each parameter's gradient is all-reduced over the data axes
  at its model-axis shard size, once per backward pass, where the batch is split
  over them (the reference's HLO shows no reduce-scatter); a gradient that is a
  partial sum over the model axis (a norm's scale under sequence parallelism) is
  all-reduced over it there too.
- *Layout constraints.* ``distributed.ctx.shard`` (called where the JAX package's
  models call it) pins an activation's model-axis layout, in the forward and, for
  its gradient, in the backward: a split dim the constraint does not keep is
  all-gathered (attention's K and V, replicated over the model axis in every
  attention; with ``shard_attn_heads`` off, q and the output too; the MoE
  dispatch's output, split over the tokens, at the block's end), a partial sum is
  all-reduced. A view that splits a model-split dim into an outer part that
  neither divides nor is divided by the model axis all-gathers it (whisper's 12
  heads over 16 shards).
- *Conflicts.* Where a product's operands are split on dims it cannot combine
  (the sequence-split residual against a column-parallel weight), the activation is
  all-gathered; where an elementwise op's operands are split on different dims,
  every one but the first is.
- *Once a value.* A value is reduced or gathered once, whatever reads it after
  (XLA's common subexpressions): the sequence-split residual that ``wq``, ``wk``
  and ``wv`` all read is gathered once; a weight, though, once per read.

**Element width.** Every collective in the JAX package's compiled HLO is f32, the
bf16 models' weights and activations included (XLA's CPU compiler, where its dry
run compiles, carries bf16 arithmetic and its collectives in f32), so every rule
counts 4 bytes an element of a floating tensor; an integer tensor counts its own.

A kernel-library op (:func:`~.cost.kernel_unit`) is one unit here too: the partial
sums it reads are reduced, what runs inside is not followed, and its outputs start
replicated, so the count is the same whether the unit runs its kernel, its plain
version or nothing (``meta``). A collective of ``distributed/collectives.py`` lays its
result out itself: the result starts untracked.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils.weak import WeakIdKeyDictionary

from .roofline import COLLECTIVES

_aten = torch.ops.aten

#: a split part of a tensor: (dim, inner factor f, size n), the dim's index being
#: (outer · n + part) · f + inner; a whole dim is (dim, 1, its size)
Part = Tuple[int, int, int]

#: matrix products: the operand dims' roles are (batch,) M, K × (batch,) K, N
_PRODUCTS = {_aten.mm.default: (0, 1), _aten.bmm.default: (0, 1),
             _aten.addmm.default: (1, 2), _aten.baddbmm.default: (1, 2)}
#: the split roles a product's two operands can have together, with no collective
_FITS = frozenset({(None, None), ("k", "k"), ("k", None), (None, "k"), ("batch", "batch"),
                   ("batch", None), (None, "batch"), ("free", None), (None, "free")})
#: casts and copies: each output has the layout of the first input, dim for dim
_CASTS = frozenset({_aten._to_copy.default, _aten.clone.default})
#: sums: a sum over a split dim leaves a partial sum
_SUMS = frozenset({_aten.sum.dim_IntList, _aten.sum.default, _aten.mean.default})
#: reductions that all-reduce their reduced result where they reduce a split dim:
#: op → (number of all-reduces, keeps the input's shape)
_REDUCES = {_aten.argmax.default: (1, False), _aten.logsumexp.default: (2, False),
            _aten._softmax.default: (2, True), _aten._softmax_backward_data.default: (1, True)}
#: the dim argument's position in each reduction's schema, where it is not 1
_DIM_ARG = {_aten._softmax_backward_data.default: 2}

#: additions: partial scalars added together stay one partial sum
_ADDS = frozenset({_aten.add.Tensor, _aten.sub.Tensor})
#: allocations shaped after an input: they take its split dim and read nothing
_LIKE = frozenset({_aten.zeros_like.default, _aten.ones_like.default, _aten.full_like.default,
                   _aten.new_zeros.default})

_REPL = (None, False)


def _width(t: torch.Tensor) -> int:
    return 4 if t.is_floating_point() else t.element_size()


def _entries(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _view_part(stride: int, size: int, view: torch.Tensor) -> Tuple[Optional[Part], bool]:
    """Where a view (sharing storage with its source) holds the split part of
    ``size`` elements at element ``stride``, matched by strides: (its part of the
    view, whether the view cuts the part into pieces, this being the outer one);
    (None, False) where the view drops it."""
    inner = outer = within = None
    for j, (n, s) in enumerate(zip(view.shape, view.stride())):
        if n == 1 or s == 0:
            continue
        if s == stride:
            if n >= size:
                return (j, 1, size), False
            inner = (j, 1, n)
        elif stride < s < stride * size and s % stride == 0:
            if outer is None or s > view.stride(outer[0]):
                outer = (j, 1, min(n, size * stride // s))
        elif s < stride and stride % s == 0 and stride < s * n:
            f = stride // s
            within = (j, f, min(size, n // f))
    if within is not None:
        return within, False
    if outer is not None:
        return outer, True
    return inner, False


@dataclass
class Layout:
    """The layout a sharded step starts from: the mesh and its axes, the parameters
    (a ``Model`` or {name: tensor}) with their specs (``param_pspecs``), the spec of
    the batch (``batch_pspecs``' tree, or one spec; its leading entry shards the
    batch dim over the data axes) and, for decode, the cache and its specs
    (``cache_pspecs``)."""

    mesh: Any
    axes: Any
    params: Any
    param_specs: Dict[str, Any]
    batch_specs: Any
    cache: Any = None
    cache_specs: Any = None


@dataclass
class _Base:
    """A parameter or cache entry: its model-split dim as laid out, the bytes an
    FSDP all-gather of it returns (0: not split over the data axes) and the bytes
    of its gradient's reduction."""

    tensor: torch.Tensor
    dim: Optional[int]
    gather_bytes: int
    grad_bytes: int

    def part_of(self, view: torch.Tensor) -> Optional[Part]:
        if self.dim is None:
            return None
        t = self.tensor
        if view is t:
            return (self.dim, 1, t.shape[self.dim])
        return _view_part(t.stride(self.dim), t.shape[self.dim], view)[0]


class Partitioner:
    """Follows a :class:`Layout` through an eager step and counts the collectives a
    partitioner adds (module docstring). Entered through ``CostCounter(layout=...)``,
    which calls :meth:`op` after every aten op outside a kernel unit."""

    def __init__(self, layout: Layout):
        mesh, axes = layout.mesh, layout.axes
        self.axes = axes
        self.model = axes.model
        self.tp = int(mesh.shape[axes.model])
        data = set(axes.data)
        self.dp = self._batch_shard(mesh, layout.batch_specs)
        self.bytes = {k: 0 for k in COLLECTIVES}
        self.count = {k: 0 for k in COLLECTIVES}
        self._state = WeakIdKeyDictionary()     # tensor → (split part, partial)
        self._cast_of = WeakIdKeyDictionary()   # cast of a parameter → its _Base
        self._bases: Dict[StorageWeakRef, _Base] = {}
        self._hooked: Dict[int, Any] = {}
        self._done: Dict[Tuple, StorageWeakRef] = {}
        params = layout.params
        named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params
        for name, t in named.items():
            spec = tuple(layout.param_specs[name])
            dim = self._model_dim(spec)
            shard = t.numel() * 4 // (self.tp if dim is not None else 1)
            fsdp = any(a in data for e in spec for a in _entries(e))
            self._add(t, _Base(t, dim, shard if fsdp else 0, shard if self.dp > 1 else 0))
        if layout.cache is not None:
            self._add_cache(layout.cache, layout.cache_specs)

    # -- set-up -----------------------------------------------------------------

    @staticmethod
    def _batch_shard(mesh, specs) -> int:
        spec = specs
        while isinstance(spec, dict):
            spec = spec["tokens"] if "tokens" in spec else next(iter(spec.values()))
        if not spec:
            return 1
        return math.prod(int(mesh.shape[a]) for a in _entries(spec[0]))

    def _model_dim(self, spec) -> Optional[int]:
        for i, e in enumerate(spec):
            if self.model in _entries(e):
                return i
        return None

    def _add(self, t: torch.Tensor, base: _Base) -> None:
        self._bases[StorageWeakRef(t.untyped_storage())] = base

    def _add_cache(self, cache, specs) -> None:
        if isinstance(cache, torch.Tensor):
            self._add(cache, _Base(cache, self._model_dim(tuple(specs)), 0, 0))
        elif isinstance(cache, dict):
            for k, v in cache.items():
                self._add_cache(v, specs[k])
        elif isinstance(cache, (list, tuple)):
            for v, s in zip(cache, specs):
                self._add_cache(v, s)

    # -- state ------------------------------------------------------------------

    def _base(self, t: torch.Tensor) -> Optional[_Base]:
        return self._bases.get(StorageWeakRef(t.untyped_storage()))

    def _of(self, t: torch.Tensor) -> Tuple[Optional[Part], bool]:
        st = self._state.get(t)
        if st is not None:
            return st
        base = self._base(t)
        if base is not None:
            return base.part_of(t), False
        return _REPL

    def _param(self, t: torch.Tensor) -> Optional[_Base]:
        base = self._cast_of.get(t)
        if base is None:
            base = self._base(t)
        return base if base is not None and base.gather_bytes else None

    def _set(self, t: torch.Tensor, part: Optional[Part], partial: bool = False) -> None:
        self._state[t] = (part, partial)

    def forget(self, t: torch.Tensor) -> None:
        """``t`` is laid out by the program itself (a collective's result)."""
        self._state.pop(t, None)

    # -- counting ---------------------------------------------------------------

    def _add_bytes(self, kind: str, nbytes: int) -> None:
        self.bytes[kind] += nbytes
        self.count[kind] += 1

    def _activation(self, kind: str, t: torch.Tensor, numel: Optional[int] = None) -> None:
        """A collective of ``t`` (or of ``numel`` elements of its kind): per device,
        over the data-axis shard of a leading batch dim."""
        n = (t.numel() if numel is None else numel) * _width(t)
        dp = self.dp if t.dim() and t.shape[0] % self.dp == 0 else 1
        self._add_bytes(kind, -(-n // dp))

    def _first(self, kind: str, t: torch.Tensor) -> bool:
        """Whether no ``kind`` collective of ``t``'s data has been counted yet: a
        partitioner reduces or gathers a value once, whatever reads it after (XLA's
        common subexpressions), so views of one value share one collective."""
        ref = StorageWeakRef(t.untyped_storage())
        key = (kind, ref.cdata, t.storage_offset(), t.numel())
        seen = self._done.get(key)
        if seen is not None and not seen.expired():
            return False
        self._done[key] = ref
        return True

    def _reduce(self, t: torch.Tensor) -> Optional[Part]:
        """All-reduce ``t`` if it is a partial sum; → its split part."""
        part, partial = self._of(t)
        if partial:
            if self._first("all-reduce", t):
                self._activation("all-reduce", t)
            self._set(t, part)
        return part

    def _gather(self, t: torch.Tensor) -> None:
        if self._first("all-gather", t):
            self._activation("all-gather", t)

    def reduce_inputs(self, tensors) -> None:
        """A kernel unit reads ``tensors``: the partial sums among them are reduced."""
        for t in tensors:
            if isinstance(t, torch.Tensor):
                self._reduce(t)

    def _hook(self, t: torch.Tensor) -> None:
        """Count ``t``'s gradient reduction each time autograd computes its
        gradient, if ``t`` is a parameter of the layout that records one."""
        if id(t) in self._hooked or not (t.requires_grad and t.is_leaf):
            return
        base = self._base(t)
        if base is None or base.tensor is not t:
            return

        def hook(grad, nbytes=base.grad_bytes):
            self._reduce(grad)                  # a partial sum over the model axis too
            if nbytes:
                self._add_bytes("all-reduce", nbytes)

        self._hooked[id(t)] = t.register_hook(hook)

    def close(self) -> None:
        for handle in self._hooked.values():
            handle.remove()
        self._hooked.clear()

    def totals(self) -> Dict[str, int]:
        return {**{f"{k}_bytes": v for k, v in self.bytes.items()},
                **{f"{k}_count": v for k, v in self.count.items()},
                "total_bytes": sum(self.bytes.values())}

    # -- layout constraints --------------------------------------------------------

    def constrain(self, x: torch.Tensor, logical) -> torch.Tensor:
        """``x`` under the layout constraint ``logical`` (``ctx.shard``'s logical
        axes), on its gradient too where autograd records one."""
        target = next((i for i, name in enumerate(logical) if name is not None
                       and self.model in _entries(self.axes.resolve(name))), None)
        if torch.is_grad_enabled() and x.requires_grad:
            return _Constrain.apply(x, self, target)
        y = x.view_as(x)
        self.meet(x, y, target)
        return y

    def meet(self, src: torch.Tensor, dst: torch.Tensor, target: Optional[int]) -> None:
        """``dst`` (a view of ``src``) is constrained to have dim ``target`` split
        over the model axis (None: replicated). A source split on another dim is
        all-gathered first; so is a split source where the target dim does not
        divide over the model axis (the constraint pads it, an even split cannot
        hold that layout)."""
        part = self._reduce(src)
        if part is not None and (target is None or part[0] != target
                                 or src.shape[target] % self.tp):
            self._gather(src)
        self._set(dst, None if target is None else (target, 1, dst.shape[target]))

    # -- ops ----------------------------------------------------------------------

    def op(self, func, args, kwargs, out) -> None:
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        for a in args:
            if isinstance(a, (list, tuple)):
                ins.extend(x for x in a if isinstance(x, torch.Tensor))
        ins.extend(v for v in kwargs.values() if isinstance(v, torch.Tensor))
        if not ins:
            return
        for t in ins:
            if t.requires_grad and t.is_leaf:
                self._hook(t)
        outs = [o for o in (out if isinstance(out, (list, tuple)) else (out,))
                if isinstance(o, torch.Tensor)]
        if not outs:
            return
        if outs[0] is ins[0]:                       # in place: keeps its layout
            for t in ins[1:]:
                self._reduce(t)
            return
        src = ins[0]
        src_store = StorageWeakRef(src.untyped_storage())
        if all(StorageWeakRef(o.untyped_storage()) == src_store for o in outs):
            self._view(src, outs)
        elif func in _CASTS:
            part, partial = self._of(src)
            self._set(outs[0], part, partial)
            base = self._param(src)
            if base is not None:
                self._cast_of[outs[0]] = base
        elif func in _PRODUCTS:
            self._product(func, args, outs[0])
        elif func in _SUMS or func in _REDUCES:
            self._reduction(func, args, src, outs)
        elif func in (_aten.index.Tensor, _aten.gather.default, _aten.index_select.default,
                      _aten.embedding.default):
            self._index(func, args, outs[0])
        elif func in (_aten.cat.default, _aten.stack.default):
            self._cat(func, args, outs[0])
        elif func in _LIKE:
            part = self._of(src)[0]
            if part is not None and outs[0].shape == src.shape:
                self._set(outs[0], part)
        elif torch.Tag.pointwise in func.tags:
            self._pointwise(func, ins, outs[0])
        else:
            self._default(func, args, ins, outs)

    def _view(self, src: torch.Tensor, outs) -> None:
        part, partial = self._of(src)
        for o in outs:
            if part is None:
                if partial:
                    self._set(o, None, True)
                continue
            d, f, n = part
            got, cut = _view_part(src.stride(d) * f, n, o)
            if cut and got[2] % self.tp and self.tp % got[2]:
                self._reduce(src)
                self._gather(src)
                self._set(o, None)
            else:
                self._set(o, got, partial)

    def _product(self, func, args, out: torch.Tensor) -> None:
        first = _PRODUCTS[func][0]
        a, b = args[first], args[first + 1]
        for t in (a, b):
            base = self._param(t)
            if base is not None:
                self._add_bytes("all-gather", base.gather_bytes)
        nd = a.dim()
        roles_a = ("batch", "free", "k") if nd == 3 else ("free", "k")
        roles_b = ("batch", "k", "free") if nd == 3 else ("k", "free")
        pa, pb = self._reduce(a), self._reduce(b)
        ra = None if pa is None else roles_a[pa[0]]
        rb = None if pb is None else roles_b[pb[0]]
        if (ra, rb) not in _FITS:
            # split on dims the product cannot combine: gather an activation (the
            # operand that is no parameter; of two, the smaller)
            cands = [t for t in (a, b) if self._base(t) is None and t not in self._cast_of]
            t = min(cands or [a, b], key=lambda x: x.numel())
            self._gather(t)
            if t is a:
                ra = None
            else:
                rb = None
        if "k" in (ra, rb):
            self._set(out, None, True)
        elif ra == "batch":
            self._set(out, pa)
        elif rb == "batch":
            self._set(out, pb)
        elif ra == "free":
            self._set(out, (out.dim() - 2,) + pa[1:])
        elif rb == "free":
            self._set(out, (out.dim() - 1,) + pb[1:])

    def _reduction(self, func, args, src: torch.Tensor, outs) -> None:
        part = self._reduce(src)
        if part is None:
            return
        dim = part[0]
        nd = src.dim()
        pos = _DIM_ARG.get(func, 1)
        raw = args[pos] if len(args) > pos else None
        if func in (_aten.sum.default, _aten.mean.default) or raw is None:
            dims = set(range(nd))
        elif isinstance(raw, int):
            dims = {raw % nd}
        else:
            dims = {d % nd for d in raw} if len(raw) else set(range(nd))
        if dim in dims:
            if func in _SUMS:
                self._set(outs[0], None, True)
                return
            n, same = _REDUCES[func]
            reduced = src.numel() // math.prod(src.shape[d] for d in dims)
            for _ in range(n):
                self._activation("all-reduce", outs[0], reduced)
            if same:
                self._set(outs[0], part)
            return
        keep = outs[0].dim() == nd
        out_dim = dim if keep else dim - sum(1 for d in dims if d < dim)
        for o in outs:
            self._set(o, (out_dim,) + part[1:])

    def _index(self, func, args, out: torch.Tensor) -> None:
        if func is _aten.embedding.default:
            part = self._reduce(args[0])
            if part is not None and part[0] == 0:
                self._set(out, None, True)
            elif part is not None:
                self._set(out, (out.dim() - 1,) + part[1:])
            return
        src = args[0]
        part = self._reduce(src)
        if part is None:
            return
        dim, rest_part = part[0], part[1:]
        if func is _aten.index.Tensor:
            used = [i for i, t in enumerate(args[1]) if t is not None]
            if dim in used:
                self._set(out, None, True)
                return
            rest = [i for i in range(src.dim()) if i not in used]
            lead = out.dim() - len(rest)
            if used == list(range(used[0], used[-1] + 1)):
                before = [i for i in rest if i < used[0]]
                after = [i for i in rest if i > used[-1]]
                at = before.index(dim) if dim in before else (
                    len(before) + lead + after.index(dim))
            else:
                at = lead + rest.index(dim)
            self._set(out, (at,) + rest_part)
            return
        if args[1] % src.dim() == dim:
            self._set(out, None, True)
        else:
            self._set(out, part)

    def _cat(self, func, args, out: torch.Tensor) -> None:
        at = (args[1] if len(args) > 1 else 0) % out.dim()
        split = []
        for t in args[0]:
            part = self._reduce(t)
            if part is not None:
                if func is _aten.stack.default and part[0] >= at:
                    part = (part[0] + 1,) + part[1:]
                split.append((t, part))
        if not split:
            return
        first = split[0][1]
        for t, part in split[1:]:
            if part[0] != first[0]:
                self._gather(t)
        self._set(out, first)

    def _pointwise(self, func, ins, out: torch.Tensor) -> None:
        if func in _ADDS and out.numel() == 1 and any(self._of(t)[1] for t in ins):
            self._set(out, None, True)          # a sum with a partial scalar stays one
            return
        first = None
        for t in ins:
            part = self._reduce(t)
            if part is None:
                continue
            od = part[0] + out.dim() - t.dim()
            if od < 0 or t.shape[part[0]] != out.shape[od]:
                continue
            if first is None:
                first = (od,) + part[1:]
            elif od != first[0]:
                self._gather(t)
        if first is not None:
            self._set(out, first)

    def _default(self, func, args, ins, outs) -> None:
        """Any other op: its outputs keep the split part of an input whose dim they
        keep (same rank and size there; ``select_backward`` puts its dim back)."""
        parts = [(t, self._reduce(t)) for t in ins]
        unselect = func is _aten.select_backward.default
        for o in outs:
            for t, part in parts:
                if part is None:
                    continue
                d = part[0]
                if unselect:                    # (grad, input_sizes, dim, index)
                    d += d >= args[2] % o.dim()
                if o.dim() == t.dim() + unselect and o.shape[d] == t.shape[part[0]]:
                    self._set(o, (d,) + part[1:])
                    break


class _Constrain(torch.autograd.Function):
    """A layout constraint on a value and on its gradient (the JAX package's
    ``with_sharding_constraint``, which the backward pass meets too)."""

    @staticmethod
    def forward(ctx, x, partitioner, target):
        ctx.partitioner, ctx.target = partitioner, target
        y = x.view_as(x)
        partitioner.meet(x, y, target)
        return y

    @staticmethod
    def backward(ctx, g):
        g2 = g.view_as(g)
        ctx.partitioner.meet(g, g2, ctx.target)
        return g2, None, None
