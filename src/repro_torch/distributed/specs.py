"""PartitionSpec rules for parameters, optimizer state, batches, and caches, and the
layout of a tensor on a virtual mesh.

Rules are keyed on the leaf name (the last path segment), applied to the *trailing*
dims:

  "tp"   → the model axis        (Megatron column/row sharding, EP on expert dim)
  "fsdp" → the DP axes           (parameter + optimizer-state sharding; ZeRO)
  None   → replicated

FSDP notes: big archs cannot hold bf16 params replicated over DP (mistral-large:
123B × 2B / 16 TP-shards ≈ 15.4 GB/device), so weight matrices are 2-D sharded
(fsdp × tp). The fp32 master/m/v in the optimizer state inherit the same specs,
giving ZeRO semantics for free. Divisibility is checked per-leaf: a rule falls back
to None on any non-divisible dim (e.g. whisper's 12 heads vs 16-way model axis).

The JAX package scans the repeated layers, so its per-layer leaves are stacked
with a leading repeats dim (never sharded); the port keeps one module per layer
(``models/convert.py``), and a layer's spec is the one the rules give the stacked
leaf, minus that leading ``None``. The rules see the stacked shape: a repeated
MoE layer's shared-expert matrix (R, d, f) meets the 3-D expert-stack rule there,
as in the JAX package, and so is split over the DP axes on d and not over the
model axis.

:func:`place` lays a full tensor out on a virtual mesh by a spec — one block per
device, stacked along leading mesh dims — and :func:`gather` puts it back (the
twins of ``jax.device_put`` with a ``NamedSharding`` and of reading the array
back).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from .ctx import Mesh, MeshAxes


class P(tuple):
    """A partition spec: one entry per tensor dim — None (replicated), a mesh axis
    name, or a tuple of names (split over their product, the first the major).
    Equal to any tuple of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


# leaf name → logical spec for the trailing dims
_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embedding: vocab over tp (vocab-parallel logits/CE)
    "embedding": ("tp", None),
    # attention
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    # MLA
    "w_dkv": ("fsdp", None),
    "w_uk": (None, "tp"),
    "w_uv": (None, "tp"),
    # dense MLP
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_out": ("tp", "fsdp"),
    # MoE (3-D expert stacks: E over tp = expert parallelism)
    "router": (None, None),
    # mamba
    "w_z": ("fsdp", "tp"),
    "w_x": ("fsdp", "tp"),
    "w_B": ("fsdp", None),
    "w_C": ("fsdp", None),
    "w_dt": ("fsdp", None),
    "conv_x": (None, "tp"),
    "conv_B": (None, None),
    "conv_C": (None, None),
    "norm_scale": (None,),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    "scale": (None,),
    "bias": (None,),
}

# MoE expert stacks are 3-D; keyed by (name, ndim-without-stack)
_MOE_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "w_gate": ("tp", "fsdp", None),
    "w_up": ("tp", "fsdp", None),
    "w_out": ("tp", None, "fsdp"),
}


def _resolve(axes: MeshAxes, logical: Optional[str], fsdp: bool):
    if logical == "tp":
        return axes.model
    if logical == "fsdp":
        if not fsdp:
            return None
        return axes.data if len(axes.data) > 1 else axes.data[0]
    return None


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return math.prod(mesh.shape[a] for a in entry)
    return int(mesh.shape[entry])


def _fit(mesh, shape: Tuple[int, ...], spec: Tuple, stack_dims: int) -> P:
    """Prefix Nones for stacked dims; drop any axis that doesn't divide."""
    full = (None,) * stack_dims + tuple(spec)
    out = []
    for dim, entry in zip(shape, full):
        if entry is not None and dim % _axis_size(mesh, entry) == 0:
            out.append(entry)
        else:
            out.append(None)
    return P(*out)


def _stack_repeats(cfg, parts: List[str]) -> int:
    """The JAX package's repeats dim in front of this parameter: the pattern's
    layers are stacked n_repeats deep, the encoder's n_enc_layers; 0 otherwise."""
    if parts[0] == "layers" and int(parts[1]) >= len(cfg.prefix):
        return cfg.n_repeats
    if parts[:2] == ["encoder", "layers"]:
        return cfg.n_enc_layers
    return 0


def _unstack(spec: P, repeats: int, name: str) -> P:
    if not repeats:
        return spec
    if spec[0] is not None:
        raise ValueError(f"{name}: the rules split the repeats dim ({spec}); a per-layer "
                         "parameter cannot hold that layout")
    return P(*spec[1:])


def param_pspecs(params, mesh, axes: MeshAxes, fsdp: bool = True) -> Dict[str, P]:
    """{parameter name: spec} over ``params`` (a ``Model``, on any device,
    ``meta`` included)."""
    cfg = params.cfg
    out: Dict[str, P] = {}
    for name, leaf in params.named_parameters():
        parts = name.split(".")
        leaf_name = parts[-1]
        repeats = _stack_repeats(cfg, parts)
        shape = ((repeats,) if repeats else ()) + tuple(leaf.shape)
        rules = None
        if "moe" in parts and leaf_name in _MOE_RULES and len(shape) >= 3:
            rules = _MOE_RULES[leaf_name]
        elif leaf_name in _PARAM_RULES:
            rules = _PARAM_RULES[leaf_name]
        if rules is None:
            out[name] = P(*([None] * leaf.dim()))
            continue
        stack = len(shape) - len(rules)
        if stack < 0:
            raise ValueError(f"{name}: shape {shape} has fewer dims than its rule {rules}")
        resolved = tuple(_resolve(axes, r, fsdp) for r in rules)
        out[name] = _unstack(_fit(mesh, shape, resolved, stack), repeats, name)
    return out


def opt_state_pspecs(param_specs, opt_state, mesh, axes: MeshAxes):
    """master/m/v inherit param specs (ZeRO via fsdp); step is replicated; the error-
    feedback buffer (if present) also inherits."""
    out: Dict[str, Any] = {}
    if "adamw" in opt_state:
        out["adamw"] = {"master": param_specs, "m": param_specs, "v": param_specs,
                        "step": P()}
        if "ef" in opt_state:
            out["ef"] = param_specs
        return out
    raise ValueError("unexpected opt state layout")


def batch_pspecs(batch, mesh, axes: MeshAxes):
    """Shard the batch dim over DP when divisible (long_500k batch=1 stays
    replicated — the DP axes idle, inherent to the shape)."""
    dp = axes.data if len(axes.data) > 1 else axes.data[0]
    dp_size = _axis_size(mesh, dp)

    def one(leaf):
        if leaf.dim() == 0:
            return P()
        if leaf.shape[0] % dp_size == 0:
            return P(dp, *([None] * (leaf.dim() - 1)))
        return P(*([None] * leaf.dim()))

    return {k: one(v) for k, v in batch.items()}


def cache_pspecs(cache, mesh, axes: MeshAxes, cfg):
    """Decode caches: batch over DP (when divisible), long sequence dims over the
    model axis (split-KV flash decoding), SSM heads over the model axis.

    Layout of one layer's entry (``models/model.py``):
      attn  k/v       (B, S, KV, hd)   → S over tp
      mla   c/kr      (B, S, r)        → S over tp
      mamba state     (B, H, P, N)     → H over tp
      mamba conv_*    (B, k-1, CH)     → CH over tp (x stream only, via fit)
      enc_out         (B, F, d)        → batch over dp
    ``pos`` (a host int) is replicated."""
    dp = axes.data if len(axes.data) > 1 else axes.data[0]
    dp_size = _axis_size(mesh, dp)
    tp = axes.model
    tp_size = _axis_size(mesh, tp)

    def one(name: str, leaf) -> P:
        shape = leaf.shape
        if leaf.dim() == 0:
            return P()
        spec: List[Any] = [None] * leaf.dim()
        if shape[0] % dp_size == 0:
            spec[0] = dp
        if name in ("k", "v", "c", "kr"):
            if shape[1] % tp_size == 0 and shape[1] >= tp_size * 128:
                spec[1] = tp
        elif name == "state":
            if shape[1] % tp_size == 0:
                spec[1] = tp
        elif name == "conv_x":
            if shape[-1] % tp_size == 0:
                spec[-1] = tp
        return P(*spec)

    out: Dict[str, Any] = {"pos": P(),
                           "layers": [{k: one(k, v) for k, v in c.items()}
                                      for c in cache["layers"]]}
    if "enc_out" in cache:
        out["enc_out"] = one("enc_out", cache["enc_out"])
    return out


# ---------------------------------------------------------------------------
# a tensor's layout on a virtual mesh
# ---------------------------------------------------------------------------


def _entries(mesh: Mesh, spec, ndim: int) -> List[Tuple[str, ...]]:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    entries = [() if e is None else ((e,) if isinstance(e, str) else tuple(e))
               for e in spec + (None,) * (ndim - len(spec))]
    used = [a for e in entries for a in e]
    if len(set(used)) != len(used):
        raise ValueError(f"spec {spec} uses a mesh axis twice")
    for a in used:
        mesh.dim(a)
    return entries


def shard_shape(shape, mesh: Mesh, spec) -> Tuple[int, ...]:
    """The block of a tensor of ``shape`` that each device of ``mesh`` holds under
    ``spec`` (a dim that does not divide is padded up, as XLA pads it)."""
    entries = _entries(mesh, spec, len(shape))
    return tuple(-(-size // math.prod(mesh.shape[a] for a in axes))
                 for size, axes in zip(shape, entries))


def place(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """A full tensor → its per-device blocks on ``mesh`` by ``spec``: shape
    (*mesh sizes, *block shape), a view of ``x`` wherever ``x`` is contiguous
    (replicated axes are broadcast, not copied)."""
    entries = _entries(mesh, spec, x.dim())
    shape: List[int] = []
    at: Dict[str, int] = {}
    for size, axes in zip(x.shape, entries):
        n = math.prod(mesh.shape[a] for a in axes)
        if size % n:
            raise ValueError(f"dim of size {size} does not divide over {axes} ({n})")
        for a in axes:
            at[a] = len(shape)
            shape.append(mesh.shape[a])
        shape.append(size // n)
    y = x.reshape(shape)
    mesh_dims = [at[a] for a in mesh.axis_names if a in at]
    local = [i for i in range(len(shape)) if i not in mesh_dims]
    y = y.permute(mesh_dims + local)
    for k, a in enumerate(mesh.axis_names):
        if a not in at:
            y = y.unsqueeze(k)
    return y.expand(*mesh.sizes, *y.shape[len(mesh.axis_names):])


def gather(blocks: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """Per-device blocks laid out by ``spec`` → the full tensor, read from the
    first device of every axis the spec does not split."""
    n = len(mesh.axis_names)
    if tuple(blocks.shape[:n]) != mesh.sizes:
        raise ValueError(f"blocks of shape {tuple(blocks.shape)} are not laid out on {mesh!r}")
    entries = _entries(mesh, spec, blocks.dim() - n)
    used = [a for a in mesh.axis_names if any(a in e for e in entries)]
    y = blocks[tuple(slice(None) if a in used else 0 for a in mesh.axis_names)]
    perm: List[int] = []
    full: List[int] = []
    for i, axes in enumerate(entries):
        perm.extend(used.index(a) for a in axes)
        perm.append(len(used) + i)
        full.append(y.shape[len(used) + i] * math.prod(mesh.shape[a] for a in axes))
    return y.permute(perm).reshape(full)
