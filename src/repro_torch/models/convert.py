"""Carry the JAX package's parameters and caches into the port.

The JAX package keeps a tree of arrays: ``prefix`` blocks as a list, the pattern's
blocks stacked over repeats (``blocks["pos{i}"]``, leading dim R), the whisper
encoder's blocks stacked likewise. The port holds one module (and one cache
dict) per layer, in layer order: layer ``len(prefix) + r·P + i`` is repeat ``r``
of pattern position ``i``. The functions take the tree with numpy leaves; bf16
leaves must be upcast to float32 first (``np.asarray(a, np.float32)``), and are
cast back to the model's dtype here, which is exact.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .layers import Init, torch_dtype
from .model import Model


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unstack(stacked: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """A tree whose leaves lead with dim n → n trees."""
    return [_tree_map(lambda a, r=r: a[r], stacked) for r in range(n)]


def layer_trees(cfg, prefix: List[Dict[str, Any]], blocks: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The JAX package's ``prefix`` list and stacked ``blocks`` → one tree per
    layer, in layer order."""
    per_pos = [_unstack(blocks[f"pos{i}"], cfg.n_repeats) for i in range(len(cfg.pattern))]
    return list(prefix) + [per_pos[i][r] for r in range(cfg.n_repeats)
                           for i in range(len(cfg.pattern))]


def _flatten(tree, prefix: str) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _as_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def by_name(cfg, tree: Dict[str, Any]) -> Dict[str, Any]:
    """A tree shaped like the JAX package's parameters (the parameters, their
    gradients, the optimizer's masters or moments; numpy leaves) → {the port's
    parameter name: leaf}, so that port and reference values compare by name."""
    flat = {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "layers": {str(j): t for j, t in
                       enumerate(layer_trees(cfg, tree["prefix"], tree["blocks"]))}}
    if cfg.is_encdec:
        enc = tree["encoder"]
        flat["encoder"] = {
            "layers": {str(r): t for r, t in enumerate(_unstack(enc["blocks"], cfg.n_enc_layers))},
            "final_norm": enc["final_norm"]}
    return dict(_flatten(flat, ""))


def params_from_numpy(cfg, tree: Dict[str, Any], device=None) -> Model:
    """The JAX package's parameter tree (numpy leaves) → the port's model on
    ``device`` (the card unless the caller names another)."""
    dev = resolve_device(device)
    model = Model(cfg, Init(dev))
    named = dict(model.named_parameters())
    given = by_name(cfg, tree)
    if set(given) != set(named):
        raise ValueError(f"parameter trees differ: missing {sorted(set(named) - set(given))}, "
                         f"unexpected {sorted(set(given) - set(named))}")
    with torch.no_grad():
        for name, a in given.items():
            p = named[name]
            if tuple(p.shape) != tuple(np.shape(a)):
                raise ValueError(f"{name}: shape {np.shape(a)}, want {tuple(p.shape)}")
            p.copy_(_as_tensor(a, p.dtype, dev))
    return model


def cache_from_numpy(cfg, tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's cache (numpy leaves: ``pos``, ``prefix``, stacked
    ``blocks``, ``enc_out``) → the port's cache on ``device``, in the model's
    dtype."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    layers = [_tree_map(lambda a: _as_tensor(a, dt, dev), t)
              for t in layer_trees(cfg, tree["prefix"], tree["blocks"])]
    cache: Dict[str, Any] = {"pos": int(tree["pos"]), "layers": layers}
    if cfg.is_encdec:
        cache["enc_out"] = _as_tensor(tree["enc_out"], dt, dev)
    return cache
