"""Checkpoint/restart.

Format: one .npz per checkpoint step (leaves keyed by their path in the state:
dict keys joined by ``/``, a model's parameters by their names) + a manifest JSON
(step, arch, wall time). Writes are atomic (tmp + rename) and a ``latest`` marker
is updated last, so a crash mid-write can never corrupt the resume point — the
launcher's auto-resume picks the newest complete step.

Leaves are saved as host arrays (copied off the card; bf16 upcast to float32,
which is exact) and restored onto the template's device and dtype. An async writer
thread overlaps serialization with training.

A state is a nested dict whose leaves are tensors or models (``nn.Module``: its
named parameters): ``{"params": model, "opt": {"adamw": {...}, "ef": {...}}}``.
"""

from __future__ import annotations

import copy
import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, in the tree's order."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield f"{prefix}{name}", p
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, torch.Tensor):
        yield prefix.rstrip("/"), tree
    else:
        raise TypeError(f"checkpoint leaf {prefix!r} is a {type(tree).__name__}, not a tensor")


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in named_leaves(tree):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:      # npz has no bf16: upcast, lossless
            t = t.float()
        flat[key] = t.cpu().numpy()
    return flat


def _unflatten(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    """A new state shaped like ``template`` (models copied, tensors new) holding
    ``flat``'s values, each on its template leaf's device and in its dtype."""
    def value(key: str, leaf: torch.Tensor) -> torch.Tensor:
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs {tuple(leaf.shape)}")
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)

    if isinstance(template, nn.Module):
        model = copy.deepcopy(template)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(value(f"{prefix}{name}", p))
        return model
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    return value(prefix.rstrip("/"), template)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save -----------------------------------------------------------------

    def _paths(self, step: int) -> Tuple[Path, Path]:
        return self.dir / f"ckpt_{step:08d}.npz", self.dir / f"ckpt_{step:08d}.json"

    def _write(self, step: int, flat: Dict[str, np.ndarray], meta: Optional[dict]) -> None:
        npz, man = self._paths(step)
        tmp = npz.with_suffix(".npz.tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        tmp.rename(npz)
        manifest = {"step": step, "time": time.time(), **(meta or {})}
        tmp2 = man.with_suffix(".json.tmp")
        tmp2.write_text(json.dumps(manifest, indent=2))
        tmp2.rename(man)
        (self.dir / "latest.tmp").write_text(str(step))
        (self.dir / "latest.tmp").rename(self.dir / "latest")
        self._gc()

    def save(self, step: int, state: Dict[str, Any], meta: Optional[dict] = None) -> None:
        self._write(step, _flatten(state), meta)

    def save_async(self, step: int, state: Dict[str, Any], meta: Optional[dict] = None) -> None:
        """Snapshot to host memory synchronously (the copy off the card happens
        here, before training resumes), write on a thread."""
        self.wait()
        flat = _flatten(state)
        self._thread = threading.Thread(target=self._write, args=(step, flat, meta), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            npz, man = self._paths(s)
            npz.unlink(missing_ok=True)
            man.unlink(missing_ok=True)

    # -- restore ----------------------------------------------------------------

    def all_steps(self):
        return [int(p.stem.split("_")[1]) for p in self.dir.glob("ckpt_*.npz")]

    def latest_step(self) -> Optional[int]:
        marker = self.dir / "latest"
        if marker.exists():
            s = int(marker.read_text().strip())
            if self._paths(s)[0].exists():
                return s
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, step: int, template):
        """A new state shaped like ``template`` (its models deep-copied, its
        tensors new) with the checkpoint's values, on the template's devices and
        in its dtypes → (state, manifest)."""
        npz, man = self._paths(step)
        with np.load(npz) as data:
            flat = {k: data[k] for k in data.files}
        state = _unflatten(template, flat)
        meta = json.loads(man.read_text()) if man.exists() else {"step": step}
        return state, meta
