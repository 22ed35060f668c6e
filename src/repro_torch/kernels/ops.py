"""Public kernel entry points, batched over a leading segment axis.

Dispatch is by the tensors' device alone: a CPU tensor runs the plain
PyTorch version (``ref.py``), a CUDA tensor launches the hand-written kernel
— or raises; there is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from . import hash_partition as _hp
from . import merge_join as _mj
from . import ref as _ref


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA ones; raises on anything else."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernels take CPU or CUDA tensors on one device type, got {kinds}")


def merge_join_counts(a_keys: torch.Tensor, b_keys: torch.Tensor):
    """a_keys (S, N), b_keys (S, M) int32, rows sorted ascending (INT32_MAX
    sentinels sort last) → (lower, upper) (S, N) int32 match ranges."""
    if _on_cpu(a_keys, b_keys):
        return _ref.merge_join_counts_ref(a_keys, b_keys)
    return _mj.merge_join_counts_cuda(a_keys.contiguous(), b_keys.contiguous())


def merge_join_pairs(lower: torch.Tensor, starts: torch.Tensor, cap_out: int):
    """Expand per-key match ranges into (a_idx, b_idx) (S, cap_out) int32:
    slot t maps to key a_idx[t] = max{i : starts[i] <= t} (clipped to
    [0, N-1]) and b_idx[t] = lower[a_idx] + t - starts[a_idx] (unclipped);
    slots at or past the true total alias the last key."""
    s, n = starts.shape
    if n == 0:
        z = torch.zeros((s, cap_out), dtype=torch.int32, device=starts.device)
        return z, z.clone()
    if _on_cpu(lower, starts):
        return _ref.merge_join_pairs_ref(lower, starts, cap_out)
    return _mj.merge_join_pairs_cuda(
        lower.to(torch.int32).contiguous(), starts.to(torch.int32).contiguous(), cap_out
    )


def hash_partition_pack(keys: torch.Tensor, counts: torch.Tensor, n_parts: int):
    """Fused exchange send side, per segment: → (part (S, N) int32 with
    n_parts marking rows at or past the count, slot (S, N) stable
    in-partition rank, send_counts (S, n_parts))."""
    if _on_cpu(keys, counts):
        return _ref.hash_partition_pack_ref(keys, counts, n_parts)
    return _hp.hash_partition_pack_cuda(
        keys.contiguous(), counts.to(torch.int32).contiguous(), n_parts
    )
