"""Wrapper of the ``hash_partition_pack`` CUDA kernel (csrc/hash_partition.cu).

The kernel replaces the TPU kernel ``hash_partition_pack_pallas``
(src/repro/kernels/hash_partition.py): hash + partition id + stable
in-partition slot + send counts for every segment of a batch in one call.
"""

from __future__ import annotations

import torch

from . import _build

TILE = 1024
WARPS = TILE // 32
SMEM_LIMIT = 48 * 1024          # default dynamic shared memory per block

#: calls since the last reset that launched the kernel (CUDA tensors with
#: at least one segment; with N = 0 only the scan pass runs)
launches = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"hash_partition_pack: {msg}")


def hash_partition_pack_cuda(keys: torch.Tensor, counts: torch.Tensor, n_parts: int):
    """keys (S, N) int32, counts (S,) int32, both contiguous on one CUDA
    device → (part (S, N), slot (S, N), send_counts (S, n_parts)) int32."""
    global launches
    _require(keys.is_cuda and counts.device == keys.device, "tensors must share one CUDA device")
    _require(keys.dtype == torch.int32 and counts.dtype == torch.int32, "tensors must be int32")
    _require(keys.dim() == 2 and counts.shape == (keys.shape[0],), "want keys (S, N), counts (S,)")
    _require(keys.is_contiguous() and counts.is_contiguous(), "tensors must be contiguous")
    _require(n_parts >= 1, "n_parts must be >= 1")
    smem = WARPS * (n_parts + 1) * 4
    _require(smem <= SMEM_LIMIT, f"{n_parts + 1} bins x {WARPS} warps exceed shared memory")
    s, n = keys.shape
    _require(s * n < 2**31, "batch too large for int32 indexing")
    part = torch.empty_like(keys)
    slot = torch.empty_like(keys)
    send = torch.empty((s, n_parts), dtype=torch.int32, device=keys.device)
    if s == 0:                      # nothing to compute: no launch, no count
        return part, slot, send
    n_tiles = -(-n // TILE)
    scratch = torch.empty((max(1, s * n_tiles * (n_parts + 1)),), dtype=torch.int32,
                          device=keys.device)
    fn = _build.launcher("hash_partition_pack_launch")
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = fn(keys.data_ptr(), counts.data_ptr(), s, n, n_parts, part.data_ptr(),
            slot.data_ptr(), send.data_ptr(), scratch.data_ptr(), stream)
    _build.check("hash_partition_pack", rc)
    launches += 1
    return part, slot, send
