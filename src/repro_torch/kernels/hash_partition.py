"""Wrappers of the ``hash_partition_pack`` and ``hash_partition`` CUDA
kernels (csrc/hash_partition.cu).

They replace the TPU kernels ``hash_partition_pack_pallas`` (hash +
partition id + stable in-partition slot + send counts for every segment of a
batch in one call) and ``hash_partition_pallas`` (partition id per key and
the global partition histogram) of src/repro/kernels/hash_partition.py.

``hash_partition_pack`` has two kernels, picked by P alone: up to
``MAX_SMEM_PARTS`` partitions one block ranks a tile in per-warp shared
bins (``hp_pack``); above, the tile histograms live in global memory
(``hp_wide_*``).  Both give the plain version's part, slot and send counts.
"""

from __future__ import annotations

import torch

from . import _build

TILE = 1024
SMEM_LIMIT = 48 * 1024          # default dynamic shared memory per block
PACK_SMEM_MAX = 232448          # a block's shared memory after the opt-in (227 KB)
#: the largest P of hash_partition_pack's single-block kernel: 3 · 8 warps ·
#: (P + 1) int32 bins of shared memory
MAX_SMEM_PARTS = PACK_SMEM_MAX // (4 * 3 * 8) - 1


def _require(cond: bool, msg: str, name: str = "hash_partition_pack") -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def hash_partition_pack_cuda(keys: torch.Tensor, counts: torch.Tensor, n_parts: int):
    """keys (S, N) int32, counts (S,) int32, both contiguous on one CUDA
    device → (part (S, N), slot (S, N), send_counts (S, n_parts)) int32."""
    _require(keys.is_cuda and counts.device == keys.device, "tensors must share one CUDA device")
    _require(keys.dtype == torch.int32 and counts.dtype == torch.int32, "tensors must be int32")
    _require(keys.dim() == 2 and counts.shape == (keys.shape[0],), "want keys (S, N), counts (S,)")
    _require(keys.is_contiguous() and counts.is_contiguous(), "tensors must be contiguous")
    _require(1 <= n_parts < 2**31 - 1, "n_parts must be in [1, 2^31 - 1)")
    s, n = keys.shape
    _require(s * n < 2**31, "batch too large for int32 indexing")
    # part and slot share one allocation
    part, slot = torch.empty((2, s, n), dtype=torch.int32, device=keys.device).unbind(0)
    send = torch.empty((s, n_parts), dtype=torch.int32, device=keys.device)
    if s == 0:                      # nothing to compute: no launch, no count
        return part, slot, send
    n_tiles = max(1, -(-n // TILE))     # N = 0: one empty tile per segment
    status = torch.empty((s * n_tiles * (n_parts + 1),), dtype=torch.int32, device=keys.device)
    wide = n_parts > MAX_SMEM_PARTS
    fn = _build.launcher("hash_partition_pack_wide_launch" if wide
                         else "hash_partition_pack_launch")
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = fn(keys.data_ptr(), counts.data_ptr(), s, n, n_parts, part.data_ptr(),
            slot.data_ptr(), send.data_ptr(), status.data_ptr(), stream)
    _build.launched("hash_partition_pack", rc)    # N = 0 still writes zero send counts
    return part, slot, send


def hash_partition_cuda(keys: torch.Tensor, n_parts: int):
    """keys (N,) int32, contiguous on a CUDA device → (part (N,) int32,
    hist (n_parts,) int32)."""
    name = "hash_partition"
    _require(keys.is_cuda, "keys must be a CUDA tensor", name)
    _require(keys.dtype == torch.int32 and keys.dim() == 1 and keys.is_contiguous(),
             "want contiguous (N,) int32 keys", name)
    _require(n_parts >= 1, "n_parts must be >= 1", name)
    _require((n_parts + 1) * 4 <= SMEM_LIMIT, f"{n_parts + 1} bins exceed shared memory", name)
    n = keys.shape[0]
    _require(n < 2**31, "N must fit int32", name)
    if n == 0:                      # nothing to compute: no launch, no count
        return (torch.empty_like(keys),
                torch.zeros((n_parts,), dtype=torch.int32, device=keys.device))
    # part and hist share one allocation; part starts at the keys' offset
    # modulo 16 bytes, so the kernel's 16-byte loads and stores line up
    phase = keys.data_ptr() // 4 % 4
    buf = torch.empty((phase + n + n_parts,), dtype=torch.int32, device=keys.device)
    part, hist = buf[phase:phase + n], buf[phase + n:]
    fn = _build.launcher("hash_partition_launch")
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = fn(keys.data_ptr(), n, n_parts, part.data_ptr(), hist.data_ptr(), stream)
    _build.launched(name, rc)
    return part, hist
