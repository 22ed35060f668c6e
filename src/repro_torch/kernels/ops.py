"""Public kernel entry points.

The dataplane's ops take a leading segment axis; the kernel library's ops
(``hash_partition``, ``flash_attention``, ``ssd_chunk``, ``fold64``) keep the
layout and shape contract of the JAX package's ``repro.kernels.ops``;
``blake2b_chunks`` serves the join service's table digest and has no TPU
counterpart.
Dispatch is by the tensors' device alone: a CPU tensor runs the plain
PyTorch version (``ref.py``), a CUDA tensor launches the hand-written kernel
— or raises; there is no fallback from the kernel to the plain version.
``flash_attention`` and ``ssd_chunk`` also take ``meta`` tensors, for which
they return empty outputs of the right shapes (a meta tensor holds no data, so
there is nothing to compute): the dry run counts a step on meta tensors. Each
of the two runs as one unit of ``analysis.cost.kernel_unit``.
"""

from __future__ import annotations

import torch

from ..analysis.cost import kernel_unit
from . import digest as _dg
from . import flash_attention as _fa
from . import hash_partition as _hp
from . import merge_join as _mj
from . import ref as _ref
from . import ssd as _ssd


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA ones; raises on anything else."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernels take CPU or CUDA tensors on one device type, got {kinds}")


def _on_meta(*tensors: torch.Tensor) -> bool:
    return {t.device.type for t in tensors} == {"meta"}


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


def blake2b_chunks(data: torch.Tensor) -> torch.Tensor:
    """data (N,) uint8 → (ceil(N / CHUNK), 32) uint8: row i is
    ``hashlib.blake2b(chunk_i, digest_size=32)`` of the i-th
    ``digest.CHUNK``-byte chunk of ``data`` (the last may be shorter; empty
    data has no chunk)."""
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise ValueError(f"blake2b_chunks: want (N,) uint8 data, got {tuple(data.shape)} "
                         f"{data.dtype}")
    if _on_cpu(data):
        return _ref.blake2b_chunks_ref(data)
    out = torch.empty((_dg.n_chunks(data.numel()), _dg.DIGEST_BYTES), dtype=torch.uint8,
                      device=data.device)
    return _dg.blake2b_chunks_cuda(data.contiguous(), out)


def fold64(keys: torch.Tensor) -> torch.Tensor:
    """Fold int64 (or uint64) join keys to int32 lanes: the low 32 bits of
    ``k ^ (k >> 32)`` with a logical shift, wrapped to int32."""
    k = keys.view(torch.int64) if keys.dtype == torch.uint64 else keys.to(torch.int64)
    return _ref.wrap_i32((k ^ ((k >> 32) & _ref.MASK32)) & _ref.MASK32)


def hash_partition(keys: torch.Tensor, n_parts: int):
    """keys (N,) int32 (int64 and uint64 keys are folded first) → (part (N,)
    int32 partition id per key, hist (n_parts,) int32 global histogram)."""
    if keys.dim() != 1:
        raise ValueError(f"hash_partition: want keys (N,), got {tuple(keys.shape)}")
    if keys.dtype in (torch.int64, torch.uint64):
        keys = fold64(keys)
    if keys.dtype != torch.int32:
        raise ValueError(f"hash_partition: want int32 or 64-bit keys, got {keys.dtype}")
    if n_parts < 1:
        raise ValueError("hash_partition: n_parts must be >= 1")
    if _on_cpu(keys):
        return _ref.hash_partition_ref(keys, n_parts)
    return _hp.hash_partition_cuda(keys.contiguous(), n_parts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """Online-softmax attention: q (BH, Sq, D), k/v (BH, Sk, D) → (BH, Sq, D).

    ``bq``/``bk`` are the reference op's block sizes, taken as min(bq, Sq)
    and min(bk, Sk); as there, Sq and Sk must be multiples of them (Sq = 100
    passes, Sq = 200 raises).  The kernel tiles by its own sizes."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError("flash_attention: want q (BH, Sq, D) and k/v (BH, Sk, D)")
    sq, sk = q.shape[1], k.shape[1]
    bq, bk = min(bq, sq), min(bk, sk)
    if bq < 1 or bk < 1 or sq % bq or sk % bk:
        raise ValueError(f"flash_attention: Sq={sq}, Sk={sk} are not multiples of the "
                         f"blocks bq={bq}, bk={bk}")
    meta = _on_meta(q, k, v)
    cpu = not meta and _on_cpu(q, k, v)
    with kernel_unit("flash_attention", q, k, v, causal=causal):
        if meta:
            return v.new_empty((q.shape[0], sq, v.shape[2]))
        if cpu:
            return _ref.flash_attention_ref(q, k, v, causal=causal)
        return _fa.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), causal)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_ssm: torch.Tensor,
              c_ssm: torch.Tensor, chunk: int = 64):
    """Mamba-2 SSD over chunks: x (BH, S, P), dt (BH, S), a (BH,), b/c
    (BH, S, N), float32, S % chunk == 0 → (y (BH, S, P), final_state
    (BH, P, N))."""
    if x.dim() != 3 or chunk < 1 or x.shape[1] % chunk:
        raise ValueError(f"ssd_chunk: want x (BH, S, P) with S a multiple of chunk={chunk}, "
                         f"got {tuple(x.shape)}")
    meta = _on_meta(x, dt, a, b_ssm, c_ssm)
    cpu = not meta and _on_cpu(x, dt, a, b_ssm, c_ssm)
    with kernel_unit("ssd_chunk", x, dt, a, b_ssm, c_ssm, chunk=chunk):
        if meta:
            bh, _, p_dim = x.shape
            return (x.new_empty(x.shape, dtype=torch.float32),
                    x.new_empty((bh, p_dim, b_ssm.shape[2]), dtype=torch.float32))
        if cpu:
            return _ref.ssd_chunked_ref(x, dt, a, b_ssm, c_ssm, chunk)
        return _ssd.ssd_chunk_cuda(*(t.contiguous() for t in (x, dt, a, b_ssm, c_ssm)), chunk)
