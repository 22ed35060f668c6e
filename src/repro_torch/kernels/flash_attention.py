"""Wrapper of the ``flash_attention`` CUDA kernel (csrc/flash_attention.cu).

The kernel replaces the TPU kernel ``flash_attention_pallas``
(src/repro/kernels/flash_attention.py): online-softmax attention over
q (BH, Sq, D) and k/v (BH, Sk, D) in float32 or bfloat16.
"""

from __future__ import annotations

import torch

from . import _build

#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
MAX_BH = 65535                  # the grid's y extent


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q (BH, Sq, D), k/v (BH, Sk, D), one dtype (float32 or bfloat16),
    contiguous on one CUDA device, Sq and Sk >= 1 → (BH, Sq, D) in that dtype."""
    _require(q.is_cuda and k.device == q.device and v.device == q.device,
             "tensors must share one CUDA device")
    _require(q.dtype in DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
             "q, k and v must all be float32 or all bfloat16")
    _require(q.dim() == 3 and k.dim() == 3 and k.shape == v.shape,
             "want q (BH, Sq, D), k/v (BH, Sk, D)")
    bh, sq, d = q.shape
    sk = k.shape[1]
    _require(k.shape[0] == bh and k.shape[2] == d, "q and k/v disagree on BH or D")
    _require(d in HEAD_DIMS, f"head dim {d} not in {HEAD_DIMS}")
    _require(sq >= 1 and sk >= 1, "Sq and Sk must be >= 1")
    _require(bh <= MAX_BH and max(sq, sk) < 2**31, "too large for one launch")
    _require(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)),
             "tensors must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    if bh == 0:                     # nothing to compute: no launch, no count
        return out
    fn = _build.launcher("flash_attention_launch")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq, sk, d,
            int(causal), d ** -0.5, int(q.dtype == torch.bfloat16), stream)
    _build.launched("flash_attention", rc)
    return out
