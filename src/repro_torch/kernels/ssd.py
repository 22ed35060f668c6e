"""Wrapper of the ``ssd_chunk`` CUDA kernel (csrc/ssd.cu).

The kernel replaces the TPU kernel ``ssd_chunk_pallas``
(src/repro/kernels/ssd.py): the Mamba-2 SSD scan, as three launches on one
stream (chunk-local states, the scan over the states, the chunk outputs).
"""

from __future__ import annotations

import torch

from . import _build


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_chunk: {msg}")


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_ssm: torch.Tensor,
                   c_ssm: torch.Tensor, chunk: int):
    """x (BH, S, P), dt (BH, S), a (BH,), b/c (BH, S, N), float32, contiguous
    on one CUDA device, S % chunk == 0 → (y (BH, S, P), final_state
    (BH, P, N)) float32.  Raises RuntimeError where the chunk needs more
    shared memory than a block can have (chunk above about 22,000 steps)."""
    args = (x, dt, a, b_ssm, c_ssm)
    _require(x.is_cuda and all(t.device == x.device for t in args),
             "tensors must share one CUDA device")
    _require(all(t.dtype == torch.float32 for t in args), "tensors must be float32")
    _require(x.dim() == 3 and b_ssm.dim() == 3, "want x (BH, S, P) and b/c (BH, S, N)")
    bh, s, p = x.shape
    n = b_ssm.shape[2]
    _require(dt.shape == (bh, s) and a.shape == (bh,) and b_ssm.shape == (bh, s, n)
             and c_ssm.shape == (bh, s, n), "want dt (BH, S), a (BH,), b/c (BH, S, N)")
    _require(all(t.is_contiguous() for t in args), "tensors must be contiguous")
    _require(chunk >= 1 and s % chunk == 0, f"S={s} is not a multiple of chunk={chunk}")
    _require(p >= 1 and n >= 1, "P and N must be >= 1")
    _require(bh * s * max(p, n) < 2**31 and chunk <= 2**16 and max(p, n) <= 2**12,
             "too large for one launch")
    y = torch.empty_like(x)
    state = torch.empty((bh, p, n), dtype=torch.float32, device=x.device)
    if bh == 0:                     # nothing to compute: no launch, no count
        return y, state
    # the chunks' local states (then the states before each chunk), then cum
    scratch = torch.empty((bh * (s // chunk) * p * n + bh * s,), dtype=torch.float32,
                          device=x.device)
    fn = _build.launcher("ssd_chunk_launch")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(*(t.data_ptr() for t in args), y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
            bh, s, p, n, chunk, stream)
    _build.launched("ssd_chunk", rc)
    return y, state
