"""Wrapper of the ``blake2b_chunks`` CUDA kernel (csrc/digest.cu), and the
path choice of the table digest's leaves.

The kernel replaces no TPU kernel: it was added for the join service's
content digest of the bound tables (``core/query.py`` ``table_digest``), a
Merkle tree of BLAKE2b whose leaves are the ``CHUNK``-byte chunks of a
table's bytes.  The kernel writes each chunk's
``hashlib.blake2b(chunk, digest_size=32)``; the host combines them.

:func:`chunk_digests` hashes a table's chunks on the card for a CUDA device
and a table of at least ``CARD_DIGEST_MIN_BYTES``, on the host otherwise,
and counts the bytes each path hashed.

:func:`stream_chunk_digests` sends a host array to the card in
``SLICE``-byte slices (a multiple of ``CHUNK``, so no chunk straddles two)
through two page-locked buffers and two device slices: the host fills one
page-locked buffer while the other's slice crosses on a side stream and the
kernel hashes the slice before it.  The chunk digests are read back once.
It holds at most two slices and the digests on the card, and frees them
before it returns.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.query import DIGEST_CHUNK as CHUNK
from ..core.query import host_chunk_digests
from ..spans import count, span
from . import _build

#: the bytes of one host-to-card slice: a multiple of CHUNK
SLICE = 32 * 1024 * 1024
DIGEST_BYTES = 32
#: the least bytes of a table that a CUDA device digests on the card: below
#: it the card's fixed cost (~0.6 ms: the copies, one chunk's 128 serial
#: compressions, the read-back) passes the host's hash.  On an H100 host the
#: two met between 256 KiB (host 0.55 ms, card 0.61) and 512 KiB (1.13
#: against 0.62; chip_smoke.py's digest phase)
CARD_DIGEST_MIN_BYTES = 1 << 19


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"blake2b_chunks: {msg}")


def n_chunks(n_bytes: int) -> int:
    return -(-n_bytes // CHUNK)


def blake2b_chunks_cuda(data: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """data (N,) uint8, contiguous and 16-byte aligned on a CUDA device →
    ``out`` (ceil(N / CHUNK), 32) uint8 on the same device, each row one
    chunk's BLAKE2b-256 digest."""
    _require(data.is_cuda and out.device == data.device, "tensors must share one CUDA device")
    _require(data.dtype == torch.uint8 and out.dtype == torch.uint8, "tensors must be uint8")
    _require(data.dim() == 1 and data.is_contiguous(), "want contiguous (N,) data")
    _require(out.shape == (n_chunks(data.numel()), DIGEST_BYTES) and out.is_contiguous(),
             f"want a contiguous ({n_chunks(data.numel())}, {DIGEST_BYTES}) out")
    _require(data.data_ptr() % 16 == 0 and out.data_ptr() % 8 == 0,
             "data must be 16-byte aligned and out 8-byte aligned")
    if data.numel() == 0:           # no chunk: no launch, no count
        return out
    fn = _build.launcher("blake2b_chunks_launch")
    stream = torch.cuda.current_stream(data.device).cuda_stream
    rc = fn(data.data_ptr(), data.numel(), CHUNK, out.data_ptr(), stream)
    _build.launched("blake2b_chunks", rc)
    return out


def stream_chunk_digests(u8: np.ndarray, device: torch.device) -> bytes:
    """The chunk digests of the 1-D uint8 host array ``u8``, computed on the
    CUDA ``device`` → ceil(N / CHUNK) · 32 bytes, as
    ``host_chunk_digests(u8)`` gives them."""
    n = u8.nbytes
    if n == 0:
        return b""
    device = torch.device(device)
    size = min(SLICE, n_chunks(n) * CHUNK)
    src = torch.from_numpy(u8)      # torch's copy into page-locked memory runs in threads
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)     # one of torch's pooled streams
    bufs = 1 if n <= size else 2
    host = [torch.empty(size, dtype=torch.uint8, pin_memory=True) for _ in range(bufs)]
    card = [torch.empty(size, dtype=torch.uint8, device=device) for _ in range(bufs)]
    digests = torch.empty((n_chunks(n), DIGEST_BYTES), dtype=torch.uint8, device=device)
    copied = [torch.cuda.Event() for _ in range(bufs)]
    hashed = [torch.cuda.Event() for _ in range(bufs)]
    for k, a in enumerate(range(0, n, size)):
        b, i = min(a + size, n), k % 2
        with span("copy"):
            if k >= 2:
                copied[i].synchronize()     # slice k - 2 has left this buffer
                side.wait_event(hashed[i])  # and been hashed out of this slice
            host[i][:b - a].copy_(src[a:b])
            with torch.cuda.stream(side):
                card[i][:b - a].copy_(host[i][:b - a], non_blocking=True)
                copied[i].record(side)
        with span("kernel"):
            main.wait_event(copied[i])
            blake2b_chunks_cuda(card[i][:b - a], digests[a // CHUNK:n_chunks(b)])
            hashed[i].record(main)
    with span("readback"):
        return digests.cpu().numpy().tobytes()


def chunk_digests(u8: np.ndarray, device) -> bytes:
    """The chunk digests of the table bytes ``u8`` (1-D uint8, on the host),
    as :func:`~repro_torch.core.query.host_chunk_digests` gives them: on
    the card for a CUDA ``device`` and at least ``CARD_DIGEST_MIN_BYTES``,
    on the host otherwise.  Counts the bytes as ``card_bytes`` or
    ``host_bytes`` under the current span."""
    card = torch.device(device).type == "cuda" and u8.nbytes >= CARD_DIGEST_MIN_BYTES
    count("card_bytes", u8.nbytes if card else 0)
    count("host_bytes", 0 if card else u8.nbytes)
    return stream_chunk_digests(u8, device) if card else host_chunk_digests(u8)
