"""Explicit split-KV distributed decode attention (flash-decoding across the model
axis) on a virtual mesh.

Each model-shard holds a sequence slice of the KV cache; it computes partial
(m_i = max score, l_i = Σ exp, acc_i = Σ exp·V) over its slice, then one psum-style
combine with global max stabilization reconstructs the exact softmax:

    m = pmax(m_i);  l = Σ_i l_i·e^{m_i-m};  out = Σ_i acc_i·e^{m_i-m} / l

On one device the shards are a leading tensor dim (``specs.place``) and the
combine is a reduction over it (``collectives.pmax`` / ``psum``). Communication
per step on a real mesh: O(B·H·(2 + hd)), independent of sequence length."""

from __future__ import annotations

import torch

from ..distributed.collectives import pmax, psum
from ..distributed.ctx import Mesh
from ..distributed.specs import P, gather, place


def split_kv_decode_attention(
    mesh: Mesh,
    axis_name: str,
    q: torch.Tensor,          # (B, H, hd) — replicated over the model axis
    k_cache: torch.Tensor,    # (B, S, KV, hd) — S sharded over the model axis
    v_cache: torch.Tensor,
) -> torch.Tensor:
    kv_spec = P(None, axis_name, None, None)
    qb, kb, vb = place(q, mesh, P()), place(k_cache, mesh, kv_spec), place(v_cache, mesh, kv_spec)
    n = len(mesh.axis_names)
    b, h, hd = q.shape
    kv = k_cache.shape[2]
    rep = h // kv
    qg = qb.reshape(*mesh.sizes, b, kv, rep, hd)
    s = torch.einsum("...bkrd,...bskd->...bkrs", qg, kb).float() * (hd ** -0.5)
    m_loc = s.amax(dim=-1)                                        # (*mesh, B, KV, rep)
    m = pmax(m_loc, mesh, axis_name)
    e = torch.exp(s - m[..., None])
    l_loc = e.sum(dim=-1)
    acc_loc = torch.einsum("...bkrs,...bskd->...bkrd", e.to(vb.dtype), vb)
    l = psum(l_loc, mesh, axis_name)
    acc = psum(acc_loc, mesh, axis_name)
    out = acc / l[..., None].to(acc.dtype)
    return gather(out.reshape(*out.shape[:n], b, h, hd), mesh, P())


def reference_decode_attention(q, k_cache, v_cache):
    """Single-device oracle."""
    b, h, hd = q.shape
    kv = k_cache.shape[2]
    rep = h // kv
    qg = q.reshape(b, kv, rep, hd)
    s = torch.einsum("bkrd,bskd->bkrs", qg, k_cache).float() * (hd ** -0.5)
    w = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkrs,bskd->bkrd", w, v_cache)
    return out.reshape(b, h, hd)
