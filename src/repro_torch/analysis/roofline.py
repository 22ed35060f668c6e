"""Roofline terms from a counted step.

  compute  = FLOPs_dev / peak_flops
  memory   = Bytes_dev / hbm_bw
  collective = CollBytes_dev / link_bw

:class:`HW` keeps the JAX package's TPU v5e-class figures, so the port's terms
compare with the reference's; :data:`HW_H100` is the card the port runs on.
``collective_bytes`` sums the *result* operand sizes of every all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute in HLO text — a
serial-sum convention (no overlap credit), i.e. an upper bound on link time; the
port's cost counter (``cost.py``) reports its own collectives under the same keys.
:func:`kernel_costs` is the work of one call of a kernel-library op, the unit
the cost counter and ``chip_smoke.py``'s bounds both read.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")
# result shapes appear left of ` = ... <op>(`; handles tuple results
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|\w+\[[^\]]*\][^ ]*)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-op-kind result bytes (per device) + op counts. ``-start`` ops counted once
    (their ``-done`` twin carries no payload of its own)."""
    out: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    for line in hlo_text.splitlines():
        m = _OP_RE.match(line)
        if not m:
            continue
        if "-done(" in line:
            continue
        shape_str, op = m.group(1), m.group(2)
        out[op] += _shape_bytes(shape_str)
        counts[op] += 1
    return {**{f"{k}_bytes": v for k, v in out.items()},
            **{f"{k}_count": v for k, v in counts.items()},
            "total_bytes": sum(out.values())}


@dataclass(frozen=True)
class HW:
    """TPU v5e-class chip (the JAX package's targets)."""

    peak_flops: float = 197e12    # bf16
    hbm_bw: float = 819e9         # B/s
    link_bw: float = 50e9         # B/s per ICI link


#: NVIDIA H100 SXM, data-sheet figures: dense bf16 tensor-core FLOP/s, HBM3 B/s,
#: and NVLink B/s per direction
HW_H100 = HW(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)


def roofline_terms(
    flops_dev: float,
    bytes_dev: float,
    coll_bytes_dev: float,
    hw: HW = HW(),
) -> Dict[str, float]:
    t_c = flops_dev / hw.peak_flops
    t_m = bytes_dev / hw.hbm_bw
    t_x = coll_bytes_dev / hw.link_bw
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x), key=lambda kv: kv[1])
    return {
        "t_compute_s": t_c,
        "t_memory_s": t_m,
        "t_collective_s": t_x,
        "bottleneck": dom[0],
        "t_bound_s": dom[1],
    }


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS: 6·N·D (dense) / 6·N_active·D (MoE) per step; decode: D = batch
    tokens (one step)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.batch


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def kernel_costs(name: str, *tensors, **kw) -> Dict[str, int]:
    """The work of one call of a kernel-library op, from its arguments' shapes:
    {"flops", "bytes"}, each input read once and each output written once.

    ``flash_attention(q, k, v, causal=...)``: 4·D FLOPs per (query, key) pair
    (the two products); causal attention with Sq = Sk keeps BH·S(S+1)/2 pairs,
    any other BH·Sq·Sk. ``ssd_chunk(x, dt, a, b, c, chunk=...)``: per chunk,
    C·Bᵀ and the weighted x on the causal triangle, then the inter-chunk term
    and the state update, 2 FLOPs per multiply-add; the outputs are y (the
    size of x) and the (BH, P, N) final state."""
    if name == "flash_attention":
        q, k, v = tensors
        bh, sq, d = q.shape
        sk = k.shape[1]
        causal = kw.get("causal", True)
        pairs = bh * sq * (sq + 1) // 2 if causal and sq == sk else bh * sq * sk
        out = bh * sq * v.shape[2] * v.element_size()
        return {"flops": 4 * d * pairs, "bytes": _nbytes(q) + _nbytes(k) + _nbytes(v) + out}
    if name == "ssd_chunk":
        x, dt, a, b_ssm, c_ssm = tensors
        chunk = kw["chunk"]
        bh, s_len, p_dim = x.shape
        n_dim = b_ssm.shape[2]
        tri = chunk * (chunk + 1) // 2
        flops = bh * (s_len // chunk) * 2 * (tri * (n_dim + p_dim) + 2 * chunk * p_dim * n_dim)
        outs = _nbytes(x) + bh * p_dim * n_dim * x.element_size()
        return {"flops": flops, "bytes": sum(_nbytes(t) for t in tensors) + outs}
    raise ValueError(f"kernel_costs: no formula for {name!r}")
