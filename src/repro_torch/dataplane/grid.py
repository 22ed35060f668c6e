"""Step-3 grid routing among p machines on one device (the GridRoute op).

The Lemma 3.1 cartesian grid over the isolated R''_X lists is composed with
the Lemma 3.3 HyperCube over L \\ I via the Lemma 3.2 matrix: virtual machine
``v = cp_cell * hc_size + hc_cell``.  Every row is *replicated* to its set of
destination virtual cells, tagged with the cell id in a new leading column,
and exchanged with the same capacity-padded exchange the hash exchange uses —
virtual cell ``v`` lives on machine ``v % p``.  Afterwards all fragments of a
cell are co-located, so the LocalJoin op lowers to communication-free
colocated joins keyed on the cell column.

The geometry rides along as per-stage operands: a stage's grid dims, cell
strides and enumeration tables are (s, ...) arrays, and the per-row copy
count is padded to a bucket-wide pow2 ``fanout`` with -1 sentinel entries
(ghosted by the exchange, never sent).  The destination algebra:

  CP side:  v = (id mod dim) · S + T_k,   S = stride·hc_size,
            T = [contrib_j·hc_size + h]   (j outer, h inner)
  HC side:  v = Σ_f coord_f·stride_f + T_k,
            T = [cp_row·hc_size + free_contrib_j]   (cp_row outer)

Overflow contract matches repro_torch.dataplane.join: ``ovf`` is
(s, p, 2) with column 0 = send-slot overflow, column 1 = output overflow.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.ref import as_u32, mul_u32
from ..mpc.cartesian import CartesianGrid, cp_cell_contribs
from ..mpc.hypercube import HyperCubeGrid, hc_cell_contribs
from .exchange import batched_exchange_by_partition, valid_mask
from .join import infer_device, to_dev


@dataclass(frozen=True)
class CPBatchSig:
    """Static shape bundle of a batched CP-side route: only the padded
    fanout — dims, strides, and tables are per-stage data."""

    fanout: int


@dataclass(frozen=True)
class HCBatchSig:
    """Static shape bundle of a batched HC-side route: which row columns are
    hashed into coordinates, and the padded fanout."""

    cols: Tuple[int, ...]
    fanout: int


def coord_hash(vals: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """Per-attribute coordinate hash: uint32 avalanche mix of (value, salt).
    Every machine evaluates the same function (shared randomness, paper
    footnote 2).  Returns the uint32 hash values held in int64."""
    h = (mul_u32(as_u32(vals), 2654435761) + as_u32(salt)) & 0xFFFFFFFF
    h = h ^ (h >> 15)
    h = mul_u32(h, 2246822519)
    return h ^ (h >> 13)


def _pad_table(t, fanout: int) -> np.ndarray:
    """Pad a destination-offset table to ``fanout`` with -1 sentinels."""
    out = np.full((fanout,), -1, dtype=np.int32)
    out[: len(t)] = t
    return out


def cp_batch_params(grid: Optional[CartesianGrid], list_idx: int, hc_size: int):
    """Per-stage operands of the batched CP route for one isolated list:
    (dim, scale S, offset table T).  Lists beyond t' broadcast to every CP
    cell (dim = 1, S = 0, T enumerates the full grid)."""
    if grid is not None and list_idx < grid.t_prime:
        stride, contribs = cp_cell_contribs(grid.dims, list_idx)
        dim = grid.dims[list_idx]
        scale = stride * hc_size
        table = [c * hc_size + h for c in contribs for h in range(hc_size)]
    else:
        cp_size = grid.size if grid is not None else 1
        dim, scale = 1, 0
        table = [c * hc_size + h for c in range(cp_size) for h in range(hc_size)]
    return dim, scale, table


def hc_batch_params(grid: HyperCubeGrid, scheme: Sequence[str], cp_size: int):
    """Per-stage operands of the batched HC route for one light fragment:
    (fixed column indices, shares, strides, offset table T)."""
    fixed_attrs = [a for a in scheme if a in grid.attrs]
    strides, contribs = hc_cell_contribs(grid.attrs, grid.dims, fixed_attrs)
    cols = tuple(list(scheme).index(a) for a in fixed_attrs)
    shares = [grid.share(a) for a in fixed_attrs]
    stride_list = [strides[a] for a in fixed_attrs]
    table = [cp * grid.size + fc for cp in range(cp_size) for fc in contribs]
    return cols, shares, stride_list, table


def batched_replicate_to_cells(rows: torch.Tensor, counts: torch.Tensor,
                               dests: torch.Tensor, cap_slot: int, cap_out: int):
    """Fan every stage's rows (s, p, cap, w) out to their destination cells
    dests (s, p, cap, F) (-1 = sentinel copy, never sent), tag each copy with
    its cell, and exchange the stack to machine cell % p.  Returns
    (out (s, p, cap_out, 1+w), counts (s, p), ovf_slot (s, p), ovf_out (s, p))."""
    s, p, cap, w = rows.shape
    fanout = dests.shape[3]
    rep = rows.repeat_interleave(fanout, dim=2)          # keeps prefix validity
    v = dests.reshape(s, p, cap * fanout).to(torch.int32)
    tagged = torch.cat([v[..., None], rep], dim=3)
    part = torch.where(v < 0, torch.full_like(v, p), v % p)   # sentinel → ghost
    return batched_exchange_by_partition(tagged, counts * fanout, part, cap_slot, cap_out)


def _cp_dests(offs, dims, scales, table, cap: int):
    ids = offs.to(torch.int32)[:, :, None] + torch.arange(cap, dtype=torch.int32,
                                                          device=offs.device)
    own = ids % dims.to(torch.int32)[:, None, None]
    dests = own[..., None] * scales.to(torch.int32)[:, None, None, None] + table[:, None, None, :]
    return torch.where(table[:, None, None, :] < 0, torch.full_like(dests, -1), dests)


def _hc_dests(rows, salts, shares, strides, table, cols):
    s, p, cap, _ = rows.shape
    flat = torch.zeros((s, p, cap), dtype=torch.int32, device=rows.device)
    for f, col in enumerate(cols):
        coord = coord_hash(rows[..., col], salts[:, f, None, None]) % as_u32(
            shares[:, f, None, None])
        flat = flat + coord.to(torch.int32) * strides[:, f, None, None].to(torch.int32)
    dests = flat[..., None] + table[:, None, None, :]
    return torch.where(table[:, None, None, :] < 0, torch.full_like(dests, -1), dests)


def _dest_hist(counts: torch.Tensor, dests: torch.Tensor, p: int) -> torch.Tensor:
    """(s, p) valid row counts + (s, p, cap, F) destination cells (-1 = ghost)
    → (s, p_src, p_dst) copy histogram: exactly the send-slot occupancy the
    emit pass will see, so its column sums are the exact receive sizes."""
    s, _, cap, fanout = dests.shape
    v = dests.reshape(s * p, cap * fanout)
    valid = valid_mask(cap * fanout, counts.reshape(s * p) * fanout)
    dst = torch.where(valid & (v >= 0), (v % p).to(torch.int64),
                      torch.full(v.shape, p, dtype=torch.int64, device=v.device))
    hist = torch.zeros((s * p, p + 1), dtype=torch.int64, device=v.device)
    hist.scatter_add_(1, dst, torch.ones_like(dst))
    return hist[:, :p].to(torch.int32).reshape(s, p, p)


def _route(rows, cnts, *geo, sig, cap_slot: int, cap_out: int, count: bool, device):
    rows, cnts = to_dev(rows, device), to_dev(cnts, device)
    geo = [to_dev(g, device) for g in geo]
    cap = rows.shape[2]
    if isinstance(sig, CPBatchSig):
        offs, dims, scales, table = geo
        dests = _cp_dests(offs, dims, scales, table, cap)
    else:
        salts, shares, strides, table = geo
        dests = _hc_dests(rows, salts, shares, strides, table, sig.cols)
    if count:
        return (_dest_hist(cnts, dests, rows.shape[1]),)
    out, c, o_s, o_o = batched_replicate_to_cells(rows, cnts, dests, cap_slot, cap_out)
    return out, c, torch.stack([o_s, o_o], dim=-1)


def _route_args(rows, counts, sig, offsets, dims, scales, salts, shares, strides, table):
    if isinstance(sig, CPBatchSig):
        return (rows, counts,
                np.asarray(offsets, dtype=np.int32), np.asarray(dims, dtype=np.int32),
                np.asarray(scales, dtype=np.int32), np.asarray(table, dtype=np.int32))
    if isinstance(sig, HCBatchSig):
        # uint32 salts and shares travel as their int64 values
        return (rows, counts,
                np.asarray(salts, dtype=np.uint32).astype(np.int64),
                np.asarray(shares, dtype=np.uint32).astype(np.int64),
                np.asarray(strides, dtype=np.int32), np.asarray(table, dtype=np.int32))
    raise TypeError(f"unknown grid-route signature {sig!r}")


def batched_sharded_grid_route(
    rows, counts, sig, *, offsets=None, dims=None, scales=None, salts=None,
    shares=None, strides=None, table=None, cap_slot: int, cap_out: int,
    device=None, invoke: bool = True,
):
    """Route every stage of a geometry bucket to its virtual cells in one
    call.  rows (s, p, cap, w), counts (s, p); CP side: ``offsets`` (s, p)
    global-id bases, ``dims``/``scales`` (s,); HC side: ``salts``,
    ``shares``, ``strides`` (s, n_fixed); both: ``table`` (s, sig.fanout)
    -1-padded cell offsets.  Returns (out (s, p, cap_out, 1+w), counts (s, p),
    ovf (s, p, 2)); column 0 of every output row is the destination cell id.
    ``invoke=False`` returns ``(fn, args)``."""
    args = _route_args(rows, counts, sig, offsets, dims, scales, salts, shares, strides, table)
    fn = partial(_route, sig=sig, cap_slot=cap_slot, cap_out=cap_out, count=False,
                 device=infer_device(device, *args))
    return (fn, args) if not invoke else fn(*args)


def batched_sharded_grid_route_count(
    rows, counts, sig, *, offsets=None, dims=None, scales=None, salts=None,
    shares=None, strides=None, table=None, device=None, invoke: bool = True,
):
    """Count-only twin of `batched_sharded_grid_route`: the exact per-stage
    (p_src, p_dst) copy histograms with no exchange — same destination
    algebra, same salts.  The executor's count-then-emit pass sizes the
    emit's cap_slot (max entry) and cap_out (max column sum) from it.
    Returns ``(hist (s, p, p),)``; ``invoke=False`` → ``(fn, args)``."""
    args = _route_args(rows, counts, sig, offsets, dims, scales, salts, shares, strides, table)
    fn = partial(_route, sig=sig, cap_slot=0, cap_out=0, count=True,
                 device=infer_device(device, *args))
    return (fn, args) if not invoke else fn(*args)
