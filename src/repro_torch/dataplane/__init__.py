"""Torch data plane: the engine's communication phases with p machines held
as a leading tensor axis on one device.

Static-shape MPC: relations are capacity-padded per-machine blocks (rows +
validity count); exchanges are one transpose of a (p_src, p_dst, cap_slot, w)
send buffer, sized by the paper's w.h.p. load bounds, with overflow surfaced
as a counter.
"""

from .exchange import (
    batched_exchange_by_partition,
    batched_hash_exchange,
    blockify,
    compact,
    exchange_by_partition,
    hash_exchange,
    pack_by_partition,
    salt_offset,
    unblockify,
)
from .grid import (
    CPBatchSig,
    HCBatchSig,
    batched_sharded_grid_route,
    batched_sharded_grid_route_count,
    coord_hash,
)
from .join import (
    batched_sharded_colocated_join,
    batched_sharded_colocated_join_count,
    batched_sharded_intersect,
    batched_sharded_semijoin,
    local_join_count,
    local_join_filtered,
    local_semijoin,
    local_sorted_join,
    local_unique,
)
