"""The yardstick of the join kernels' rooflines: the bytes each call must
move (each input read once, each output written once, what the inputs need
and not the most they could) and the card's memory rate.

Copied from the join kernels' byte bounds of the repository's smoke run
(phase 6), so the same work is counted whatever implements it.
"""

from __future__ import annotations

import re

#: H100 SXM device memory rate, NVIDIA's data sheet (bytes/s)
HBM_BYTES_PER_S = 3.35e12

#: the device functions that carry each op's work, by name as the profiler
#: reports them
DEVICE_KERNELS = {
    "hash_partition_pack": re.compile(r"\b(hp_pack|hp_wide_rank|hp_wide_scan|hp_wide_slot)\b"),
    "merge_join_counts": re.compile(r"\bmj_counts\b"),
    "merge_join_pairs": re.compile(r"\bmj_pairs\b"),
}


def hash_partition_pack(keys, counts, n_parts: int, *, out) -> int:
    """keys (S, N) int32 and counts (S,) read; part and slot (S, N) int32 and
    send_counts (S, n_parts) int32 written."""
    s, n = keys.shape
    return 4 * s * n + 4 * s + 8 * s * n + 4 * s * n_parts


def merge_join_counts(a_keys, b_keys, *, out) -> int:
    """a (S, N) and b (S, M) int32 read; lower and upper (S, N) int32 written."""
    s, n = a_keys.shape
    return 4 * s * n + 4 * s * b_keys.shape[1] + 8 * s * n


def merge_join_pairs(lower, starts, cap_out: int, *, out):
    """a_idx and b_idx (S, cap_out) int32 written; lower and starts read once
    at each key the slots select (a_idx is nondecreasing per segment, so the
    selected keys are its runs).  Returns a 0-d device tensor (no sync)."""
    s, n = starts.shape
    if not cap_out or not n:        # no launch: the op returns zeros itself
        return 0
    a_idx = out[0]
    runs = (a_idx[:, 1:] != a_idx[:, :-1]).sum()
    return 8 * s * cap_out + 8 * (s + runs)
