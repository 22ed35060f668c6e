# Hand-written CUDA kernels (csrc/*.cu), their plain PyTorch versions
# (ref.py), the ctypes build (_build.py) and the device-dispatching entry
# points (ops.py): the join dataplane's ops and the kernel library of
# ``repro.kernels``.
from .ops import (
    blake2b_chunks,
    flash_attention,
    fold64,
    hash_partition,
    hash_partition_pack,
    merge_join_counts,
    merge_join_pairs,
    ssd_chunk,
)
