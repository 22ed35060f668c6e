# Hand-written CUDA kernels of the join dataplane (csrc/*.cu), their plain
# PyTorch versions (ref.py), the ctypes build (_build.py) and the
# device-dispatching entry points (ops.py).
from .ops import hash_partition_pack, merge_join_counts, merge_join_pairs
