"""Benchmark of the PyTorch/CUDA join service (``repro_torch``) on one card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``; see ``run.py``."""
