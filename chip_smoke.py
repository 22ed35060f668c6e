#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, each of which raises on failure (the script then exits non-zero):

  1. environment: card name and power limit, torch / CUDA / nvcc versions,
     and the build of every hand-written kernel from ``kernels/csrc``, with
     ptxas's registers, shared memory and spills per kernel and a check of
     the SASS of the bf16 attention and of the two ssd_chunk kernels that
     run 3xTF32 products for tensor-core instructions (HMMA/HGMMA);
  2. every kernel against its plain PyTorch version on the card on
     edge-case inputs: the integer kernels bit for bit (ragged lengths,
     empty and full counts, all-sentinel segments, duplicated keys, keys
     near +-2^31; for merge_join_counts also runs of one key across many
     merge stretches, N = 1 and M = 1 against 2^20 keys; for
     merge_join_pairs the main path's regime of zero-count keys and a
     zero-count tail, total > cap_out, one key owning every slot, runs of
     equal starts across stretches, N = 1, cap_out = 1, S = 4096; for
     hash_partition_pack 1024 tiles of look-back with one partition and
     with 64, N off a multiple of 1024, P = 1, the largest P of its
     single-block kernel and the wide kernel's first, P = 384, 1024 and
     4096);
     flash_attention at ragged and Sq != Sk shapes, BH = 1, causal and
     not, head dims 16-256, within 1e-4 (f32) and, in bf16, within the
     rounding error of the output and the weights
     (``ref.flash_attention_bf16_tolerance``); ssd_chunk at chunks
     16/64/256, one chunk and eight, and at its hazards (P = 17, N = 33,
     chunk 40; 64 chunks of 16; BH = 1; a = 0; a = -50; inputs one element
     off a 16-byte boundary), within 1e-4 of the plain version's largest
     magnitude; hash_partition also at N = 1, 3, 4097, N = 2^20 from an
     offset view and the largest P the wrapper takes;
  3. the join service at real size: the triangle query over a 2M-edge Zipf
     graph (500k vertices, skew 0.9, degree-oriented), ``JoinSession(p=64)``,
     submitted cold and warm; count against a scipy-sparse oracle, warm rows
     byte-identical to cold rows, no warm retries;
  4. heavy stages: a skewed Zipf graph at p=64, lambda=24, whose plan runs
     HashPartition and SemiJoin work; count against its oracle;
  5. row order: small parity queries on the card and on the CPU's plain path
     give byte-identical rows, counts, retries and retry logs;
  6. each join kernel timed on the largest inputs the main path (phases 3-5) gave
     it, beside its plain version, ``torch.searchsorted`` where it applies,
     and its memory bound (medians of five alternating rounds); for
     merge_join_pairs and hash_partition_pack also the device time and
     device operations per call (torch.profiler), for merge_join_pairs the
     bytes its design moves, and one line of hash_partition_pack at
     S=64, N=2^20, P=64 beside its bound; then each join kernel held
     against its plain version, bit for bit, on the largest inputs the
     "general" phase's timed submits gave it, and timed beside it;
  7. the kernel library at model widths: flash_attention at h2o-danube-1.8b
     prefill, ssd_chunk at mamba2-780m, hash_partition over 2M keys (and
     2M int64 keys through fold64), launches counted over one call each,
     outputs checked against the plain versions (and the bf16 attention
     limit against a variant with a key tile dropped, which it must catch in
     most rows), then each timed beside its plain version, its bound and
     (attention) SDPA, with TF32 off; for ssd_chunk and hash_partition also
     the device time and device operations per call (torch.profiler), and
     one line of hash_partition at N = 2^26, P = 64 beside its bound; and
     bf16 attention at two more head dims (deepseek-moe-16b prefill,
     D = 128, and gemma3-12b prefill, D = 256) beside SDPA and the bound,
     one log line each;
  digest: the service's table digest (``core/query.py`` ``table_digest``)
     of a lineorder-shaped table, 6,001,215 x 4 int64: the card path's
     digest equal to the host path's and its wall time beside the host's,
     the page-locked host-to-card rate and the host's copy into page-locked
     memory; the ``blake2b_chunks`` kernel alone on the resident table,
     every chunk digest equal to ``hashlib``'s, timed beside its instruction
     and byte bounds and its plain version; and both paths' times from 16
     KiB to 64 MiB, the crossover behind ``CARD_DIGEST_MIN_BYTES`` (after
     phase 2);
  patterns: subgraph enumeration through ``JoinSession(p=64).submit_pattern``:
     triangles of phase 3's graph against its oracle, the four cases of
     benchmarks/bench_subgraph.py byte-equal to the brute-force oracle and
     to the same session on the CPU, and 4-cliques of phase 3's graph
     (halved while the cold submit overruns 120 s or the card's memory)
     against an independent numpy oracle; kernel launches counted;
  service: the async service on one card session: a coalesced mixed batch
     (bench_service.py's three shapes, clique4 and cycle4 patterns, λ=16)
     byte-identical to serial submits, 8 client threads x 32
     ``submit_async`` requests resolved with the serial rows (queue-inclusive
     p50/p99 logged), and one coalesced group under a FaultPlan that fails
     one member's dispatch: that member alone fails, typed; kernel launches
     counted;
  verify: the static verifier in front of the card: a
     ``JoinSession(p=64, verify=True)`` over bench_subgraph.py's four cases
     and phase 4's heavy query, every cold submit fully verified and every
     warm one re-checking its bindings (``verify_us`` logged cold and warm),
     rows byte-identical to the unverified session of phases 3-5, its
     learned capacities on the cap grid, ``RunConfig(verify=True)`` of the
     heavy program passing, and that program with its RouteResidual dropped
     raising ``ProgramVerificationError`` before any kernel launch;
  simulator: the metered MPC simulator on the host, held against the card:
     the four bench_subgraph.py cases through
     ``enumerate_subgraphs(backend="simulator", p=64)`` at the canonical
     lambda, byte-equal to the card's occurrences, with ``check_load``
     passing and load, bound and load_ratio logged; bench_load_vs_p.py's
     Theorem 6.2 exponent sweep
     (triangle, cycle4, star3 x uniform, zipf1.5 x p in 8..256: each uniform
     slope within 0.25 of -1/rho, ``check_load`` passing in all 36 runs);
     and ``all_icp_checks`` on bench_isolated_cp.py's hub star (lambda 4, 8,
     16) within Theorem 5.4's and Lemma 5.5's bounds;
  general: the general (arbitrary-arity) route through ``JoinSession.submit``
     (Yannakakis sweeps, share route, cell join): ``ssb-star-sf1``, the Star
     Schema Benchmark's SF1 lineorder ⋈ customer ⋈ supplier ⋈ part as the
     ``star3`` family (6,001,215 uniform fact draws at SF1's cardinalities,
     ``default_rng(18)``), p=64, ``verify=True``, rows against a numpy
     oracle, warm byte-identical to cold with no retries, then an untimed
     submit for each op's peak memory and a profiled warm submit (host
     functions, the card's idle share); ``ssb-q41``, the same tables with
     the dimensions cut to SSB Q4.1's predicates so that both sweeps drop
     fact rows, against its numpy oracle, then one submit with every join
     kernel call held against its plain version; ``triangle-2M-general``,
     phase 3's table with ``force_general=True``, equal to phase 3's rows
     as a sorted set; and bench_acyclic.py's four cases at p=8,
     byte-identical to the CPU session and equal to ``backend="simulator"``
     with ``check_load`` passing; cold and warm wall time, the session's µs
     split, the host share of ``execute_us``, retries, launches and peak
     device memory logged per configuration;
  serve: the LM serve path (``repro_torch.models``) at published full width
     and depth, random weights from a seeded generator on the card:
     h2o-danube-1.8b (24 layers, every prefill attention on
     ``flash_attention``) and mamba2-780m (48 layers, every prefill SSD scan
     on ``ssd_chunk``), each a cold and a warm prefill of 4 x 2048
     ``synth_batch`` tokens and 64 greedy ``make_serve_step`` steps (cold and
     warm prefill ms, decode ms per step and tokens/s, peak device memory;
     the kernel launched exactly once per attention / Mamba layer per
     prefill, never in decode), one prefill with every kernel call held
     against its plain version, one profiled (torch.profiler: the kernel's
     and the matrix products' shares of the device time, the idle share),
     and the kernel timed at the largest inputs the serving run gave it;
     then each model cut to 2 layers in float32, the same weights on the CPU
     and the card: a 256-token prompt and 8 greedy steps, logits within
     1e-3 + 1e-3·|CPU| and the same token wherever the CPU's top-2 margin
     allows;
  train: the LM training path (``repro_torch.train``) at published full width
     and depth in the configs' bf16 with their own ``remat`` ("nothing"),
     random weights on the card: h2o-danube-1.8b and mamba2-780m, each 5
     ``make_train_step`` steps (``launch/train.py``'s schedule, lr 3e-4) on one
     repeated 4 x 2048 ``synth_batch``, the counts zeroed before each step and
     read after it (``kernel_calls_per_step``: 48 ``flash_attention`` and 96
     ``ssd_chunk`` launches a step, the forward run twice), every gradient of
     the first step finite and not identically zero, finite losses and grad
     norms, the last loss below the first (cold and warm ms per step,
     tokens/s, the forward alone (median of 3), the optimizer by CUDA events,
     the backward by difference, peak device memory, the loss and grad-norm
     history); one
     step under torch.profiler (the kernel's, the matmuls' and the rest's
     shares, the idle share) and one with every kernel call held against its
     plain version; then each model cut to 2 layers in float32, one step on the
     card and on the CPU from the same weights (loss, every gradient against
     its leaf's largest |g| and every fp32 master within 1e-3 + 1e-3·|CPU|),
     the card's state through a ``CheckpointManager`` save / restore bit for
     bit; and ``launch/train.py``'s ``main`` on the card (reduced mamba2-780m,
     a checkpoint, ``--resume``);
  mesh: the mesh layer (``repro_torch.distributed``, ``dataplane/decode_attn``,
     ``train/{grad_sync,pipeline}``, the "a2a" MoE dispatch) on a virtual mesh
     held on the card, each mesh axis a leading tensor dim: deepseek-moe-16b at
     published width and depth in bf16, random weights on the card, served
     through "a2a" on a (data 1, model 16) mesh (a cold and a warm prefill of
     2 x 2048 ``synth_batch`` tokens, 16 greedy steps; 28 ``flash_attention``
     launches per prefill at D = 128, one capacity pack per MoE layer, the
     dropped share of (token, k) entries at cf 1.25, peak memory, a checked
     prefill, the same warm prefill through "loop"); the same model cut to 2
     layers in float32, card against CPU through "a2a" at cf 1.25 (routing
     replayed) and both against "loop" at a dropless cf, within 1e-3 +
     1e-3·|CPU|; split-KV decode at h2o-danube-1.8b's decode widths against
     its single-device oracle within a bf16 rounding limit; the hierarchical
     mean over mamba2-780m's parameter shapes x 4 distinct float32 replicas
     on (pod 2, data 2) against a plain mean, timed against its bytes bound;
     GPipe over h2o-danube-1.8b's 24 layers as 4 stages x 6, 4 microbatches of
     1 x 2048, against the serial forward (bit-equal or the bf16 limit, logged);
     and deepseek-moe-16b's bytes per device under ``param_pspecs`` on both
     production meshes (host arithmetic);
  dryrun: the dry run (``launch/dryrun.py``, ``analysis/{roofline,probes,cost}``):
     ``main`` over all 10 archs x 4 shapes x both production meshes, one process
     per arch started together, each cell counted on meta tensors on the host
     (68 ok, the 12 long_500k skips; one line per cell with its terms on the
     H100 and its bottleneck; the wall time against a 180 s budget); then
     ``CostCounter`` on the card: a warm h2o-danube-1.8b prefill and a warm
     mamba2-780m train step at full width and depth (4 x 2048 ``synth_batch``,
     bf16), each counted twice on CUDA tensors and once on meta stand-ins,
     FLOPs, bytes and kernel units equal, 24 ``flash_attention`` / 96
     ``ssd_chunk`` launches in each counted run, the warm ms beside the H100
     bound of the count;
  then the ``kernels`` JSON line (seven rows).  Phases 3-5 give the join
  kernels' launch counts, on a session that does not verify (the service's
  default), the serve phase those of ``flash_attention`` and ``ssd_chunk``
  (their main path: the two serving runs), and their rows are timed at the
  serve path's inputs; the train phase adds to those two rows its launches
  (``train_launches``, ``train_launches_per_step``) and the checked step's
  largest |err| (``train_max_abs_err``), the mesh phase its deepseek serving
  run's ``flash_attention`` launches (``mesh_launches``), the dryrun phase its
  counted runs' (``dryrun_launches``); ``hash_partition``'s row is phase 7's;
  ``blake2b_chunks``'s is the digest phase's timing with the launches of
  phases 3-5, whose submits digest their tables on the card.
  Patterns, service, verify, simulator and general run after phases 3-5
  (phase 6 and 7 follow, then serve, train, mesh and dryrun).

The last line of standard output is ``{"ok": true, "device": {...}}``.

Run from the repository root:  ``python3 chip_smoke.py``  (needs one CUDA
card and nvcc; exits with code 2 when CUDA is unavailable).
``--profile`` adds two warm submits of phase 3's query after phase 5, one
under cProfile (host time by function) and one under torch.profiler
(device time by kernel, and the device's busy share of the wall clock).
"""

from __future__ import annotations

import argparse
import copy
import importlib
import json
import math
import os
import re
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32 outside the tensor cores (data sheet)
TF32_FLOP_PER_S = 495e12           # H100 SXM dense TF32 tensor cores (data sheet)
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores (data sheet)
INT32_MAX = 2**31 - 1

KERNELS = {
    # name: (kernel source, TPU kernel it replaces)
    "hash_partition_pack": ("src/repro_torch/kernels/csrc/hash_partition.cu",
                            "src/repro/kernels/hash_partition.py:61"),
    "merge_join_counts": ("src/repro_torch/kernels/csrc/merge_join.cu",
                          "src/repro/kernels/merge_join.py:112"),
    "merge_join_pairs": ("src/repro_torch/kernels/csrc/merge_join.cu",
                         "src/repro/kernels/merge_join.py:74"),
    "hash_partition": ("src/repro_torch/kernels/csrc/hash_partition.cu",
                       "src/repro/kernels/hash_partition.py:100"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:73"),
    "ssd_chunk": ("src/repro_torch/kernels/csrc/ssd.cu", "src/repro/kernels/ssd.py:62"),
    # added for the service's table digest: it replaces no TPU kernel
    "blake2b_chunks": ("src/repro_torch/kernels/csrc/digest.cu", None),
}
JOIN_KERNELS = ("hash_partition_pack", "merge_join_counts", "merge_join_pairs")
# the kernels redesigned for Hopper, by source stem: phase 1 logs their
# registers, shared memory and spills
REDESIGNED = {"flash_attention": ["flash_fwd_tc"], "merge_join": ["mj_counts", "mj_pairs"],
              "hash_partition": ["hp_pack", "hp_partition_hist"],
              "ssd": ["ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan"],
              "digest": ["blake2b_chunks"]}
# the kernels whose products run on the tensor cores, by source stem: phase 1
# fails unless the SASS of each holds HMMA or HGMMA instructions
TENSOR_CORE = {"flash_attention": ("flash_fwd_tc",),
               "ssd": ("ssd_chunk_state", "ssd_chunk_scan")}
LIBRARY_KERNELS = ("hash_partition", "flash_attention", "ssd_chunk")
# phase 7's widths: h2o-danube-1.8b prefill (src/repro/configs/h2o_danube_1_8b.py;
# its 4096-token window equals full causal attention at 4096 tokens),
# mamba2-780m (src/repro/configs/mamba2_780m.py: d_inner 3072 = 48 heads of
# 64, d_state 128, chunk 256), and the triangle-2M table size
ATTN_WIDTHS = dict(batch=2, heads=32, kv_heads=8, seq=4096, head_dim=80)
# a second width for bf16 attention, whose tile shapes depend on D:
# deepseek-moe-16b (src/repro/configs/deepseek_moe_16b.py: 16 heads, MHA,
# head_dim 128), one causal prefill of 4096 tokens, batch 2
ATTN_WIDTHS_2 = dict(batch=2, heads=16, seq=4096, head_dim=128, model="deepseek-moe-16b")
# a third: gemma3-12b (src/repro/configs/gemma3_12b.py: 16 heads, head_dim
# 256; its KV heads expanded), one causal prefill of 4096 tokens, batch 2
ATTN_WIDTHS_3 = dict(batch=2, heads=16, seq=4096, head_dim=256, model="gemma3-12b")
SSD_WIDTHS = dict(batch=4, heads=48, seq=4096, chunk=256, headdim=64, d_state=128)
HASH_KEYS, HASH_PARTS = 2_000_000, 64
HASH_KEYS_AT_SCALE = 1 << 26       # past the 50 MB L2
# the digest phase's table: SSB SF1's lineorder, 6,001,215 rows of 4 int64
# keys (192 MB), the largest table a benchmark submit digests
DIGEST_ROWS = (6_001_215, 4)
# blake2b_chunks' compute bound: ~2.7k 32-bit integer instructions per
# 128-byte BLAKE2b block, on 64 INT32 lanes per SM × 132 SMs at the H100
# SXM's 1.98 GHz boost clock (data sheet)
DIGEST_INSTR_PER_BLOCK = 2700
INT32_LANES_PER_S = 64 * 132 * 1.98e9
# the table sizes at which the digest phase times both paths, for the
# crossover that sets core/query.py's CARD_DIGEST_MIN_BYTES
DIGEST_SWEEP_BYTES = tuple(1 << k for k in range(14, 27))     # 16 KiB .. 64 MiB


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Data: Zipf graphs (a copy of the reference generator), orientation, oracle
# ---------------------------------------------------------------------------


def normalize_edges(edges: np.ndarray, n_vertices: int) -> np.ndarray:
    """u < v per row, duplicates and self-loops dropped (sorted rows)."""
    arr = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    arr = arr[arr[:, 0] != arr[:, 1]]
    lo = np.minimum(arr[:, 0], arr[:, 1])
    hi = np.maximum(arr[:, 0], arr[:, 1])
    return np.unique(np.stack([lo, hi], axis=1), axis=0)


def zipf_graph(rng: np.random.Generator, n_vertices: int, n_edges: int,
               skew: float) -> np.ndarray:
    """Power-law graph: both endpoints drawn with probability ~ rank^-skew;
    up to 64 rounds of top-up, then a uniform subset of ``n_edges`` rows."""
    ranks = np.arange(1, n_vertices + 1, dtype=np.float64)
    probs = ranks ** (-max(0.0, skew))
    probs /= probs.sum()
    edges = np.zeros((0, 2), np.int64)
    for _ in range(64):
        need = n_edges - edges.shape[0]
        if need <= 0:
            break
        u = rng.choice(n_vertices, size=2 * need, p=probs)
        v = rng.choice(n_vertices, size=2 * need, p=probs)
        edges = normalize_edges(np.concatenate([edges, np.stack([u, v], axis=1)]),
                                n_vertices)
    if edges.shape[0] > n_edges:
        keep = rng.permutation(edges.shape[0])[:n_edges]
        edges = edges[np.sort(keep)]
    return edges


def orient_by_degree(edges: np.ndarray, n_vertices: int) -> np.ndarray:
    """Each edge (u, v) kept once, pointing from the lower to the higher
    (degree, id) rank: every triangle then matches R(A,B) S(B,C) T(A,C) once."""
    deg = np.bincount(edges.reshape(-1), minlength=n_vertices)
    order = np.lexsort((np.arange(n_vertices), deg))
    rank = np.empty(n_vertices, np.int64)
    rank[order] = np.arange(n_vertices)
    swap = rank[edges[:, 0]] > rank[edges[:, 1]]
    lo = np.where(swap, edges[:, 1], edges[:, 0])
    hi = np.where(swap, edges[:, 0], edges[:, 1])
    return np.unique(np.stack([lo, hi], axis=1), axis=0)


def triangle_oracle(oriented: np.ndarray, n_vertices: int) -> tuple:
    """(triangles, oriented 2-paths) by scipy sparse products, independent of
    the join engine: sum((L @ L) * L) over the oriented adjacency L."""
    import scipy.sparse as sp

    ones = np.ones(oriented.shape[0], np.int64)
    lmat = sp.csr_matrix((ones, (oriented[:, 0], oriented[:, 1])),
                         shape=(n_vertices, n_vertices))
    paths = lmat @ lmat
    return int(paths.multiply(lmat).sum()), int(paths.sum())


def triangle_query(oriented: np.ndarray):
    from repro_torch.core.query import query_from_arrays

    return query_from_arrays([
        (("A", "B"), oriented, "E"),
        (("B", "C"), oriented, "E"),
        (("A", "C"), oriented, "E"),
    ])


def parity_queries():
    """The row-order parity cases of tests/test_torch_executor.py:
    (name, query, lambda, fused)."""
    from repro_torch.core.query import disconnected_query, hub_star_query, random_query

    return [
        ("triangle-zipf", random_query(np.random.default_rng(2), "clique", 3,
                                       tuples_per_rel=200, dom_size=30, skew=2.0), 16, False),
        ("four-cycle", random_query(np.random.default_rng(7), "cycle", 4,
                                    tuples_per_rel=120, dom_size=10, skew=2.5), 24, False),
        ("hub-star", hub_star_query(n=48, hub_n=24, dom_size=25), 10, False),
        ("disconnected", disconnected_query(90, dom_size=12, skew=1.8), 8, False),
        ("fused-star", random_query(np.random.default_rng(4), "star", 4,
                                    tuples_per_rel=150, dom_size=12, skew=1.5), 3, True),
    ]


# ---------------------------------------------------------------------------
# Kernel bookkeeping
# ---------------------------------------------------------------------------


def kernel_modules():
    """The join kernels' wrapper modules (by module path: the package
    exports the op ``hash_partition`` under its module's name)."""
    return (importlib.import_module("repro_torch.kernels.hash_partition"),
            importlib.import_module("repro_torch.kernels.merge_join"))


def launch_counts(names) -> dict:
    from repro_torch.kernels import _build

    return {name: _build.launches[name] for name in names}


def reset_counts() -> None:
    from repro_torch.kernels import _build

    _build.launches.clear()


def wrapped_kernels(names):
    """(module, wrapper attribute, kernel name) of each kernel named."""
    hp, mj = kernel_modules()
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    ssd = importlib.import_module("repro_torch.kernels.ssd")
    table = {"hash_partition_pack": (hp, "hash_partition_pack_cuda"),
             "merge_join_counts": (mj, "merge_join_counts_cuda"),
             "merge_join_pairs": (mj, "merge_join_pairs_cuda"),
             "flash_attention": (fa, "flash_attention_cuda"),
             "ssd_chunk": (ssd, "ssd_chunk_cuda")}
    return [table[name] + (name,) for name in names]


class InputCapture:
    """Keeps a copy of the largest inputs each kernel wrapper was called with
    (by element count), so phase 6 times the kernels at main-path shapes.

    With ``check=True`` it keeps no copies and instead holds every call's
    result against the kernel's plain version on the same inputs (the join
    kernels bit for bit; ``flash_attention`` by ``attention_close``, 1e-4 +
    1e-4·|plain| in float32 and the bf16 rounding limit in bfloat16;
    ``ssd_chunk`` by ``ssd_close``, 1e-4 of the plain version's largest
    magnitude; raises on the first difference), counting the calls it checked,
    the largest |Δ| of the float kernels (``max_err``) and, for
    merge_join_counts, the probe keys that matched nothing (the non-members a
    semijoin must drop).  ``kernels`` names the wrappers it takes over (the
    join kernels by default)."""

    def __init__(self, check: bool = False, kernels=JOIN_KERNELS):
        self.check, self.kernels = check, tuple(kernels)
        self.best, self.checked, self.largest, self.max_err = {}, {}, {}, {}
        self.unmatched = 0
        self._restore = []

    def _check_float(self, torch, name, got, args) -> float:
        from repro_torch.kernels import ref

        if name == "flash_attention":
            q, k, v, causal = args
            return attention_close(torch, got, q, k, v, bool(causal))["max_abs_err"]
        return ssd_close(torch, got, ref.ssd_chunked_ref(*args))

    def install(self):
        import torch
        from repro_torch.kernels import ref

        for mod, attr, name in wrapped_kernels(self.kernels):
            orig = getattr(mod, attr)
            plain = getattr(ref, f"{name}_ref", None)

            def rec(*args, _orig=orig, _plain=plain, _name=name):
                size = sum(a.numel() for a in args if hasattr(a, "numel"))
                if not self.check:
                    if self.best.get(_name, (-1,))[0] < size:
                        self.best[_name] = (size, [a.clone() if hasattr(a, "clone") else a
                                                   for a in args])
                    return _orig(*args)
                got = _orig(*args)
                if _name in LIBRARY_KERNELS:
                    err = self._check_float(torch, _name, got, args)
                    self.max_err[_name] = max(self.max_err.get(_name, 0.0), err)
                else:
                    for g, w in zip(got, _plain(*args)):
                        if g.shape != w.shape or not torch.equal(g.to(torch.int64),
                                                                 w.to(torch.int64)):
                            raise AssertionError(
                                f"{_name}: kernel differs from its plain version "
                                f"at {[tuple(a.shape) for a in args[:2]]}")
                self.checked[_name] = self.checked.get(_name, 0) + 1
                if size > self.largest.get(_name, (-1,))[0]:
                    self.largest[_name] = (size, [tuple(a.shape) for a in args[:2]])
                if _name == "merge_join_counts":
                    lower, upper = got
                    self.unmatched += int(((lower == upper) & (args[0] != INT32_MAX)).sum())
                return got

            setattr(mod, attr, rec)
            self._restore.append((mod, attr, orig))

    def remove(self):
        for mod, attr, orig in reversed(self._restore):
            setattr(mod, attr, orig)
        self._restore = []

    def __enter__(self):
        self.install()
        return self

    def __exit__(self, *exc):
        self.remove()
        return False


def time_rounds(torch, kern, plain, library):
    """Five rounds of ``cuda_ms`` (10 calls; the plain version 3), alternating
    which of kernel / plain / library runs first → (medians by name, the
    rounds' ranges as text).  ``plain`` or ``library`` may be None."""
    fns = {"kernel": (kern, 10)}
    if plain is not None:
        fns["plain"] = (plain, 3)
    if library is not None:
        fns["library"] = (library, 10)
    times = {k: [] for k in fns}
    for r in range(5):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            fn, n = fns[k]
            times[k].append(cuda_ms(torch, fn, reps=n))
    med = {k: float(np.median(v)) for k, v in times.items()}
    spread = ", ".join(f"{k} {min(v):.4f}-{max(v):.4f}" for k, v in times.items())
    return med, spread


def device_ms(torch, fn, reps: int = 10) -> tuple:
    """(device ms per call, device operations per call, their names): the
    kernels and memsets that torch.profiler records over ``reps`` calls,
    after one warm-up call.  Unlike ``cuda_ms`` it leaves out the host's
    enqueue time and the gaps between calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    n_ops = sum(e.count for e in events)
    return busy_us / reps / 1e3, n_ops / reps, sorted({e.key[:40] for e in events})


def cuda_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after two warm-up calls)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_env(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[env] nvidia-smi: {smi}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from repro_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"[env] nvcc: {nvcc[-1] if nvcc else '?'}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[env] kernels built in {build_s:.2f} s ({', '.join(sorted(logs))})")
    for stem, text in sorted(logs.items()):
        entries = ptxas_entries(text)
        for name, info in entries.items():
            log(f"[build] {stem}: {name}: {info}")
        # the redesigned kernels must show their registers, shared memory
        # and spills (a library that was already built has no log)
        for want in REDESIGNED.get(stem, []) if text else []:
            if not any(want in name for name in entries):
                raise AssertionError(f"{stem}: no ptxas report for {want}")
    check_tensor_core_sass(_build)
    return {"smi": smi, "build_s": build_s}


def demangle(names):
    """C++ kernel names, demangled by c++filt where the machine has it and
    cut to the function and its template arguments (``flash_fwd_tc<80>``)."""
    import shutil

    if not names or shutil.which("c++filt") is None:
        return list(names)
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    if len(out) != len(names):
        return list(names)
    return [n.replace("(anonymous namespace)::", "").split("(")[0].split(" ")[-1] for n in out]


def ptxas_entries(text: str) -> dict:
    """``nvcc -Xptxas -v`` output → {kernel: "R registers, S bytes static
    smem, spill stores/loads"} in the order ptxas reports them."""
    import re

    found, name = {}, None
    for line in text.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name = hit.group(1)
            found[name] = {}
            continue
        if name is None:
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if hit:
            found[name]["spills"] = f"spill stores {hit.group(1)} B, loads {hit.group(2)} B"
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            smem = re.search(r"(\d+) bytes smem", line)
            found[name]["regs"] = (f"{hit.group(1)} registers, "
                                   f"{smem.group(1) if smem else 0} B static smem")
    names = demangle(list(found))
    return {pretty: ", ".join(v for v in (found[raw].get("regs"), found[raw].get("spills")) if v)
            for raw, pretty in zip(found, names)}


def check_tensor_core_sass(build) -> None:
    """The kernels of ``TENSOR_CORE`` run on the tensor cores: their SASS (by
    ``cuobjdump -sass``, beside nvcc) holds HMMA or HGMMA instructions.
    Raises if a ``flash_fwd_tc`` instance (one per head dim) or one of the
    ssd_chunk product kernels has neither."""
    import re

    from repro_torch.kernels.flash_attention import HEAD_DIMS

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    for stem, wants in TENSOR_CORE.items():
        sass = subprocess.run([str(tool), "-sass", str(build._lib_path(stem))],
                              capture_output=True, text=True, check=True).stdout
        funcs = re.split(r"\n\s*Function : ", sass)[1:]
        names = demangle([f.split("\n", 1)[0].strip() for f in funcs])
        counts = {}
        for name, body in zip(names, funcs):
            counts[name] = {op: len(re.findall(rf"\b{op}\.", body)) for op in ("HMMA", "HGMMA")}
            log(f"[build] SASS {name}: {counts[name]['HMMA']} HMMA, "
                f"{counts[name]['HGMMA']} HGMMA")
        for want in wants:
            tc = {n: c for n, c in counts.items() if want in n}
            instances = len(HEAD_DIMS) if want == "flash_fwd_tc" else 1
            if len(tc) != instances or any(c["HMMA"] + c["HGMMA"] == 0 for c in tc.values()):
                raise AssertionError(f"{want}: tensor-core instructions missing in its SASS: {tc}")


def _sorted_rows(rng, s, n, dom, fill, sentinel_rows=()):
    """(s, n) int32 rows: each a sorted draw from [0, dom) with the last
    ``n - fill[i]`` entries set to the INT32_MAX sentinel."""
    x = np.sort(rng.integers(0, dom, (s, n)), axis=1).astype(np.int64)
    for i in range(s):
        x[i, fill[i]:] = INT32_MAX
    for i in sentinel_rows:
        x[i] = INT32_MAX
    return x.astype(np.int32)


def merge_join_hazards(rng):
    """(name, a, b) int32 sorted rows at the merge-path search's hazards:
    runs of one key far longer than a block's stretch of the merge (2816
    elements), N = 1 and M = 1 against 2^20, rows of sentinels only, keys
    at -2^31 and 2^31 - 1."""
    edge = np.array([-(2**31), -(2**31) + 1, INT32_MAX - 1, INT32_MAX])
    srt = lambda x: np.sort(x, axis=1).astype(np.int32)
    a_sent = srt(rng.integers(0, 50, (4, 3000)))
    b_sent = srt(rng.integers(0, 50, (4, 5000)))
    a_sent[:3] = INT32_MAX          # rows 0-1 both sides, row 2 A, row 3 B all sentinels
    b_sent[:2] = INT32_MAX
    b_sent[3] = INT32_MAX
    return [
        ("3-key runs", srt(rng.integers(-1, 4, (64, 4096))),
         srt(rng.integers(0, 3, (64, 1 << 20)))),
        ("N=1", srt(rng.integers(0, 1000, (8, 1))), srt(rng.integers(0, 1000, (8, 1 << 20)))),
        ("M=1", srt(rng.integers(0, 1000, (8, 1 << 20))), srt(rng.integers(0, 1000, (8, 1)))),
        ("all-sentinel rows", a_sent, b_sent),
        ("keys at +-2^31", srt(rng.choice(edge, (16, 5000))), srt(rng.choice(edge, (16, 7000)))),
    ]


def pairs_from_counts(rng, counts: np.ndarray):
    """(lower, starts) int32 for per-key match counts (S, N): starts the
    exclusive prefix sum, lower nondecreasing as a probe of sorted B gives."""
    starts = np.cumsum(counts, axis=1) - counts
    lower = np.cumsum(rng.integers(0, 3, counts.shape), axis=1) + starts
    return lower.astype(np.int32), starts.astype(np.int32)


def merge_join_pairs_hazards(rng):
    """(name, lower, starts, cap_out) at the load-balancing search's hazards:
    the main path's regime (90% zero-count keys, a 35% zero-count tail,
    total < cap_out so slots alias the last key), total > cap_out (keys past
    the last slot), one key owning all cap_out slots across many 2816-element
    stretches, runs of equal starts longer than a stretch, N = 1, cap_out =
    1, cap_out not a multiple of the stretch, S = 4096 with small N."""
    def regime(s, n):
        c = np.where(rng.random((s, n)) < 0.1, rng.geometric(0.7, (s, n)), 0)
        c[:, int(0.65 * n):] = 0
        return c

    main = regime(64, 1 << 16)
    over = rng.integers(0, 6, (16, 20000))
    hub = np.zeros((8, 5000), np.int64)
    hub[:, 1234] = 1 << 20
    runs = np.zeros((16, 30000), np.int64)
    runs[:, ::3001] = 5
    return [
        ("main-path regime", *pairs_from_counts(rng, main),
         int(1.6 * main.sum(axis=1).max())),
        ("total > cap_out", *pairs_from_counts(rng, over), int(over.sum(axis=1).min()) // 3),
        ("hub key owns all slots", *pairs_from_counts(rng, hub), 1 << 20),
        ("equal-start runs across stretches", *pairs_from_counts(rng, runs), 60),
        ("N=1", *pairs_from_counts(rng, rng.integers(0, 9, (8, 1))), 1000),
        ("cap_out=1", *pairs_from_counts(rng, rng.integers(0, 3, (8, 5000))), 1),
        ("cap_out off the stretch", *pairs_from_counts(rng, regime(16, 40000)), 3 * 2816 + 17),
        ("S=4096 small N", *pairs_from_counts(rng, rng.integers(0, 4, (4096, 16))), 64),
    ]


def hash_partition_pack_hazards(rng):
    """(name, keys, counts, P) at the look-back's hazards: 1024 tiles of
    look-back (N = 2^20) with every key in one partition and with 64
    partitions, N off a multiple of 1024 and N = 1, counts of 0 and N in one
    batch, P = 1 and the largest P of the single-block kernel, one tile per
    segment over 4096 segments; then the wide kernel's first P, and P = 384,
    1024 (single block, past the old limit of 383) and 4096 (wide)."""
    from repro_torch.kernels.hash_partition import MAX_SMEM_PARTS as p_max

    keys = lambda s, n: rng.integers(-(2**31), 2**31, (s, n)).astype(np.int32)
    full = lambda s, n: np.full(s, n, np.int32)
    mixed = lambda s, n: np.array([0, n] * (s // 2), np.int32)
    return [
        ("N=2^20 one partition", np.full((8, 1 << 20), 12345, np.int32), full(8, 1 << 20), 64),
        ("N=2^20 64 partitions", keys(8, 1 << 20), rng.integers(0, (1 << 20) + 1, 8)
         .astype(np.int32), 64),
        ("N off 1024", keys(6, 5003), mixed(6, 5003), 16),
        ("N=1", keys(4, 1), mixed(4, 1), 5),
        ("counts 0 and N", keys(8, 4096), mixed(8, 4096), 64),
        ("P=1", keys(4, 3000), full(4, 3000), 1),
        (f"P={p_max}", keys(4, 9000), rng.integers(0, 9001, 4).astype(np.int32), p_max),
        ("S=4096 one tile", keys(4096, 1024), rng.integers(0, 1025, 4096).astype(np.int32), 64),
        (f"P={p_max + 1} (wide)", keys(4, 9000), rng.integers(0, 9001, 4).astype(np.int32),
         p_max + 1),
        ("P=384", keys(8, 5000), rng.integers(0, 5001, 8).astype(np.int32), 384),
        ("P=1024", keys(8, 5000), rng.integers(0, 5001, 8).astype(np.int32), 1024),
        ("P=4096 (wide)", keys(8, 5000), rng.integers(0, 5001, 8).astype(np.int32), 4096),
        ("P=4096 N=2^20 (wide)", keys(4, 1 << 20), rng.integers(0, (1 << 20) + 1, 4)
         .astype(np.int32), 4096),
    ]


def wall_ms(torch, fn, reps: int = 5) -> float:
    """Median host-clock ms of ``fn`` over ``reps`` calls, each ended by a
    synchronise, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_digest(torch, dev) -> dict:
    """The table digest of a lineorder-shaped table (``DIGEST_ROWS``) on the
    card and on the host: both paths' digests equal; the card path's wall
    time beside the host path's, and beside the table's bytes over the
    page-locked host-to-card rate measured here; the ``blake2b_chunks``
    kernel alone on the resident table, checked against ``hashlib`` and
    timed beside its instruction and byte bounds and its plain version; and
    both paths' times over ``DIGEST_SWEEP_BYTES``, where the card's fixed
    cost meets the host's hash (one log line each).  Returns the kernel's
    row of the ``kernels`` line, its ``launches`` left for phases 3-5."""
    from functools import partial

    from repro_torch.core.query import host_chunk_digests, table_digest
    from repro_torch.kernels import ops
    from repro_torch.kernels.digest import (CARD_DIGEST_MIN_BYTES, CHUNK, SLICE,
                                            blake2b_chunks_cuda, chunk_digests,
                                            stream_chunk_digests)

    a = np.random.default_rng(33).integers(0, 2**31, DIGEST_ROWS)
    u8 = a.reshape(-1).view(np.uint8)
    n = u8.nbytes
    on_card = partial(chunk_digests, device=dev)
    if table_digest(a, on_card) != table_digest(a):
        raise AssertionError("digest: the card path differs from the host path")
    host_ms = wall_ms(torch, lambda: table_digest(a), reps=3)
    card_ms = wall_ms(torch, lambda: table_digest(a, on_card))
    # the page-locked host-to-card rate, one slice at a time (CUDA events)
    pinned = torch.empty(SLICE, dtype=torch.uint8, pin_memory=True)
    slice_dev = torch.empty(SLICE, dtype=torch.uint8, device=dev)
    copy_ms = cuda_ms(torch, lambda: slice_dev.copy_(pinned, non_blocking=True))
    rate = SLICE / copy_ms * 1e3
    m = min(SLICE, n)
    stage_ms = wall_ms(torch, lambda: pinned[:m].copy_(torch.from_numpy(u8[:m])))
    del pinned, slice_dev
    log(f"[digest] table {DIGEST_ROWS[0]:,} x {DIGEST_ROWS[1]} int64 ({n:,} B): card path "
        f"{card_ms:.2f} ms, host path {host_ms:.2f} ms ({host_ms / card_ms:.1f}x), equal digests; "
        f"its bytes over the page-locked host-to-card rate {rate / 1e9:.2f} GB/s (one {SLICE:,} B "
        f"slice, CUDA events): {n / rate * 1e3:.2f} ms; the host's copy into page-locked memory "
        f"{m / stage_ms * 1e3 / 1e9:.2f} GB/s ({n / m * stage_ms:.2f} ms for the table)")

    x = torch.from_numpy(u8).to(dev)
    got = ops.blake2b_chunks(x)
    torch.cuda.synchronize()
    plain_t0 = time.perf_counter()
    want = host_chunk_digests(u8)
    plain_ms = (time.perf_counter() - plain_t0) * 1e3
    if got.cpu().numpy().tobytes() != want:
        raise AssertionError("blake2b_chunks: a chunk digest differs from hashlib's")
    reset_counts()
    # CUDA events only: torch.profiler's device events come and go on the
    # H100 (whole sessions of this script have read no device time)
    med, spread = time_rounds(torch, lambda: blake2b_chunks_cuda(x, got), None, None)
    blocks = sum(-(-min(CHUNK, n - i) // 128) for i in range(0, n, CHUNK))
    instr_ms = blocks * DIGEST_INSTR_PER_BLOCK / INT32_LANES_PER_S * 1e3
    bytes_ms = (n + 32 * len(got)) / HBM_BYTES_PER_S * 1e3
    log(f"[digest] blake2b_chunks on the resident table ({len(got):,} chunks of {CHUNK} B, "
        f"{blocks:,} blocks): kernel {med['kernel']:.4f} ms; bound {max(instr_ms, bytes_ms):.4f} "
        f"ms (instructions {instr_ms:.4f}, bytes {bytes_ms:.4f}), "
        f"{max(instr_ms, bytes_ms) / med['kernel']:.3f} of it; "
        f"plain version (hashlib on the host) {plain_ms:.2f} ms; equal to hashlib; "
        f"launches in this timing {launch_counts(['blake2b_chunks'])}; medians of 5 rounds, "
        f"range ms: {spread}")
    del x, got
    torch.cuda.empty_cache()

    sweep = []
    for size in DIGEST_SWEEP_BYTES:
        part = u8[:size]
        sweep.append((size, wall_ms(torch, lambda: host_chunk_digests(part)),
                      wall_ms(torch, lambda: stream_chunk_digests(part, dev))))
    log("[digest] host / card ms by table bytes (the chunk digests alone; the constant "
        f"CARD_DIGEST_MIN_BYTES is {CARD_DIGEST_MIN_BYTES:,}): "
        + ", ".join(f"{s:,}: {h:.3f} / {c:.3f}" for s, h, c in sweep))
    source, replaces = KERNELS["blake2b_chunks"]
    return {"name": "blake2b_chunks", "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": 0, "ms": med["kernel"], "plain_ms": plain_ms,
            "bound_ms": max(instr_ms, bytes_ms),
            "bound_by": "operations" if instr_ms > bytes_ms else "bytes", "library_ms": None}


def phase_kernels(torch, dev) -> None:
    from repro_torch.kernels import ref

    hp, mj = kernel_modules()

    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def same(name, got, want):
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g.to(torch.int64), w.to(torch.int64)):
                raise AssertionError(f"{name}: kernel differs from its plain version")

    # hash_partition_pack: (S, N, P, key domain)
    for s, n, parts, dom in [(4096, 1024, 64, 2**31), (64, 1 << 14, 64, 1000),
                             (64, 1 << 20, 64, 2**31), (64, 1 << 20, 8, 50),
                             (8, 1000, 8, 2**31), (5, 3001, 1, 7), (3, 1, 1, 2**31),
                             (16, 65536, 64, 3)]:
        lo = -(2**31) if dom == 2**31 else 0
        keys = rng.integers(lo, dom if dom != 2**31 else 2**31, (s, n)).astype(np.int32)
        if s > 2:
            keys[0, : min(n, 4)] = [INT32_MAX, -(2**31), INT32_MAX - 1, -(2**31) + 1][: min(n, 4)]
        counts = rng.integers(0, n + 1, s).astype(np.int32)
        counts[0], counts[-1] = n, 0
        k, c = t(keys), t(counts)
        got = hp.hash_partition_pack_cuda(k, c, parts)
        torch.cuda.synchronize()
        same(f"hash_partition_pack S={s} N={n} P={parts}", got,
             ref.hash_partition_pack_ref(k, c, parts))
        log(f"[kernels] hash_partition_pack S={s} N={n} P={parts} dom={dom}: equal")

    # merge_join_counts: (S, N, M, key domain), ragged fills, sentinel rows
    for s, n, m, dom in [(4096, 1024, 1024, 50), (64, 1 << 16, 1 << 16, 1 << 20),
                         (64, 1 << 20, 1 << 20, 5000), (7, 300, 1500, 40),
                         (5, 1, 999, 3), (3, 257, 1, 10), (64, 4096, 256, 2)]:
        fa = rng.integers(0, n + 1, s)
        fb = rng.integers(0, m + 1, s)
        fa[0], fb[0] = n, m
        a = t(_sorted_rows(rng, s, n, dom, fa, sentinel_rows=(s - 1,)))
        b = t(_sorted_rows(rng, s, m, dom, fb, sentinel_rows=(s // 2,)))
        got = mj.merge_join_counts_cuda(a, b)
        torch.cuda.synchronize()
        same(f"merge_join_counts S={s} N={n} M={m}", got, ref.merge_join_counts_ref(a, b))
        log(f"[kernels] merge_join_counts S={s} N={n} M={m} dom={dom}: equal")
    for name, a, b in merge_join_hazards(rng):
        a, b = t(a), t(b)
        got = mj.merge_join_counts_cuda(a, b)
        torch.cuda.synchronize()
        same(f"merge_join_counts {name}", got, ref.merge_join_counts_ref(a, b))
        log(f"[kernels] merge_join_counts {name} S={a.shape[0]} N={a.shape[1]} "
            f"M={b.shape[1]}: equal")

    # merge_join_pairs: (S, N, M, domain, cap_out) from real match ranges
    for s, n, m, dom, cap in [(4096, 256, 256, 20, 1024), (64, 1 << 14, 1 << 14, 2000, 1 << 18),
                              (64, 1 << 16, 1 << 16, 1 << 12, 1 << 20), (7, 300, 1500, 40, 4000),
                              (5, 1, 7, 3, 64), (3, 1000, 1000, 5, 100)]:
        fa = rng.integers(0, n + 1, s)
        fb = rng.integers(0, m + 1, s)
        fa[0], fb[0] = n, m
        a = t(_sorted_rows(rng, s, n, dom, fa, sentinel_rows=(s - 1,)))
        b = t(_sorted_rows(rng, s, m, dom, fb))
        lower, upper = ref.merge_join_counts_ref(a, b)
        cnt = torch.where(a < INT32_MAX, upper - lower, torch.zeros_like(lower)).to(torch.int64)
        starts = (torch.cumsum(cnt, dim=1) - cnt).to(torch.int32)
        got = mj.merge_join_pairs_cuda(lower, starts, cap)
        torch.cuda.synchronize()
        same(f"merge_join_pairs S={s} N={n} cap={cap}", got,
             ref.merge_join_pairs_ref(lower, starts, cap))
        log(f"[kernels] merge_join_pairs S={s} N={n} cap={cap} total_max="
            f"{int(cnt.sum(dim=1).max())}: equal")
    for name, lower, starts, cap in merge_join_pairs_hazards(rng):
        lower, starts = t(lower), t(starts)
        got = mj.merge_join_pairs_cuda(lower, starts, cap)
        torch.cuda.synchronize()
        same(f"merge_join_pairs {name}", got, ref.merge_join_pairs_ref(lower, starts, cap))
        log(f"[kernels] merge_join_pairs {name} S={starts.shape[0]} N={starts.shape[1]} "
            f"cap={cap} last start max={int(starts[:, -1].max())}: equal")
    for name, keys, counts, parts in hash_partition_pack_hazards(rng):
        k, c = t(keys), t(counts)
        got = hp.hash_partition_pack_cuda(k, c, parts)
        torch.cuda.synchronize()
        same(f"hash_partition_pack {name}", got, ref.hash_partition_pack_ref(k, c, parts))
        log(f"[kernels] hash_partition_pack {name} S={keys.shape[0]} N={keys.shape[1]} "
            f"P={parts}: equal")


class OpPeaks:
    """Peak device memory of each op a ``DataplaneExecutor`` lowers: wraps
    the instance's lowering rules (``run_many`` looks them up by name) for
    the length of a ``with`` block."""

    def __init__(self, torch, executor):
        self.torch, self.executor, self.peaks = torch, executor, {}

    def __enter__(self):
        for op, name in type(self.executor)._LOWERING.items():
            rule = getattr(self.executor, name)

            def wrapped(*a, _rule=rule, _op=op.__name__):
                self.torch.cuda.synchronize()
                self.torch.cuda.reset_peak_memory_stats()
                try:
                    return _rule(*a)
                finally:
                    self.torch.cuda.synchronize()
                    peak = self.torch.cuda.max_memory_allocated()
                    self.peaks[_op] = max(self.peaks.get(_op, 0), peak)

            setattr(self.executor, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name in type(self.executor)._LOWERING.values():
            delattr(self.executor, name)
        return False


def op_peaks(torch, session, query, lam, tag: str) -> dict:
    """One more submit, untimed, under ``OpPeaks``: each op's peak device
    memory (the wrapping syncs the card around every op, so no timed submit
    runs under it)."""
    base = torch.cuda.memory_allocated()
    with OpPeaks(torch, session.executor) as peaks:
        session.submit(query, lam=lam)
    log(f"[{tag}] peak device GiB by op (untimed submit; {base / 2**30:.2f} GiB allocated "
        "before it): " + json.dumps({k: round(v / 2**30, 2) for k, v in peaks.peaks.items()}))
    return peaks.peaks


def run_submit(torch, session, query, lam, label: str) -> dict:
    """One submit with the figures the join phases log: wall s, the
    session's µs split, Σ round_us, the host share of ``execute_us`` outside
    the scheduler's rounds, retries, kernel launches and the submit's peak
    device memory (read once, after the timed window) beside what was
    allocated when it began."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = launch_counts(JOIN_KERNELS)
    t0 = time.perf_counter()
    res = session.submit(query, lam=lam)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    after = launch_counts(JOIN_KERNELS)
    r = res.result
    rounds_us = sum(r.round_us.values())
    info = {
        "label": label, "wall_s": wall, "count": res.count, "retries": res.retries,
        "plan_cache_hit": res.plan_cache_hit, "stats_us": res.stats_us,
        "compile_us": res.compile_us, "verify_us": res.verify_us,
        "execute_us": res.execute_us, "round_us_sum": rounds_us,
        "host_us": res.execute_us - rounds_us, "round_us": r.round_us,
        "spans_us": res.spans_us, "counters": res.counters, "dispatches": r.dispatches,
        "launches": {k: after[k] - before[k] for k in after},
        "peak_device_bytes": peak, "base_device_bytes": base,
        "stages": len(session._plans[res.plan_key].stages),
    }
    log(f"[{label}] {json.dumps(info, default=float)}")
    return {"res": res, **info}


def cold_warm(torch, session, query, lam, tag: str) -> tuple:
    """Cold then warm submit: warm is a plan-cache hit, retries nothing and
    returns the cold rows byte for byte."""
    cold = run_submit(torch, session, query, lam, f"{tag}/cold")
    warm = run_submit(torch, session, query, lam, f"{tag}/warm")
    if cold["plan_cache_hit"] or not warm["plan_cache_hit"]:
        raise AssertionError(f"{tag}: plan-cache hits cold "
                             f"{cold['plan_cache_hit']}, warm {warm['plan_cache_hit']}")
    if warm["retries"] != 0:
        raise AssertionError(f"{tag}: warm submit retried {warm['retries']} times")
    if not same_rows(cold["res"], warm["res"]):
        raise AssertionError(f"{tag}: warm rows differ from cold rows")
    return cold, warm


def phase_triangle(torch, session, n_vertices, n_edges, skew, seed, lam, tag) -> dict:
    t0 = time.perf_counter()
    edges = zipf_graph(np.random.default_rng(seed), n_vertices, n_edges, skew)
    oriented = orient_by_degree(edges, n_vertices)
    deg = np.bincount(edges.reshape(-1), minlength=n_vertices)
    want, paths = triangle_oracle(oriented, n_vertices)
    log(f"[{tag}] graph: {n_vertices} vertices, {oriented.shape[0]} edges, max degree "
        f"{int(deg.max())}, {paths} oriented 2-paths, {want} triangles (oracle); "
        f"host set-up {time.perf_counter() - t0:.1f} s")
    q = triangle_query(oriented)
    cold, warm = cold_warm(torch, session, q, lam, tag)
    if cold["count"] != want or warm["count"] != want:
        raise AssertionError(f"{tag}: counts {cold['count']}/{warm['count']} != oracle {want}")
    rounds = set(cold["res"].result.round_us)
    log(f"[{tag}] ok: {want} triangles; cold {cold['wall_s']:.3f} s, warm "
        f"{warm['wall_s']:.3f} s; rounds {sorted(rounds)}")
    return {"cold": cold, "warm": warm, "rounds": rounds, "query": q, "edges": edges,
            "n_vertices": n_vertices, "oriented": oriented, "oracle": want}


def phase_profile(torch, session, query, lam) -> None:
    """Where a warm submit's time goes: host functions (cProfile,
    cumulative) and device kernels (torch.profiler, self device time)."""
    import cProfile
    import io
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    session.submit(query, lam=lam)
    torch.cuda.synchronize()
    prof.disable()
    log(f"[profile] cProfile'd warm submit: {time.perf_counter() - t0:.3f} s wall")
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(30)
    for line in text.getvalue().splitlines():
        if line.strip() and ("/" in line or "ncalls" in line):
            log(f"[profile] {line.strip()[:150]}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        session.submit(query, lam=lam)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): the host ops that launched
    # them report the same device time again
    events = [e for e in p.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"[profile] device busy {busy_us / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall "
        f"(idle share {1 - busy_us / wall_us:.3f}) in the torch.profiler'd warm submit")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[profile] device {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


def phase_parity(torch) -> None:
    from repro_torch.mpc import DataplaneExecutor, compile_plan, fuse_semijoin_pass
    from repro_torch.core.taxonomy import compute_stats

    for name, q, lam, fused in parity_queries():
        prog = compile_plan(q, compute_stats(q, lam), 8)
        if fused:
            prog = fuse_semijoin_pass(prog)
        for batch in (True, False):
            on_card = DataplaneExecutor(8, device="cuda", batch_stages=batch).run(prog)
            plain = DataplaneExecutor(8, device="cpu", batch_stages=batch).run(prog)
            same = (on_card.rows.dtype == plain.rows.dtype
                    and on_card.rows.tobytes() == plain.rows.tobytes()
                    and on_card.count == plain.count
                    and on_card.per_h_counts == plain.per_h_counts
                    and on_card.retries == plain.retries
                    and on_card.retry_log == plain.retry_log)
            if not same:
                raise AssertionError(f"parity {name} batch={batch}: card and CPU differ")
        log(f"[parity] {name}: {on_card.count} rows, byte-identical on card and CPU "
            f"(both schedules)")


def pairs_design_bytes(torch, starts, a_idx, cap: int) -> tuple:
    """What merge_join_pairs' design moves at these inputs, and the shape of
    its data: starts read once for every key before a segment's trailing run
    of equal starts (the run's slots are written without it), lower read at
    each selected key, 8 bytes written per slot.  → (bytes, stats text)."""
    s, n = starts.shape
    last = starts[:, -1:].to(torch.int64)
    c = last.clamp(0, cap)
    merged = int((starts.to(torch.int64) < c).sum())         # keys before some slot
    selected = s + int((a_idx[:, 1:] != a_idx[:, :-1]).sum()) if cap else 0
    zero = float((starts[:, 1:] == starts[:, :-1]).float().mean()) if n > 1 else 0.0
    tail = float((starts == starts[:, -1:]).float().mean())
    aliased = float((torch.arange(cap, device=starts.device)[None, :] >= last).float().mean())
    text = (f"zero-count keys {zero:.3f}, trailing run {tail:.3f} of the keys, slots at or "
            f"past the last start {aliased:.3f}, last start mean {float(last.float().mean()):.0f}"
            f" max {int(last.max())}")
    return 4 * merged + 4 * selected + 8 * s * cap + 8 * s, text


def phase_timing(torch, capture: InputCapture, launches: dict) -> list:
    """Phase 6: each join kernel at the largest inputs phases 3-5 gave it.
    For the two kernels redesigned last it also logs the device time and
    device operations per call (torch.profiler)."""
    from repro_torch.kernels import ref

    hp, mj = kernel_modules()
    out = []
    for name in JOIN_KERNELS:
        source, replaces = KERNELS[name]
        if name not in capture.best:
            raise AssertionError(f"{name}: the main path never called it")
        _, args = capture.best[name]
        extra = ""
        if name == "hash_partition_pack":
            keys, counts, parts = args
            s, n = keys.shape
            kern = lambda: hp.hash_partition_pack_cuda(keys, counts, parts)
            plain = lambda: ref.hash_partition_pack_ref(keys, counts, parts)
            library = None
            need = lambda got: 4 * s * n + 4 * s + 8 * s * n + 4 * s * parts
            shape = f"S={s} N={n} P={parts}"
        elif name == "merge_join_counts":
            a, b = args
            s, n = a.shape
            m = b.shape[1]
            kern = lambda: mj.merge_join_counts_cuda(a, b)
            plain = lambda: ref.merge_join_counts_ref(a, b)
            library = lambda: (torch.searchsorted(b, a, side="left"),
                               torch.searchsorted(b, a, side="right"))
            need = lambda got: 4 * s * n + 4 * s * m + 8 * s * n
            shape = f"S={s} N={n} M={m}"
        else:
            lower, starts, cap = args
            s, n = starts.shape
            tgrid = torch.arange(cap, dtype=torch.int32, device=starts.device).expand(
                s, cap).contiguous()
            kern = lambda: mj.merge_join_pairs_cuda(lower, starts, cap)
            plain = lambda: ref.merge_join_pairs_ref(lower, starts, cap)
            library = lambda: torch.searchsorted(starts, tgrid, side="right")
            # 8 bytes written per slot, plus lower and starts read once at
            # each key this run's slots select (a_idx is nondecreasing per
            # segment, so the selected keys are its runs)
            need = lambda got: 8 * s * cap + 8 * (
                s + int((got[0][:, 1:] != got[0][:, :-1]).sum()) if cap else 0)
            shape = f"S={s} N={n} cap_out={cap}"
        got, want = kern(), plain()
        torch.cuda.synchronize()
        nbytes = need(got)
        if name == "merge_join_pairs":
            design, stats = pairs_design_bytes(torch, starts, got[0], cap)
            extra += (f"; the design moves {design} bytes "
                      f"({design / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory rate); {stats}")
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        del got, want
        med, spread = time_rounds(torch, kern, plain, library)
        ms, plain_ms, library_ms = med["kernel"], med["plain"], med.get("library")
        if name != "merge_join_counts":     # the two redesigned last
            dev_ms, dev_ops, dev_names = device_ms(torch, kern)
            extra += (f"; device {dev_ms:.4f} ms and {dev_ops:g} device operations per call "
                      f"({', '.join(dev_names)})")
        # the bytes the function must move: each needed input read once,
        # each output written once
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[name], "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
               "library_ms": library_ms}
        log(f"[timing] {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library_ms if library_ms is None else round(library_ms, 4)} ms, "
            f"bound {bound_ms:.4f} ms ({nbytes} bytes), max_abs_err {err}{extra}; "
            f"medians of 5 rounds, range ms: {spread}")
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version at {shape}")
        out.append(row)
        torch.cuda.empty_cache()
    pack_at_scale(torch, hp)
    pack_many_parts(torch, hp)
    return out


def pack_at_scale(torch, hp) -> None:
    """hash_partition_pack at S=64, N=2^20, P=64 (1024 tiles of look-back a
    segment), checked against its plain version and timed beside its byte
    bound (one log line; not a row of the ``kernels`` line)."""
    from repro_torch.kernels import ref

    s, n, parts = 64, 1 << 20, 64
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(-(2**31), 2**31, (s, n)).astype(np.int32)).cuda()
    counts = torch.from_numpy(rng.integers(n - n // 8, n + 1, s).astype(np.int32)).cuda()
    kern = lambda: hp.hash_partition_pack_cuda(keys, counts, parts)
    got = kern()
    torch.cuda.synchronize()
    for g, w in zip(got, ref.hash_partition_pack_ref(keys, counts, parts)):
        if not torch.equal(g, w):
            raise AssertionError(f"hash_partition_pack S={s} N={n} P={parts}: kernel differs")
    del got
    torch.cuda.empty_cache()
    med, spread = time_rounds(torch, kern, None, None)
    dev, ops, _ = device_ms(torch, kern)
    nbytes = 12 * s * n + 4 * s + 4 * s * parts
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    text = (f"[timing] hash_partition_pack at scale S={s} N={n} P={parts}: kernel "
            f"{med['kernel']:.4f} ms ({bound_ms / med['kernel']:.3f} of its bound), device "
            f"{dev:.4f} ms and {ops:g} operations per call, bound {bound_ms:.4f} ms ({nbytes} "
            f"bytes), equal to its plain version")
    log(f"{text}; medians of 5 rounds, range ms: {spread}")
    del keys, counts
    torch.cuda.empty_cache()


def pack_many_parts(torch, hp) -> None:
    """hash_partition_pack at the main path's S=64, N=16384 with P = 1024
    (the single-block kernel, past the old limit of 383) and P = 4096 (the
    wide kernel), each checked against its plain version and timed beside
    its byte bound (log lines; not rows of the ``kernels`` line)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.hash_partition import MAX_SMEM_PARTS

    s, n = 64, 16384
    rng = np.random.default_rng(4)
    keys = torch.from_numpy(rng.integers(-(2**31), 2**31, (s, n)).astype(np.int32)).cuda()
    counts = torch.from_numpy(rng.integers(n - n // 8, n + 1, s).astype(np.int32)).cuda()
    for parts in (1024, 4096):
        kern = lambda: hp.hash_partition_pack_cuda(keys, counts, parts)
        got = kern()
        torch.cuda.synchronize()
        for g, w in zip(got, ref.hash_partition_pack_ref(keys, counts, parts)):
            if not torch.equal(g, w):
                raise AssertionError(f"hash_partition_pack S={s} N={n} P={parts}: kernel differs")
        del got
        med, spread = time_rounds(torch, kern, lambda: ref.hash_partition_pack_ref(
            keys, counts, parts), None)
        dev, ops, names = device_ms(torch, kern)
        nbytes = 12 * s * n + 4 * s + 4 * s * parts
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        path = "wide" if parts > MAX_SMEM_PARTS else "single-block"
        log(f"[timing] hash_partition_pack {path} kernel S={s} N={n} P={parts}: kernel "
            f"{med['kernel']:.4f} ms, plain {med['plain']:.4f} ms, device {dev:.4f} ms and "
            f"{ops:g} operations per call ({', '.join(names)}), bound {bound_ms:.4f} ms "
            f"({nbytes} bytes), equal to its plain version; medians of 5 rounds, range ms: "
            f"{spread}")
    del keys, counts
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The kernel library: hash_partition, flash_attention, ssd_chunk
# ---------------------------------------------------------------------------


def attention_close(torch, got, q, k, v, causal: bool, controls=None, heads: int = 8) -> dict:
    """Hold a flash_attention output against its plain version, ``heads`` rows
    of BH at a time (the plain version holds a (heads, Sq, Sk) fp32 tensor).

    The limit on |Δ| is 1e-4 + 1e-4·|plain| in float32 and, in bfloat16,
    ``ref.flash_attention_bf16_tolerance``: the rounding error of the output
    and of the weights, from these inputs.  Raises on a wrong shape, a
    non-finite value or a |Δ| past the limit; returns the max |Δ| and the
    largest share of the limit used.  ``controls`` maps a name to a
    deliberately wrong plain variant f(q, k, v); for each, the result also
    holds the share of q rows in which it passes the limit somewhere
    ("caught"), under this limit and under 3e-2 + 3e-2·|plain|, the JAX
    test's bf16 tolerance, and the largest share of the limit it used."""
    from repro_torch.kernels import ref

    if got.shape != q.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError("flash_attention: wrong shape or non-finite output")
    out = {"max_abs_err": 0.0, "limit_used": 0.0}
    seen = {name: [0, 0, 0.0] for name in controls or {}}
    for i in range(0, q.shape[0], heads):
        qs, ks, vs = q[i:i + heads], k[i:i + heads], v[i:i + heads]
        want = ref.flash_attention_ref(qs, ks, vs, causal)
        if q.dtype == torch.bfloat16:
            lim = ref.flash_attention_bf16_tolerance(qs, ks, vs, want, causal)
        else:
            lim = 1e-4 + 1e-4 * want.float().abs()
        want = want.float()
        diff = (got[i:i + heads].float() - want).abs()
        out["max_abs_err"] = max(out["max_abs_err"], float(diff.max()))
        out["limit_used"] = max(out["limit_used"], float((diff / lim).max()))
        for name, fn in (controls or {}).items():
            cd = (fn(qs, ks, vs).float() - want).abs()
            seen[name][0] += int((cd > lim).any(-1).sum())
            seen[name][1] += int((cd > 3e-2 + 3e-2 * want.abs()).any(-1).sum())
            seen[name][2] = max(seen[name][2], float((cd / lim).max()))
        del want, lim, diff
    if out["limit_used"] > 1:
        raise AssertionError(f"flash_attention: differs from its plain version by "
                             f"{out['max_abs_err']} ({out['limit_used']:.3g} of the limit)")
    rows = q.shape[0] * q.shape[1]
    for name, (caught, caught_3e2, used) in seen.items():
        out[name] = {"rows_caught": caught / rows, "rows_caught_at_3e-2": caught_3e2 / rows,
                     "limit_used": used}
    return out


def dropped_tile_control(torch, q, k, v):
    """The plain causal version with each q row's own 32-key tile left out
    (an off-by-one in a kernel's tile loop): a fault the check must see."""
    from repro_torch.kernels import ref

    w = ref.attention_weights(q, k, True)
    iq = torch.arange(q.shape[1], device=q.device)[:, None]
    ik = torch.arange(k.shape[1], device=q.device)[None, :]
    w = w * (ik < iq // 32 * 32)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bqk,bkd->bqd", w.to(v.dtype).float(), v.float()).to(v.dtype)


def unrounded_control(torch, q, k, v):
    """The plain causal version without the rounding of the weights to v's
    type: a fault within rounding noise, which no limit can see."""
    from repro_torch.kernels import ref

    w = ref.attention_weights(q, k, True)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(v.dtype)


def ssd_close(torch, got, want) -> float:
    """Max |Δ| over y and the state; raises unless each is finite and within
    1e-4 of its plain version's largest magnitude."""
    err = 0.0
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        d = float((g - w).abs().max())
        if g.shape != w.shape or not bool(torch.isfinite(g).all()) or d > 1e-4 * scale:
            raise AssertionError(f"ssd_chunk: differs from its plain version by {d} "
                                 f"(max |plain| {scale})")
        err = max(err, d)
    return err


def ssd_inputs(torch, rng, batch, heads, s, p, n, dev):
    """x, B, C ~ N(0, 1), dt ~ U(0.01, 0.2), a ~ -U(0.5, 2) per head (as
    benchmarks/bench_kernels.py draws them), flattened to (batch·heads, ...)."""
    bh = batch * heads
    a = -np.tile(rng.uniform(0.5, 2.0, heads).astype(np.float32), batch)
    arrays = (rng.standard_normal((bh, s, p), dtype=np.float32),
              rng.uniform(0.01, 0.2, (bh, s)).astype(np.float32), a,
              rng.standard_normal((bh, s, n), dtype=np.float32),
              rng.standard_normal((bh, s, n), dtype=np.float32))
    return [torch.from_numpy(x).to(dev) for x in arrays]


# ssd_chunk's hazards: (name, BH, S, P, N, chunk, a or None, storage offset)
SSD_HAZARDS = [
    ("ragged tiles", 2, 80, 17, 33, 40, None, 0),
    ("64 chunks of 16", 2, 1024, 64, 128, 16, None, 0),
    ("one batch·head", 1, 512, 64, 128, 256, None, 0),
    ("a=0 (no decay)", 2, 1024, 64, 64, 64, 0.0, 0),
    ("a=-50 (decay underflows)", 2, 512, 64, 128, 256, -50.0, 0),
    ("inputs one element off 16 bytes", 2, 256, 64, 128, 64, None, 1),
]


def at_offset(torch, t, offset: int):
    """A contiguous copy of t on its device whose data starts ``offset``
    elements into its storage."""
    buf = torch.empty((t.numel() + offset,), dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def phase_library_kernels(torch, dev) -> None:
    """Phase 2, continued: the library kernels on edge cases."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_cuda
    from repro_torch.kernels.hash_partition import SMEM_LIMIT, hash_partition_cuda
    from repro_torch.kernels.ssd import ssd_chunk_cuda

    rng = np.random.default_rng(1)
    for n in (1, 1000, 3001, 1 << 20):
        for parts in (1, 7, 64):
            keys = rng.integers(-(2**31), 2**31, n).astype(np.int32)
            keys[: min(n, 4)] = [INT32_MAX, -(2**31), INT32_MAX - 1, -(2**31) + 1][: min(n, 4)]
            k = torch.from_numpy(keys).to(dev)
            got = hash_partition_cuda(k, parts)
            torch.cuda.synchronize()
            for g, w in zip(got, ref.hash_partition_ref(k, parts)):
                if not torch.equal(g, w):
                    raise AssertionError(f"hash_partition N={n} P={parts}: kernel differs")
        log(f"[kernels] hash_partition N={n} P=1,7,64: equal")
    p_max = SMEM_LIMIT // 4 - 1                     # the largest P the wrapper takes
    for name, n, parts, offset in (("N=1", 1, 64, 0), ("N=3", 3, 7, 0), ("N=4097", 4097, 64, 0),
                                   ("N=2^20 offset view", 1 << 20, 64, 1),
                                   (f"P={p_max}", 20000, p_max, 0)):
        full = torch.from_numpy(rng.integers(-(2**31), 2**31, n + offset).astype(np.int32))
        k = full.to(dev)[offset:]
        got = hash_partition_cuda(k, parts)
        torch.cuda.synchronize()
        for g, w in zip(got, ref.hash_partition_ref(k, parts)):
            if not torch.equal(g, w):
                raise AssertionError(f"hash_partition {name}: kernel differs")
        log(f"[kernels] hash_partition {name} (N={n}, P={parts}, storage offset {offset}): equal")

    # ragged Sq and Sk (not multiples of the 64-row tiles), Sq != Sk under
    # the causal mask, BH = 1, every head dim
    for bh, sq, sk in ((2, 100, 100), (1, 200, 200), (2, 64, 100), (2, 128, 256),
                       (2, 256, 128), (1, 384, 384), (1, 1, 1)):
        for d in HEAD_DIMS:
            found = {}
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d), dtype=np.float32))
                           .to(dev).to(dtype) for s in (sq, sk, sk))
                for causal in (True, False):
                    got = flash_attention_cuda(q, k, v, causal)
                    torch.cuda.synchronize()
                    res = attention_close(torch, got, q, k, v, causal)
                    err, used = found.get(dtype, (0.0, 0.0))
                    found[dtype] = (max(err, res["max_abs_err"]), max(used, res["limit_used"]))
            log(f"[kernels] flash_attention BH={bh} Sq={sq} Sk={sk} D={d} causal/full: "
                "max |err| "
                + ", ".join(f"{str(t)[6:]} {e:.3g} ({u:.3f} of the limit)"
                            for t, (e, u) in found.items()))

    for chunk in (16, 64, 256):
        for n_chunks in (1, 8):
            for p, n in ((64, 128), (16, 32)):
                args = ssd_inputs(torch, rng, 1, 1, chunk * n_chunks, p, n, dev)
                got = ssd_chunk_cuda(*args, chunk)
                torch.cuda.synchronize()
                err = ssd_close(torch, got, ref.ssd_chunked_ref(*args, chunk))
                log(f"[kernels] ssd_chunk BH=1 S={chunk * n_chunks} chunk={chunk} P={p} "
                    f"N={n}: max |err| {err:.3g}")
    for name, bh, s_len, p, n, chunk, a_val, offset in SSD_HAZARDS:
        args = ssd_inputs(torch, rng, bh, 1, s_len, p, n, dev)
        if a_val is not None:
            args[2].fill_(a_val)
        args = [at_offset(torch, t, offset) for t in args]
        got = ssd_chunk_cuda(*args, chunk)
        torch.cuda.synchronize()
        err = ssd_close(torch, got, ref.ssd_chunked_ref(*args, chunk))
        log(f"[kernels] ssd_chunk {name} BH={bh} S={s_len} chunk={chunk} P={p} N={n}: "
            f"max |err| {err:.3g}")


def attention_case(torch, q, k, v, batch: int, heads: int) -> dict:
    """Causal attention over q/k/v (BH, S, D), BH = batch·heads, for
    ``library_row``: the kernel, its plain version (8 heads at a time: it holds a
    (heads, S, S) fp32 score tensor), SDPA, and the bound's FLOPs and bytes."""
    from repro_torch.analysis.roofline import kernel_costs
    from repro_torch.kernels import ops, ref

    bh, seq, hd = q.shape
    plain = lambda: torch.cat([ref.flash_attention_ref(q[i:i + 8], k[i:i + 8], v[i:i + 8], True)
                               for i in range(0, bh, 8)])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    costs = kernel_costs("flash_attention", q, k, v, causal=True)
    return dict(
        kern=lambda: ops.flash_attention(q, k, v, causal=True, bq=seq, bk=seq), plain=plain,
        # SDPA's fused kernels take (batch, heads, S, D); (BH, S, D) would send it to
        # its unfused math path
        library=lambda: sdpa(*(x.view(batch, heads, seq, hd) for x in (q, k, v)),
                             is_causal=True),
        flops=costs["flops"],
        peak=BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S,
        nbytes=costs["bytes"],
        shape=f"BH={bh} S={seq} D={hd} {str(q.dtype)[6:]} causal")


def ssd_case(torch, ssd_args, chunk: int) -> dict:
    """ssd_chunk over (x, dt, a, b, c) for ``library_row``."""
    from repro_torch.analysis.roofline import kernel_costs
    from repro_torch.kernels import ops, ref

    bh, s_len, p_dim = ssd_args[0].shape
    n_dim = ssd_args[3].shape[2]
    costs = kernel_costs("ssd_chunk", *ssd_args, chunk=chunk)
    return dict(
        kern=lambda: ops.ssd_chunk(*ssd_args, chunk=chunk),
        plain=lambda: ref.ssd_chunked_ref(*ssd_args, chunk), library=None,
        # the least time for the work on any pipe: the TF32 tensor cores
        flops=costs["flops"], peak=TF32_FLOP_PER_S, nbytes=costs["bytes"],
        shape=f"BH={bh} S={s_len} chunk={chunk} P={p_dim} N={n_dim} fp32")


def library_row(torch, name: str, c: dict, launches: int, err: float, tag: str,
                device_time: bool) -> dict:
    """Time one kernel case beside its plain version, its library call and its
    bound (``time_rounds``; with ``device_time`` also torch.profiler's device ms and
    operations per call) → its row of the ``kernels`` line, logged under ``tag``."""
    med, spread = time_rounds(torch, c["kern"], c["plain"], c["library"])
    extra = ""
    if device_time:
        dev_ms, dev_ops, dev_names = device_ms(torch, c["kern"])
        extra = (f"; device {dev_ms:.4f} ms and {dev_ops:g} device operations per call "
                 f"({', '.join(dev_names)})")
    ops_ms = c["flops"] / c["peak"] * 1e3
    bytes_ms = c["nbytes"] / HBM_BYTES_PER_S * 1e3
    source, replaces = KERNELS[name]
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": launches, "max_abs_err": err, "ms": med["kernel"],
           "plain_ms": med["plain"], "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
           "library_ms": med.get("library")}
    log(f"[{tag}] {name} {c['shape']}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library {row['library_ms']} ms, bound "
        f"{row['bound_ms']:.4f} ms ({c['flops']:.4g} FLOP -> {ops_ms:.4f} ms, "
        f"{c['nbytes']} bytes -> {bytes_ms:.4f} ms), max_abs_err {row['max_abs_err']}"
        f"{extra}; medians of 5 rounds, range ms: {spread}")
    return row


def phase_library(torch, dev) -> list:
    """Phase 7: the kernel library at model widths.

    flash_attention at h2o-danube-1.8b prefill (batch 2 x 32 heads, 8 KV
    heads expanded to 32, 4096 tokens, head dim 80, bf16, causal);
    ssd_chunk at mamba2-780m (batch 4 x 48 heads, S = 4096, chunk 256,
    headdim 64, d_state 128, fp32); hash_partition over 2,000,000 int32
    keys into 64 partitions, and once over int64 keys through fold64.
    Launches are counted over one call of each op; then each kernel is held
    against its plain version and timed beside it (and beside SDPA for
    attention)."""
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    batch, heads, kv_heads, seq, hd = (ATTN_WIDTHS[k] for k in
                                       ("batch", "heads", "kv_heads", "seq", "head_dim"))
    q = torch.from_numpy(rng.standard_normal((batch * heads, seq, hd), dtype=np.float32))
    kv = [torch.from_numpy(rng.standard_normal((batch, kv_heads, seq, hd), dtype=np.float32))
          for _ in range(2)]
    q = q.to(dev).to(torch.bfloat16)
    k, v = (x.to(dev).to(torch.bfloat16).repeat_interleave(heads // kv_heads, dim=1)
            .reshape(batch * heads, seq, hd) for x in kv)
    sw = SSD_WIDTHS
    chunk, s_len, p_dim, n_dim = sw["chunk"], sw["seq"], sw["headdim"], sw["d_state"]
    ssd_args = ssd_inputs(torch, rng, sw["batch"], sw["heads"], s_len, p_dim, n_dim, dev)
    keys32 = torch.from_numpy(rng.integers(-(2**31), 2**31, HASH_KEYS).astype(np.int32)).to(dev)
    keys64 = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, HASH_KEYS,
                                           dtype=np.int64)).to(dev)
    torch.cuda.synchronize()
    log(f"[library] inputs made in {time.perf_counter() - t0:.1f} s")

    reset_counts()
    attn = ops.flash_attention(q, k, v, causal=True)
    y, state = ops.ssd_chunk(*ssd_args, chunk=chunk)
    part32, hist32 = ops.hash_partition(keys32, HASH_PARTS)
    part64, hist64 = ops.hash_partition(keys64, HASH_PARTS)
    torch.cuda.synchronize()
    launches = launch_counts(LIBRARY_KERNELS)
    log(f"[library] kernel launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name}: no launch in phase 7")

    controls = {"dropped_tile": lambda *a: dropped_tile_control(torch, *a),
                "unrounded": lambda *a: unrounded_control(torch, *a)}
    attn_check = attention_close(torch, attn, q, k, v, True, controls)
    log(f"[library] flash_attention against its plain version and two wrong "
        f"variants of it: {json.dumps(attn_check)}")
    # the limit has teeth: it catches a dropped key tile in most rows
    if attn_check["dropped_tile"]["rows_caught"] < 0.5:
        raise AssertionError("flash_attention: the bf16 limit misses a dropped key tile")
    errs = {"flash_attention": attn_check["max_abs_err"],
            "ssd_chunk": ssd_close(torch, (y, state), ref.ssd_chunked_ref(*ssd_args, chunk))}
    folded = ops.fold64(keys64)
    for (part, hist), keys in (((part32, hist32), keys32), ((part64, hist64), folded)):
        want = ref.hash_partition_ref(keys, HASH_PARTS)
        if not (torch.equal(part, want[0]) and torch.equal(hist, want[1])
                and int(hist.sum()) == keys.numel()):
            raise AssertionError("hash_partition: kernel differs from its plain version")
    errs["hash_partition"] = 0
    del attn, y, state, part32, part64
    torch.cuda.empty_cache()
    log(f"[library] outputs agree with the plain versions: {json.dumps(errs)}")

    cases = {"flash_attention": attention_case(torch, q, k, v, batch, heads),
             "ssd_chunk": ssd_case(torch, ssd_args, chunk),
             "hash_partition": dict(
                 kern=lambda: ops.hash_partition(keys32, HASH_PARTS),
                 plain=lambda: ref.hash_partition_ref(keys32, HASH_PARTS), library=None,
                 flops=0, peak=1.0, nbytes=8 * keys32.numel() + 4 * HASH_PARTS,
                 shape=f"N={HASH_KEYS} int32 P={HASH_PARTS}")}
    rows = []
    for name in LIBRARY_KERNELS:
        # the two redesigned last also by device time
        rows.append(library_row(torch, name, cases[name], launches[name], errs[name],
                                "library", device_time=name != "flash_attention"))
        torch.cuda.empty_cache()
    del ssd_args, keys32, keys64, folded, q, k, v
    torch.cuda.empty_cache()
    hash_partition_at_scale(torch, rng)
    attention_other_width(torch, dev, rng, ATTN_WIDTHS_2)
    attention_other_width(torch, dev, rng, ATTN_WIDTHS_3)
    return rows


def hash_partition_at_scale(torch, rng) -> None:
    """hash_partition over ``HASH_KEYS_AT_SCALE`` int32 keys into 64
    partitions (512 MB of traffic, past the L2), checked against its plain
    version and timed beside its byte bound (one log line; not a row of the
    ``kernels`` line)."""
    from repro_torch.kernels import ops, ref

    n = HASH_KEYS_AT_SCALE
    keys = torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(np.int32)).cuda()
    kern = lambda: ops.hash_partition(keys, HASH_PARTS)
    got = kern()
    torch.cuda.synchronize()
    for g, w in zip(got, ref.hash_partition_ref(keys, HASH_PARTS)):
        if not torch.equal(g, w):
            raise AssertionError(f"hash_partition N={n} P={HASH_PARTS}: kernel differs")
    del got
    torch.cuda.empty_cache()
    med, spread = time_rounds(torch, kern, None, None)
    dev, ops_n, _ = device_ms(torch, kern)
    nbytes = 8 * n + 4 * HASH_PARTS
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[library] hash_partition at scale N={n} P={HASH_PARTS}: kernel {med['kernel']:.4f} ms "
        f"({bound_ms / med['kernel']:.3f} of its bound), device {dev:.4f} ms ({bound_ms / dev:.3f} "
        f"of its bound) and {ops_n:g} operations per call, bound {bound_ms:.4f} ms ({nbytes} "
        f"bytes), equal to its plain version; medians of 5 rounds, range ms: {spread}")
    del keys
    torch.cuda.empty_cache()


def attention_other_width(torch, dev, rng, widths) -> None:
    """bf16 flash_attention at another model's width (``ATTN_WIDTHS_2``,
    ``ATTN_WIDTHS_3``), held to the bf16 limit and timed beside SDPA (one log
    line; not a row of the ``kernels`` line)."""
    from repro_torch.kernels import ops

    batch, heads, seq, hd = (widths[k] for k in ("batch", "heads", "seq", "head_dim"))
    q, k, v = (torch.from_numpy(rng.standard_normal((batch * heads, seq, hd), dtype=np.float32))
               .to(dev).to(torch.bfloat16) for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    check = attention_close(torch, out, q, k, v, True)
    del out
    sdpa = torch.nn.functional.scaled_dot_product_attention
    med, spread = time_rounds(
        torch, lambda: ops.flash_attention(q, k, v, causal=True), None,
        lambda: sdpa(*(x.view(batch, heads, seq, hd) for x in (q, k, v)), is_causal=True))
    flops = 4 * hd * batch * heads * seq * (seq + 1) // 2
    nbytes = 2 * 4 * q.numel()
    bound_ms = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    log(f"[library] flash_attention at {widths['model']} prefill BH={batch * heads} S={seq} "
        f"D={hd} bf16 causal: kernel {med['kernel']:.4f} ms, SDPA {med['library']:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({flops:.4g} FLOP); max |err| {check['max_abs_err']:.3g} "
        f"({check['limit_used']:.3f} of the bf16 limit); medians of 5 rounds, range ms: "
        f"{spread}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Subgraph enumeration and the async service (``submit_pattern``,
# ``submit_coalesced``, ``submit_async``)
# ---------------------------------------------------------------------------

#: the cold clique4 submit's budget on the 2M-edge graph: past it (or out of
#: device memory) the edge count halves, with the same generator
CLIQUE4_BUDGET_S = 120.0


def subgraph_cases():
    """The four cases of benchmarks/bench_subgraph.py (same seeds, the port's
    generators): (name, graph, pattern, lambda)."""
    from repro_torch.graph import clique, cycle, erdos_renyi, triangle
    from repro_torch.graph import zipf_graph as port_zipf_graph

    zipf12k = port_zipf_graph(np.random.default_rng(42), 5000, 12000, skew=0.9)
    er2k = erdos_renyi(np.random.default_rng(7), 800, 2400)
    hubby = port_zipf_graph(np.random.default_rng(11), 150, 700, skew=2.0)
    return [("triangle-zipf12k", zipf12k, triangle(), 8),
            ("clique4-zipf12k", zipf12k, clique(4), 2),
            ("cycle4-er2k", er2k, cycle(4), 4),
            ("triangle-hubs", hubby, triangle(), 24)]


def in_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The concatenation of arange(s, s + l) over (s, l) pairs."""
    total = int(lens.sum())
    offs = np.repeat(starts - np.cumsum(lens) + lens, lens)
    return offs + np.arange(total, dtype=np.int64)


def clique4_oracle(oriented: np.ndarray, n_vertices: int, chunk: int = 1 << 22) -> int:
    """4-cliques of the graph whose edges ``oriented`` lists once each (lower
    to higher rank), independent of the join engine: every oriented triangle
    (a, b, c) adds |N+(a) ∩ N+(b) ∩ N+(c)|, so each 4-clique counts once, at
    its three lowest vertices.  Triangles come from the oriented 2-paths
    a→b→c closed by a→c; membership is a binary search of the sorted edge
    codes a·n + c.  Processed in slices of about ``chunk`` candidates."""
    src, dst = oriented[:, 0].astype(np.int64), oriented[:, 1].astype(np.int64)
    n = np.int64(n_vertices)
    codes = src * n + dst                      # sorted: the rows are
    indptr = np.searchsorted(src, np.arange(n_vertices + 1))
    outdeg = np.diff(indptr)

    def member(x):
        pos = np.minimum(np.searchsorted(codes, x), codes.size - 1)
        return codes[pos] == x

    def expand(a_rows, via, budget):
        """Yield (rows repeated per out-neighbour of via, those neighbours)."""
        lens = outdeg[via]
        csum = np.cumsum(lens)
        start = 0
        while start < via.size:
            stop = int(np.searchsorted(csum, (csum[start - 1] if start else 0) + budget,
                                       side="right"))
            stop = max(stop, start + 1)
            sl = slice(start, stop)
            nbr = dst[in_ranges(indptr[via[sl]], lens[sl])]
            yield tuple(np.repeat(r[sl], lens[sl]) for r in a_rows), nbr
            start = stop

    total = 0
    for (a, b), c in expand((src, dst), dst, chunk):
        keep = member(a * n + c)
        a, b, c = a[keep], b[keep], c[keep]
        for (ta, tb), d in expand((a, b), c, chunk):
            total += int((member(ta * n + d) & member(tb * n + d)).sum())
    return total


def submit_pattern_timed(torch, session, pattern, graph, lam=None):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = session.submit_pattern(pattern, graph, lam=lam)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def check_path_launches(tag: str) -> dict:
    """The join kernels' launches since the last ``reset_counts``; fails if
    one of them never launched."""
    launches = launch_counts(JOIN_KERNELS)
    log(f"[{tag}] kernel launches: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name}: no launch on the {tag} path")
    return launches


def phase_patterns(torch, session, main3) -> dict:
    """Subgraph enumeration through ``session.submit_pattern`` (p=64):
    (a) triangles of phase 3's 2M-edge graph against phase 3's oracle;
    (b) the four cases of benchmarks/bench_subgraph.py, byte-equal to the
    brute-force oracle and to a p=64 session on the CPU; (c) 4-cliques of
    phase 3's graph (halved while the cold submit overruns its budget or the
    card's memory) against ``clique4_oracle``."""
    from repro_torch.graph import Graph, brute_force_occurrences, clique, triangle
    from repro_torch.mpc import JoinSession, QueryFailedError

    reset_counts()
    t_phase = time.perf_counter()
    out = {}
    graph = Graph.from_edges(main3["edges"], n_vertices=main3["n_vertices"])
    cold, cold_s = submit_pattern_timed(torch, session, triangle(), graph)
    warm, warm_s = submit_pattern_timed(torch, session, triangle(), graph)
    if not cold.count == warm.count == main3["oracle"]:
        raise AssertionError(f"patterns: triangle counts {cold.count}/{warm.count} != "
                             f"oracle {main3['oracle']}")
    if cold.occurrences.tobytes() != warm.occurrences.tobytes():
        raise AssertionError("patterns: warm triangle occurrences differ from cold")
    log(f"[patterns] triangle on the {graph.n_edges}-edge graph: {cold.count} occurrences "
        f"= phase 3's oracle; cold {cold_s:.3f} s, warm {warm_s:.3f} s, warm retries "
        f"{warm.engine.retries}, warm learned-caps hits {warm.engine.caps_hits}")
    out["triangle-2M"] = {"count": cold.count, "cold_s": cold_s, "warm_s": warm_s}
    del cold, warm

    cpu = JoinSession(p=64, device="cpu")
    for name, g, pat, lam in subgraph_cases():
        t0 = time.perf_counter()
        brute = brute_force_occurrences(g, pat)
        brute_s = time.perf_counter() - t0
        res, cold_s = submit_pattern_timed(torch, session, pat, g, lam)
        res_w, warm_s = submit_pattern_timed(torch, session, pat, g, lam)
        plain = cpu.submit_pattern(pat, g, lam=lam)
        for label, other in (("brute force", brute), ("the CPU session", plain.occurrences),
                             ("the warm submit", res_w.occurrences)):
            if res.occurrences.tobytes() != other.tobytes() or res.occurrences.shape != other.shape:
                raise AssertionError(f"patterns {name}: occurrences differ from {label}")
        log(f"[patterns] {name} (lambda={lam}, {g.n_edges} edges): {res.count} occurrences, "
            f"{res.embeddings} embeddings, byte-equal to brute force, the CPU session and the "
            f"warm submit; cold {cold_s:.3f} s, warm {warm_s:.3f} s (brute force "
            f"{brute_s:.1f} s on the host), warm retries {res_w.engine.retries}")
        out[name] = {"count": res.count, "cold_s": cold_s, "warm_s": warm_s}

    n_edges = main3["edges"].shape[0]
    while True:
        if n_edges == main3["edges"].shape[0]:
            edges, oriented = main3["edges"], main3["oriented"]
        else:
            edges = zipf_graph(np.random.default_rng(0), main3["n_vertices"], n_edges, 0.9)
            oriented = orient_by_degree(edges, main3["n_vertices"])
        g = Graph.from_edges(edges, n_vertices=main3["n_vertices"])
        try:
            res, cold_s = submit_pattern_timed(torch, session, clique(4), g)
        except QueryFailedError as e:
            if not isinstance(e.cause, torch.cuda.OutOfMemoryError):
                raise
            log(f"[patterns] clique4 on {g.n_edges} edges ran out of device memory: halving")
            torch.cuda.empty_cache()
            n_edges //= 2
            continue
        if cold_s > CLIQUE4_BUDGET_S:
            log(f"[patterns] clique4 on {g.n_edges} edges: cold submit {cold_s:.1f} s is past "
                f"its {CLIQUE4_BUDGET_S:.0f} s budget: halving")
            n_edges //= 2
            continue
        break
    t0 = time.perf_counter()
    want = clique4_oracle(oriented, main3["n_vertices"])
    oracle_s = time.perf_counter() - t0
    if res.count != want:
        raise AssertionError(f"patterns: clique4 count {res.count} != oracle {want}")
    log(f"[patterns] clique4 on the {g.n_edges}-edge graph ({main3['n_vertices']} vertices, "
        f"zipf 0.9, seed 0): {res.count} occurrences = the numpy oracle ({oracle_s:.1f} s on "
        f"the host); cold {cold_s:.3f} s, {res.embeddings} embeddings, retries "
        f"{res.engine.retries}")
    out["clique4"] = {"edges": g.n_edges, "count": res.count, "cold_s": cold_s}
    del res
    out["launches"] = check_path_launches("patterns")
    log(f"[patterns] ok in {time.perf_counter() - t_phase:.1f} s")
    return out


def perm_query(seed: int, n: int):
    """(A,B) ⋈ (B,C) over two permutations: no heavy values, so seeds give
    distinct data behind one plan key (one coalesce group)."""
    from repro_torch.core.query import query_from_arrays

    rng = np.random.default_rng(seed)
    ab = np.stack([np.arange(n), rng.permutation(n)], axis=1)
    bc = np.stack([np.arange(n), rng.permutation(n)], axis=1)
    return query_from_arrays([(("A", "B"), ab, None), (("B", "C"), bc, None)])


#: λ of the service phase's batches (one for a whole coalesced batch): the
#: triangle-hub shape's in bench_service.py, at which its hub and the star's
#: are heavy, so the mix runs HashPartition and SemiJoin stages too
SERVICE_LAM = 16


def service_queries():
    """The mixed workload of benchmarks/bench_service.py (triangle-hub,
    star-hub-cp, disconnected) and two patterns compiled to queries: clique4
    over bench_subgraph.py's skewed "hubs" graph and cycle4 over its ER
    graph: (name, query)."""
    from repro_torch.core.query import disconnected_query, hub_star_query, hub_triangle_query
    from repro_torch.graph import compile_pattern, clique, cycle

    graphs = {name: g for name, g, _, _ in subgraph_cases()}
    return [("triangle-hub", hub_triangle_query(n=300, hub_n=80, dom_size=40, hub=10_000)),
            ("star-hub-cp", hub_star_query(n=90, hub_n=40, dom_size=25)),
            ("disconnected", disconnected_query(120, dom_size=14, skew=1.8)),
            ("clique4-hubs", compile_pattern(graphs["triangle-hubs"], clique(4)).query),
            ("cycle4-er2k", compile_pattern(graphs["cycle4-er2k"], cycle(4)).query)]


def same_rows(a, b) -> bool:
    return (a.count == b.count and a.per_h_counts == b.per_h_counts
            and a.rows.dtype == b.rows.dtype and a.rows.tobytes() == b.rows.tobytes())


def phase_service(torch, device="cuda", clients: int = 8, per_client: int = 32,
                  perm_rows: int = 20000) -> dict:
    """The async service on one card session (p=64, λ = ``SERVICE_LAM``): a
    coalesced mixed batch byte-identical to serial submits;
    ``clients`` threads × ``per_client`` ``submit_async`` requests, every
    future resolved with the serial rows (queue-inclusive p50/p99 logged);
    one coalesced group under a FaultPlan that fails one member's dispatch:
    that member fails alone with QueryFailedError, its batchmates stay
    byte-identical, and the session is not degraded."""
    import threading

    from repro_torch.mpc import FaultPlan, FaultRule, JoinSession, QueryFailedError

    reset_counts()
    t_phase = time.perf_counter()
    named = service_queries()
    serial_session = JoinSession(p=64, device=device)
    serial = {}
    for name, q in named:
        serial[name] = serial_session.submit(q, lam=SERVICE_LAM)
        log(f"[service] serial {name}: {serial[name].count} rows, "
            f"{serial[name].total_us / 1e3:.1f} ms cold")

    session = JoinSession(p=64, device=device)
    for rnd in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = session.submit_coalesced([q for _, q in named], lam=SERVICE_LAM)
        wall = time.perf_counter() - t0
        for (name, _), r in zip(named, outs):
            if not same_rows(r, serial[name]):
                raise AssertionError(f"service: coalesced {name} differs from serial")
        log(f"[service] submit_coalesced of {len(named)} queries ({rnd}): {wall:.3f} s, "
            f"byte-identical to serial submits")

    results, errors = {}, []

    def client(c):
        try:
            futs = [(i, session.submit_async(named[(c + i) % len(named)][1], lam=SERVICE_LAM))
                    for i in range(per_client)]
            for i, f in futs:
                results[(c, i)] = f.result(timeout=600)
        except BaseException as e:      # raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or errors:
        raise AssertionError(f"service: async clients failed or hung: {errors[:1]}")
    if len(results) != clients * per_client:
        raise AssertionError(f"service: {len(results)} of {clients * per_client} futures")
    for (c, i), r in results.items():
        name = named[(c + i) % len(named)][0]
        if not same_rows(r, serial[name]):
            raise AssertionError(f"service: async {name} differs from serial")
    p50, p99 = (session.stats.percentile(q, window="e2e") / 1e3 for q in (50, 99))
    log(f"[service] submit_async: {clients} clients x {per_client} requests in {wall:.3f} s "
        f"({clients * per_client / wall:.1f} queries/s), every future resolved with the serial "
        f"rows; queue-inclusive latency p50 {p50:.1f} ms, p99 {p99:.1f} ms; "
        f"{session.stats.coalesced_batches} coalesced batches, largest "
        f"{session.stats.max_coalesced_batch}, deduped {session.stats.deduped}, retries "
        f"{session.stats.retries}")
    session.close()

    perms = [perm_query(seed, perm_rows) for seed in (10, 11, 12, 13)]
    perm_serial = [serial_session.submit(q, lam=SERVICE_LAM) for q in perms]
    faulty = JoinSession(p=64, device=device, async_autostart=False,
                         fault_plan=FaultPlan([FaultRule(site="dispatch", rate=1.0, count=2)]))
    futs = [faulty.submit_async(q, lam=SERVICE_LAM) for q in perms]
    faulty.close()          # one inline drain batch: one coalesced group
    outs = []
    for f in futs:
        try:
            outs.append(f.result(timeout=0))
        except BaseException as e:
            outs.append(e)
    if not isinstance(outs[0], QueryFailedError) or outs[0].query is not perms[0]:
        raise AssertionError(f"service: the poisoned member resolved with {outs[0]!r}")
    for r, want in zip(outs[1:], perm_serial[1:]):
        if isinstance(r, BaseException) or not same_rows(r, want):
            raise AssertionError(f"service: a batchmate of the poisoned member: {r!r}")
    if faulty.degraded or faulty.stats.degraded_fallbacks != 1 or faulty.stats.failed != 1:
        raise AssertionError("service: the fault left the session degraded or miscounted")
    log(f"[service] fault plan failing one member's dispatch: it resolved with "
        f"QueryFailedError, its 3 batchmates byte-identical to serial, session not degraded "
        f"({faulty.fault_plan.injected['dispatch']} injected, 1 serial fallback)")
    launches = check_path_launches("service")
    log(f"[service] ok in {time.perf_counter() - t_phase:.1f} s")
    return {"p50_ms": p50, "p99_ms": p99, "async_wall_s": wall, "launches": launches}


# ---------------------------------------------------------------------------
# The static verifier on the card and the metered simulator on the host
# ---------------------------------------------------------------------------

#: benchmarks/bench_load_vs_p.py's Theorem 6.2 exponent sweep: one query per
#: (family, distribution), fixed across p (its gate: uniform slopes within
#: ``SLOPE_TOL`` of -1/rho)
SWEEP_P = (8, 16, 32, 64, 128, 256)
SWEEP_FAMILIES = (("triangle", "clique", 3), ("cycle4", "cycle", 4), ("star3", "star", 3))
SWEEP_DISTS = (("uniform", 0.0), ("zipf1.5", 1.5))
SWEEP_TUPLES = 2000
SLOPE_TOL = 0.25


def submit_timed(torch, session, query, lam):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = session.submit(query, lam=lam)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_verify(torch, plain_session, heavy, device="cuda") -> dict:
    """The static verifier in front of the card's dataplane: a
    ``JoinSession(p=64, verify=True)`` over bench_subgraph.py's four cases
    and phase 4's heavy query, cold and warm.  Every cold submit runs the
    full verifier (``verified``, ``verify_us`` > 0, with the executor's
    learned capacities), every warm one only the bindings re-check (less
    time); rows byte-identical to the unverified ``plain_session``; the
    learned capacities on the cap grid; ``RunConfig(verify=True)`` of the
    heavy program passes, and the same program with its RouteResidual
    dropped raises ``ProgramVerificationError`` ("collective-stream",
    "step1") with no kernel launched.  → the occurrences per case."""
    from dataclasses import replace

    from repro_torch.core.taxonomy import compute_stats
    from repro_torch.graph import compile_pattern, postprocess_rows
    from repro_torch.mpc import (JoinSession, ProgramVerificationError, RouteResidual,
                                 RunConfig, compile_plan)
    from repro_torch.mpc.verify import verify_caps

    t_phase = time.perf_counter()
    jobs = [(name, compile_pattern(g, pat), lam) for name, g, pat, lam in subgraph_cases()]
    jobs.append(("heavy", None, 24))
    # the unverified session's rows first, so that the launch counts read
    # below are the verified session's own
    plains = {}
    for name, compiled, lam in jobs:
        q = heavy["query"] if compiled is None else compiled.query
        plains[name] = plain_session.submit(q, lam=lam)
        if plain_session.verify or plains[name].verified:
            raise AssertionError("verify: the comparison session verified")
    torch.cuda.synchronize()

    reset_counts()
    session = JoinSession(p=64, device=device, verify=True)
    if session.executor.device.type != torch.device(device).type:
        raise AssertionError(f"verify: the session runs on {session.executor.device}")
    out = {}
    for name, compiled, lam in jobs:
        q = heavy["query"] if compiled is None else compiled.query
        cold, cold_s = submit_timed(torch, session, q, lam)
        warm, warm_s = submit_timed(torch, session, q, lam)
        plain = plains[name]
        if not (cold.verified and cold.verify_us > 0 and not cold.plan_cache_hit):
            raise AssertionError(f"verify {name}: the cold submit was not verified: "
                                 f"verified={cold.verified} verify_us={cold.verify_us}")
        if not (warm.plan_cache_hit and not warm.verified and warm.verify_us < cold.verify_us):
            raise AssertionError(f"verify {name}: warm verify_us {warm.verify_us} is not a "
                                 f"bindings re-check below the cold {cold.verify_us}")
        for label, other in (("the unverified session", plain), ("the warm submit", warm)):
            if not same_rows(cold, other):
                raise AssertionError(f"verify {name}: rows differ from {label}")
        log(f"[verify] {name} (lambda={lam}): {cold.count} rows byte-identical to the "
            f"unverified session; verify_us cold {cold.verify_us:.1f} (full pass, "
            f"{cold.total_us / 1e3:.1f} ms total), warm {warm.verify_us:.1f} (bindings, "
            f"{warm.total_us / 1e3:.1f} ms total); wall cold {cold_s:.3f} s, warm {warm_s:.3f} s")
        out[name] = {"verify_us_cold": cold.verify_us, "verify_us_warm": warm.verify_us,
                     "occurrences": (None if compiled is None
                                     else postprocess_rows(compiled, cold.rows))}
    if session.stats.verified != len(jobs):
        raise AssertionError(f"verify: {session.stats.verified} full passes for {len(jobs)} "
                             "cold submits")
    n_caps = verify_caps(session.executor._learned_caps)
    log(f"[verify] {n_caps} learned capacities of the card's executor on the cap grid")

    q = heavy["query"]
    prog = compile_plan(q, compute_stats(q, 24), 64, verify=False)
    res = session.executor.run(prog, config=RunConfig(verify=True))
    if res.rows.tobytes() != heavy["cold"]["res"].rows.tobytes():
        raise AssertionError("verify: RunConfig(verify=True) rows differ from phase 4's")
    broken = replace(prog, ops=tuple(op for op in prog.ops if not isinstance(op, RouteResidual)))
    torch.cuda.synchronize()
    before = launch_counts(JOIN_KERNELS)
    try:
        session.executor.run(broken, config=RunConfig(verify=True))
    except ProgramVerificationError as e:
        if (e.rule, e.op_round) != ("collective-stream", "step1"):
            raise AssertionError(f"verify: broken program failed {e.rule}/{e.op_round}") from e
        log(f"[verify] program with RouteResidual dropped: ProgramVerificationError "
            f"({e.rule}, {e.op_round}) before any kernel")
    else:
        raise AssertionError("verify: the program with RouteResidual dropped ran")
    torch.cuda.synchronize()
    if launch_counts(JOIN_KERNELS) != before:
        raise AssertionError("verify: kernels launched for the rejected program")
    out["launches"] = check_path_launches("verify")
    del session
    torch.cuda.empty_cache()
    log(f"[verify] ok in {time.perf_counter() - t_phase:.1f} s")
    return out


def recorded_slopes() -> dict:
    """The slopes of BENCH_load_vs_p.json's newest snapshot (for the log)."""
    path = ROOT / "BENCH_load_vs_p.json"
    if not path.exists():
        return {}
    snaps = json.loads(path.read_text())
    snap = snaps[-1] if isinstance(snaps, list) else snaps
    return {k: v["slope"] for k, v in snap.get("slopes", {}).items()}


def hub_query(kind: str, n_attrs: int, n: int, rng):
    """benchmarks/bench_load_vs_p.py's adversarial hub: one super-heavy value
    on the first attribute."""
    from repro_torch.core.query import JoinQuery, Relation, pattern_edges

    rels = []
    for e in pattern_edges(kind, n_attrs):
        if e[0] == "X0":
            data = np.stack([np.zeros(n, np.int64), np.arange(n)], axis=1)
        elif e[1] == "X0":
            data = np.stack([np.arange(n), np.zeros(n, np.int64)], axis=1)
        else:
            data = rng.integers(0, n, size=(n, 2))
        rels.append(Relation.make(e, data))
    return JoinQuery.make(rels)


def phase_simulator(verified) -> dict:
    """The metered MPC simulator on the host, held against the card:
    (a) bench_subgraph.py's four cases through
    ``enumerate_subgraphs(backend="simulator", p=64)`` at the canonical
    λ = ``heavy_parameter(64, rho)`` (the load model's premise),
    occurrences byte-equal to the card's in phase verify and ``check_load``
    passing on each;
    (b) bench_load_vs_p.py's Theorem 6.2 exponent sweep (3 families ×
    uniform/zipf1.5 × p in 8..256, ``SimulatorExecutor(p).run``), the max
    data-round load fitted on a log-log line: ``check_load`` passes in all
    36 runs and each uniform slope is within ``SLOPE_TOL`` of -1/rho;
    (c) ``all_icp_checks`` on bench_isolated_cp.py's hub star (λ = 4, 8,
    16): every left-hand side within Theorem 5.4's and Lemma 5.5's bounds."""
    import math

    from repro_torch.analysis import DATA_ROUNDS
    from repro_torch.core.hypergraph import rho
    from repro_torch.core.icp import all_icp_checks
    from repro_torch.core.planner import heavy_parameter
    from repro_torch.core.query import random_query
    from repro_torch.core.taxonomy import compute_stats
    from repro_torch.graph import compile_pattern, enumerate_subgraphs
    from repro_torch.mpc import SimulatorExecutor, compile_plan
    from repro_torch.mpc.verify import check_load

    t_phase = time.perf_counter()
    out = {"subgraph": {}, "slopes": {}, "icp": {}}
    for name, g, pat, _ in subgraph_cases():
        q = compile_pattern(g, pat).query
        card = verified[name]["occurrences"]
        # the load model bounds programs planned at the canonical lambda; the
        # occurrences do not depend on lambda, so the card's (at the bench's
        # own lambda) must equal these byte for byte
        lam = heavy_parameter(64, float(rho(q)))
        t0 = time.perf_counter()
        res = enumerate_subgraphs(g, pat, p=64, backend="simulator", lam=lam)
        host_s = time.perf_counter() - t0
        if (res.occurrences.shape != card.shape
                or res.occurrences.tobytes() != card.tobytes()):
            raise AssertionError(f"simulator {name} lambda={lam}: occurrences differ "
                                 "from the card's")
        prog = compile_plan(q, compute_stats(q, lam), 64, verify=False)
        fractions = check_load(prog, res.engine)
        run = res.engine
        log(f"[simulator] {name} (p=64, canonical lambda={lam}): {res.count} occurrences "
            f"byte-equal to the card's; load {run.load} words, bound {run.bound:.1f}, "
            f"load_ratio {run.load_ratio:.3f}; check_load passes (largest round share "
            f"{max(fractions.values()):.3f}); {host_s:.2f} s on the host")
        out["subgraph"][name] = {"load": run.load, "bound": run.bound,
                                 "load_ratio": run.load_ratio}

    recorded = recorded_slopes()
    runs = 0
    for family, kind, k in SWEEP_FAMILIES:
        for dist, skew in SWEEP_DISTS:
            q = random_query(np.random.default_rng(11), kind, k, tuples_per_rel=SWEEP_TUPLES,
                             dom_size=SWEEP_TUPLES, skew=skew)
            rho_val = float(rho(q))
            xs, ys, worst = [], [], 0.0
            for p in SWEEP_P:
                lam = heavy_parameter(p, rho_val)
                prog = compile_plan(q, compute_stats(q, lam), p, verify=False)
                res = SimulatorExecutor(p=p).run(prog, materialize=False)
                worst = max(worst, max(check_load(prog, res).values()))
                loads = res.sim.merged_round_loads()
                max_data = max((v for r, v in loads.items() if r in DATA_ROUNDS), default=0)
                xs.append(math.log(p))
                ys.append(math.log(max(1, max_data)))
                runs += 1
            slope = float(np.polyfit(xs, ys, 1)[0])
            drift = abs(slope + 1.0 / rho_val)
            key = f"{family}/{dist}"
            gated = dist == "uniform"
            log(f"[simulator] load vs p {key} (m={q.m}, rho={rho_val:g}): slope {slope:.4f}, "
                f"expected {-1.0 / rho_val:.4f}, drift {drift:.4f} "
                f"({'gated' if gated else 'not gated'}); BENCH_load_vs_p.json "
                f"{recorded.get(key, 'n/a')}; check_load passes at every p (largest round "
                f"share {worst:.3f})")
            if gated and drift > SLOPE_TOL:
                raise AssertionError(f"simulator: {key} slope {slope:.4f} drifts {drift:.4f} "
                                     f"> {SLOPE_TOL} from -1/rho")
            out["slopes"][key] = slope
    if runs != len(SWEEP_FAMILIES) * len(SWEEP_DISTS) * len(SWEEP_P):
        raise AssertionError(f"simulator: {runs} sweep runs")

    q = hub_query("star", 4, 1500, np.random.default_rng(2))
    for lam in (4, 8, 16):
        checks = all_icp_checks(q, compute_stats(q, lam))
        w54 = max((c.lhs / max(c.rhs_thm54, 1e-9) for c in checks), default=0.0)
        w55 = max((c.lhs / max(c.rhs_lem55, 1e-9) for c in checks), default=0.0)
        bad = [c for c in checks
               if c.lhs > c.rhs_thm54 + 1e-9 or c.lhs > c.rhs_lem55 + 1e-9]
        if bad or not checks:
            raise AssertionError(f"simulator: ICP bound broken at lambda={lam}: {bad[:3]}")
        log(f"[simulator] ICP hub star (1500 tuples, lambda={lam}): {len(checks)} (H, J) "
            f"pairs, {sum(c.lhs > 0 for c in checks)} nonzero; worst lhs/thm5.4 {w54:.4f}, "
            f"worst lhs/lem5.5 {w55:.4f}")
        out["icp"][lam] = (w54, w55)
    log(f"[simulator] ok in {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# The general (arbitrary-arity) route: SSB star join, forced-general
# triangle, bench_acyclic.py's battery
# ---------------------------------------------------------------------------

#: Star Schema Benchmark, scale factor 1 (O'Neil, O'Neil, Chen, Revilak,
#: TPCTC 2009): lineorder rows (the spec's SF x 6,000,000; 6,001,215 is the
#: TPC-H SF1 lineitem count lineorder derives from), and the customer /
#: supplier / part rows with the domains of c_nation, s_nation and p_brand1
SSB_SF1 = dict(fact=6_001_215, customers=30_000, suppliers=2_000, parts=200_000,
               nations=25, brands=1_000)
SSB_SEED = 18
#: SSB Q4.1's dimension predicates (c_region = 'AMERICA', s_region =
#: 'AMERICA', p_mfgr in ('MFGR#1', 'MFGR#2')) on this generator's codes:
#: region = nation // 5 (25 nations in 5 regions; AMERICA is region 1),
#: manufacturer = brand // 200 (1,000 brands = 5 manufacturers x 5
#: categories x 40 brands)
SSB_Q41 = dict(region=1, mfgrs=(0, 1))


def ssb_tables(fact_rows: int) -> tuple:
    """SSB SF1's key columns, uniform and independent at SF1's cardinalities.
    No generator's own draws are reproduced (in TPC-H's, which SSB's dbgen
    derives from, orders skip every third customer and the supplier follows
    the part through partsupp).  → (fact (n, 3) lo_custkey, lo_suppkey,
    lo_partkey; c_nation, s_nation, p_brand1 indexed by key - 1)."""
    sf = SSB_SF1
    rng = np.random.default_rng(SSB_SEED)
    fact = np.stack([rng.integers(1, sf["customers"] + 1, fact_rows),
                     rng.integers(1, sf["suppliers"] + 1, fact_rows),
                     rng.integers(1, sf["parts"] + 1, fact_rows)], axis=1)
    c_nation = rng.integers(0, sf["nations"], sf["customers"])
    s_nation = rng.integers(0, sf["nations"], sf["suppliers"])
    p_brand = rng.integers(0, sf["brands"], sf["parts"])
    return fact, c_nation, s_nation, p_brand


def ssb_star_query(tables: tuple, q41: bool = False):
    """SSB as the ``star3`` family: F(A,B,C) = lineorder's (lo_custkey,
    lo_suppkey, lo_partkey); (A,A1) = customer (c_custkey, c_nation), (B,B1)
    = supplier (s_suppkey, s_nation), (C,C1) = part (p_partkey, p_brand1).
    With ``q41`` the dimensions keep only the rows Q4.1's predicates select,
    so both Yannakakis sweeps drop rows.  → (query, oracle rows over (A, A1,
    B, B1, C, C1) sorted, the oracle's row count, distinct fact rows)."""
    from repro_torch.core.query import general_pattern_schemes, query_from_arrays

    fact, *attrs = tables
    c_nation, s_nation, p_brand = attrs
    keep = [np.ones(len(v), dtype=bool) for v in attrs]
    if q41:
        keep = [c_nation // 5 == SSB_Q41["region"], s_nation // 5 == SSB_Q41["region"],
                np.isin(p_brand // 200, SSB_Q41["mfgrs"])]
    dims = [np.stack([np.flatnonzero(k) + 1, v[k]], axis=1) for k, v in zip(keep, attrs)]
    schemes = general_pattern_schemes("star3")
    if schemes != [("A", "B", "C"), ("A", "A1"), ("B", "B1"), ("C", "C1")]:
        raise AssertionError(f"star3 schemes changed: {schemes}")
    q = query_from_arrays([(s, d, None) for s, d in zip(schemes, [fact] + dims)])
    f = q.relations[0].data      # distinct fact rows (Relation.make)
    f_kept = f[keep[0][f[:, 0] - 1] & keep[1][f[:, 1] - 1] & keep[2][f[:, 2] - 1]]
    oracle = np.stack([f_kept[:, 0], c_nation[f_kept[:, 0] - 1], f_kept[:, 1],
                       s_nation[f_kept[:, 1] - 1], f_kept[:, 2], p_brand[f_kept[:, 2] - 1]],
                      axis=1)
    return q, sorted_rows(oracle), f_kept.shape[0], f.shape[0]


def sorted_rows(rows: np.ndarray) -> np.ndarray:
    """Rows in lexicographic order (an order-free comparison of multisets)."""
    rows = np.asarray(rows, dtype=np.int64)
    return rows[np.lexsort(rows.T[::-1])] if rows.shape[0] else rows


def acyclic_cases():
    """The four cases of benchmarks/bench_acyclic.py:48-54 (same seeds, the
    port's generator): (name, query, lambda), run at p=8."""
    from repro_torch.core.query import general_query

    return [("star3", general_query("star3", n=240, dom_size=20, skew=0.8, seed=11), 8),
            ("snowflake", general_query("snowflake", n=200, dom_size=18, skew=0.8, seed=12), 8),
            ("path4", general_query("path4", n=200, dom_size=16, skew=0.5, seed=13), 8),
            ("triangle-general", general_query("triangle", n=260, dom_size=24, skew=1.2,
                                               seed=14), 8)]


def phase_general(torch, main3, capture: InputCapture, device="cuda",
                  fact_rows=SSB_SF1["fact"]) -> dict:
    """The general (arbitrary-arity) route through ``JoinSession.submit``:
    (a) ``ssb-star-sf1``: SSB SF1's lineorder ⋈ customer ⋈ supplier ⋈ part
    as ``star3`` (Yannakakis sweeps, share route, cell join), p=64, default
    λ, ``verify=True``: the count equals the distinct fact rows, the rows
    equal the numpy oracle after sorting, warm rows byte-identical to cold,
    warm retries 0 on a plan-cache hit, all three join kernels launched
    (halving the fact rows while the card's memory runs out), then one
    untimed submit for each op's peak memory and two more warm submits
    under cProfile and torch.profiler;
    (b) ``ssb-q41``: the same tables with the dimensions cut to SSB Q4.1's
    predicates, so both sweeps drop fact rows: rows against the numpy
    oracle, then one more submit in which every call of the three join
    kernels is held against its plain version (and must meet probe keys
    that match nothing);
    (c) ``triangle-2M-general``: phase 3's oriented table with
    ``force_general=True`` (the generalized HyperCube), p=64, default λ:
    as a sorted set equal to phase 3's binary-route rows;
    (d) ``acyclic-bench``: bench_acyclic.py's four cases at p=8 on the card,
    rows byte-identical to ``JoinSession(p=8, device="cpu")``, equal as
    sorted sets to ``backend="simulator"``, count equal to
    ``reference_join``, ``check_load`` within its bound.  Launches are
    counted over the card's submits alone; ``capture`` keeps the largest
    kernel inputs of the timed submits of (a)-(c) for phase 6."""
    from repro_torch.core.query import query_from_arrays, reference_join
    from repro_torch.mpc import JoinSession, QueryFailedError
    from repro_torch.mpc.verify import check_load

    t_phase = time.perf_counter()
    out = {}
    # host-side comparisons first, so the launch counts are the card's alone
    bench = []
    for name, q, lam in acyclic_cases():
        t0 = time.perf_counter()
        oracle = reference_join(q)
        cpu = JoinSession(p=8, device="cpu").submit(q, lam=lam)
        sim_session = JoinSession(p=8, backend="simulator")
        sim = sim_session.submit(q, lam=lam)
        # the session caches its plans unbound from their data
        fractions = check_load(sim_session._plans[sim.plan_key].rebind(q), sim.result)
        if not cpu.count == sim.count == len(oracle):
            raise AssertionError(f"general {name}: counts cpu {cpu.count}, simulator "
                                 f"{sim.count}, reference_join {len(oracle)}")
        if sorted_rows(sim.rows).tobytes() != sorted_rows(oracle.data).tobytes():
            raise AssertionError(f"general {name}: simulator rows differ from reference_join")
        log(f"[general] {name} host side: {len(oracle)} rows; CPU session and simulator "
            f"agree with reference_join; check_load passes (largest round share "
            f"{max(fractions.values()):.4f}, rounds {sorted(fractions)}); load "
            f"{sim.result.load} words, load_ratio {sim.result.load_ratio:.3f}; "
            f"{time.perf_counter() - t0:.2f} s")
        bench.append((name, q, lam, cpu, sim))
    torch.cuda.synchronize()

    def check_star(tag, cold, warm, oracle, want):
        res = cold["res"]
        if res.count != want or res.result.per_h_counts != {("*",): want}:
            raise AssertionError(f"general {tag}: count {res.count} "
                                 f"({res.result.per_h_counts}) != the oracle's {want}")
        if sorted_rows(res.rows).tobytes() != oracle.tobytes():
            raise AssertionError(f"general {tag}: rows differ from the numpy oracle")
        if not (res.verified and cold["verify_us"] > 0):
            raise AssertionError(f"general {tag}: the cold submit was not verified")
        for name in JOIN_KERNELS:
            if cold["launches"][name] <= 0 or warm["launches"][name] <= 0:
                raise AssertionError(f"general {tag}: {name} did not launch")

    reset_counts()
    session = JoinSession(p=64, device=device, verify=True)
    fact = fact_rows
    while True:
        t0 = time.perf_counter()
        tables = ssb_tables(fact)
        q, oracle, want, distinct = ssb_star_query(tables)
        setup_s = time.perf_counter() - t0
        try:
            with capture:
                cold, warm = cold_warm(torch, session, q, None,
                                       f"general/ssb-star-sf1 fact={fact}")
        except QueryFailedError as e:
            if not isinstance(e.cause, torch.cuda.OutOfMemoryError):
                raise
            log(f"[general] ssb-star-sf1 with {fact} fact rows ran out of device memory: "
                "halving the fact rows")
            torch.cuda.empty_cache()
            fact //= 2
            continue
        break
    if want != distinct:
        raise AssertionError(f"general ssb-star-sf1: the oracle drops fact rows ({want} of "
                             f"{distinct}): a dimension misses a key")
    check_star("ssb-star-sf1", cold, warm, oracle, want)
    peaks = op_peaks(torch, session, q, None, "general/ssb-star-sf1")
    log(f"[general] ssb-star-sf1 ok: {fact} fact draws, {distinct} distinct = count = the "
        f"numpy oracle's rows; host set-up {setup_s:.1f} s; cold {cold['wall_s']:.3f} s, "
        f"warm {warm['wall_s']:.3f} s; peak device memory "
        f"{max(cold['peak_device_bytes'], warm['peak_device_bytes']) / 2**30:.2f} GiB "
        f"({warm['base_device_bytes'] / 2**30:.2f} GiB allocated before the warm submit)")
    out["ssb-star-sf1"] = {"fact": fact, "distinct": distinct, "cold": cold, "warm": warm,
                           "peaks_by_op": peaks}
    # where a warm general submit's time goes: host functions and the card's
    # busy share
    phase_profile(torch, session, q, None)
    del q, oracle, cold, warm
    torch.cuda.empty_cache()

    q, oracle, want, distinct = ssb_star_query(tables, q41=True)
    with capture:
        cold, warm = cold_warm(torch, session, q, None, "general/ssb-q41")
    if not 0 < want < distinct:
        raise AssertionError(f"general ssb-q41: the oracle keeps {want} of {distinct} "
                             f"fact rows: the sweeps would drop nothing")
    check_star("ssb-q41", cold, warm, oracle, want)
    with InputCapture(check=True) as checker:
        checked = session.submit(q)
    torch.cuda.synchronize()
    if not same_rows(checked, cold["res"]):
        raise AssertionError("general ssb-q41: the checked submit's rows differ from cold")
    for name in JOIN_KERNELS:
        if checker.checked.get(name, 0) <= 0:
            raise AssertionError(f"general ssb-q41: the checked submit never called {name}")
    if checker.unmatched <= 0:
        raise AssertionError("general ssb-q41: no probe key went unmatched")
    log(f"[general] ssb-q41 ok: Q4.1's dimensions ({sum(len(r) for r in q.relations[1:])} "
        f"rows) keep {want} of {distinct} fact rows = count = the numpy oracle's rows; "
        f"cold {cold['wall_s']:.3f} s, warm {warm['wall_s']:.3f} s; one more submit held "
        f"every kernel call against its plain version, bit for bit: calls "
        f"{json.dumps(checker.checked)}, {checker.unmatched} probe keys matched nothing, "
        f"largest inputs {json.dumps(checker.largest)}")
    out["ssb-q41"] = {"kept": want, "distinct": distinct, "cold": cold, "warm": warm,
                      "checked": checker.checked, "unmatched": checker.unmatched}
    del q, oracle, cold, warm, checked, tables
    torch.cuda.empty_cache()

    q = query_from_arrays([(("A", "B"), main3["oriented"], "E"),
                           (("B", "C"), main3["oriented"], "E"),
                           (("A", "C"), main3["oriented"], "E")], force_general=True)
    with capture:
        cold, warm = cold_warm(torch, session, q, None, "general/triangle-2M-general")
    plan = session._plans[cold["res"].plan_key].general
    binary = main3["cold"]["res"].rows
    if cold["count"] != main3["oracle"] or plan.kind != "hypercube":
        raise AssertionError(f"general triangle-2M-general: count {cold['count']} != "
                             f"{main3['oracle']} or plan {plan.kind}")
    if sorted_rows(cold["res"].rows).tobytes() != sorted_rows(binary).tobytes():
        raise AssertionError("general triangle-2M-general: rows differ from phase 3's "
                             "binary-route rows as a sorted set")
    peaks = op_peaks(torch, session, q, None, "general/triangle-2M-general")
    log(f"[general] triangle-2M-general ok: {cold['count']} rows = phase 3's binary-route "
        f"rows as a sorted set; shares {dict(plan.shares)}; cold {cold['wall_s']:.3f} s, "
        f"warm {warm['wall_s']:.3f} s; peak device memory "
        f"{max(cold['peak_device_bytes'], warm['peak_device_bytes']) / 2**30:.2f} GiB "
        f"({warm['base_device_bytes'] / 2**30:.2f} GiB allocated before the warm submit)")
    out["triangle-2M-general"] = {"cold": cold, "warm": warm, "peaks_by_op": peaks}
    del q, cold, warm, binary
    torch.cuda.empty_cache()

    card = JoinSession(p=8, device=device)
    out["acyclic-bench"] = {}
    for name, q, lam, cpu, sim in bench:
        cold, warm = cold_warm(torch, card, q, lam, f"general/acyclic-bench {name}")
        if not same_rows(cold["res"], cpu):
            raise AssertionError(f"general {name}: card rows differ from the CPU session's")
        if sorted_rows(cold["res"].rows).tobytes() != sorted_rows(sim.rows).tobytes():
            raise AssertionError(f"general {name}: card rows differ from the simulator's")
        log(f"[general] acyclic-bench {name} (p=8, lambda={lam}) ok: {cold['count']} rows "
            f"byte-identical to the CPU session, equal to the simulator's as sorted sets; "
            f"cold {cold['wall_s']:.3f} s, warm {warm['wall_s']:.3f} s")
        out["acyclic-bench"][name] = {"cold": cold, "warm": warm}
    out["launches"] = check_path_launches("general")
    del session, card
    torch.cuda.empty_cache()
    log(f"[general] ok in {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_timing_general(torch, capture: InputCapture) -> None:
    """Phase 6, continued: each join kernel held against its plain version
    on the largest inputs the general phase's timed submits gave it, bit for
    bit, and timed beside it (log lines, not rows of the ``kernels`` line:
    those stay at the inputs of phases 3-5)."""
    from repro_torch.kernels import ref

    hp, mj = kernel_modules()
    kernels = {"hash_partition_pack": hp.hash_partition_pack_cuda,
               "merge_join_counts": mj.merge_join_counts_cuda,
               "merge_join_pairs": mj.merge_join_pairs_cuda}
    for name in JOIN_KERNELS:
        if name not in capture.best:
            raise AssertionError(f"{name}: the general path never called it")
        _, args = capture.best[name]
        kern = lambda f=kernels[name], a=args: f(*a)
        plain = lambda f=getattr(ref, f"{name}_ref"), a=args: f(*a)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        if err != 0 or any(g.shape != w.shape for g, w in zip(got, want)):
            raise AssertionError(f"{name}: kernel differs from its plain version at the "
                                 f"general path's largest inputs")
        del got, want
        shape = [tuple(a.shape) if hasattr(a, "shape") else a for a in args]
        med, spread = time_rounds(torch, kern, plain, None)
        log(f"[timing] {name} at the general path's largest inputs {shape}: kernel "
            f"{med['kernel']:.4f} ms, plain {med['plain']:.4f} ms, max_abs_err 0; medians "
            f"of 5 rounds, range ms: {spread}")
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Serving: the LM serve path at full width (``repro_torch.models``)
# ---------------------------------------------------------------------------

#: the serve phase's models at their published width and depth
#: (src/repro_torch/configs/), the kernel each one's prefill runs once per
#: layer of the mixer named, and the name of that kernel's device functions
SERVE_CASES = (("serve-danube", "h2o-danube-1.8b", "flash_attention", "attn", r"flash_fwd"),
               ("serve-mamba2", "mamba2-780m", "ssd_chunk", "mamba", r"ssd_"))
# the load: batch x prompt tokens (within danube's 4096-token window, a multiple
# of mamba2's 256-step chunk), then greedy decode steps
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2048, 64
# the card against the CPU: the same models cut to 2 layers, in float32, one
# 256-token prompt and 8 greedy steps; logits within 1e-3 + 1e-3·|CPU|
PARITY_LAYERS, PARITY_PROMPT, PARITY_STEPS, PARITY_TOL = 2, 256, 8, 1e-3
# cuBLAS's and CUTLASS's matrix-product kernels, by name
MATMUL_KERNELS = re.compile(r"gemm|nvjet|xmma|cutlass|s16816|wgmma|matmul", re.I)


def serve_prefill(torch, cfg, model, batch, cache_len: int):
    """One prefill timed by the host clock, ending in a synchronize →
    (last-token logits, cache, ms)."""
    from repro_torch.models.model import prefill

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = prefill(cfg, model, batch, cache_len=cache_len)
    torch.cuda.synchronize()
    return logits, cache, (time.perf_counter() - t0) * 1e3


def profile_run(torch, fn, kernel_names: str) -> dict:
    """``fn()`` once under torch.profiler (``fn`` sets its own grad mode): the
    device time, the shares of it spent
    in the hand kernel (device functions matching ``kernel_names``) and in matrix
    products, the idle share of the wall clock (profiler overhead included), and
    the eight longest device functions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events)
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    kern = sum(e.self_device_time_total for e in events if re.search(kernel_names, e.key))
    mm = sum(e.self_device_time_total for e in events if MATMUL_KERNELS.search(e.key))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_us / 1e3, "device_ms": busy / 1e3, "kernel_share": kern / busy,
            "matmul_share": mm / busy, "other_share": 1 - (kern + mm) / busy,
            "idle_share": max(0.0, 1 - busy / wall_us),
            "device_ops": sum(e.count for e in events),
            "top": [[e.key[:70], round(e.self_device_time_total / 1e3, 3), e.count]
                    for e in top]}


def serve_model(torch, dev, tag: str, arch: str, kernel: str, mixer: str,
                kernel_names: str, smi: str) -> dict:
    """One model at its published width and depth, random weights from a seeded
    generator on the card: a cold and a warm prefill of SERVE_BATCH x
    SERVE_PROMPT tokens and SERVE_STEPS greedy steps through ``make_serve_step``
    (the counts zeroed just before and read just after: ``kernel`` launches once
    per ``mixer`` layer per prefill, and never in decode) and one more decode
    step under torch.profiler; then one prefill with every kernel call held
    against its plain version, one that keeps the kernel's largest inputs, and
    one under torch.profiler."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import init_params
    from repro_torch.train.data import synth_batch
    from repro_torch.train.step import make_serve_step

    cfg = get_arch(arch)
    n_mixer = sum(cfg.block_at(i).mixer == mixer for i in range(cfg.n_layers))
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()          # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
    log(f"[serve] {tag}: {arch} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params:,} parameters ({weight_gib:.3f} GiB {cfg.dtype}) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    raw = synth_batch(cfg, step=0, global_batch=SERVE_BATCH, seq=SERVE_PROMPT)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items() if k != "labels"}
    cache_len = SERVE_PROMPT + SERVE_STEPS

    reset_counts()
    logits, cache, cold_ms = serve_prefill(torch, cfg, model, batch, cache_len)
    per_prefill = launch_counts([kernel])[kernel]
    if per_prefill != n_mixer:
        raise AssertionError(f"{tag}: {kernel} launched {per_prefill} times in one prefill, "
                             f"want one per {mixer} layer ({n_mixer})")
    del cache
    logits, cache, warm_ms = serve_prefill(torch, cfg, model, batch, cache_len)
    serve_step = make_serve_step(cfg)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    gen = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_STEPS):
        tok, logits, cache = serve_step(model, cache, tok)
        gen.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = launch_counts([kernel])[kernel]
    if launches != 2 * n_mixer:
        raise AssertionError(f"{tag}: {launches} {kernel} launches over two prefills and "
                             f"{SERVE_STEPS} decode steps, want {2 * n_mixer}")
    gen = torch.stack(gen, dim=1).cpu().numpy()
    if (gen.shape != (SERVE_BATCH, SERVE_STEPS + 1) or not bool(torch.isfinite(logits).all())
            or gen.min() < 0 or gen.max() >= cfg.vocab_padded
            or cache["pos"] != SERVE_PROMPT + SERVE_STEPS):
        raise AssertionError(f"{tag}: bad serve output {gen.shape}, pos {cache['pos']}")
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    step_prof = profile_run(torch, lambda: serve_step(model, cache, tok), kernel_names)
    log(f"[serve] {tag}: one profiled decode step on {smi}: {json.dumps(step_prof)}")
    tokens = SERVE_BATCH * SERVE_STEPS
    stats = {"cold_prefill_ms": cold_ms, "warm_prefill_ms": warm_ms,
             "decode_ms_per_step": decode_s * 1e3 / SERVE_STEPS,
             "decode_tokens_per_s": tokens / decode_s, "peak_gib": peak_gib,
             "launches_per_prefill": per_prefill}
    prefill_rate = SERVE_BATCH * SERVE_PROMPT / warm_ms * 1e3
    log(f"[serve] {tag} on {smi}: batch {SERVE_BATCH} x {SERVE_PROMPT} tokens, prefill cold "
        f"{cold_ms:.1f} ms, warm {warm_ms:.1f} ms ({prefill_rate:,.0f} tokens/s); "
        f"{SERVE_STEPS} greedy steps {decode_s * 1e3:.1f} ms "
        f"({stats['decode_ms_per_step']:.3f} ms/step, {stats['decode_tokens_per_s']:,.0f} "
        f"tokens/s); peak device memory {peak_gib:.3f} GiB above the {held / 2**30:.3f} GiB "
        f"held before the model; {kernel} launches {per_prefill} per prefill, {launches} "
        f"over the run; first row {gen[0][:12].tolist()}")
    del cache, logits

    with InputCapture(check=True, kernels=(kernel,)) as checker:
        serve_prefill(torch, cfg, model, batch, cache_len)
    if checker.checked.get(kernel, 0) != n_mixer:
        raise AssertionError(f"{tag}: the checked prefill held {checker.checked} calls")
    log(f"[serve] {tag}: checked prefill, {checker.checked[kernel]} {kernel} calls at "
        f"{checker.largest[kernel][1]} each within their limit of the plain version, "
        f"max |err| {checker.max_err[kernel]:.4g}")
    capture = InputCapture(kernels=(kernel,))
    with capture:
        serve_prefill(torch, cfg, model, batch, cache_len)
    prof = profile_run(torch, lambda: serve_prefill(torch, cfg, model, batch, cache_len),
                       kernel_names)
    stats.update({k: prof[k] for k in ("kernel_share", "matmul_share", "idle_share")})
    stats["decode_idle_share"] = step_prof["idle_share"]
    log(f"[serve] {tag}: profiled warm prefill on {smi}: {json.dumps(prof)}")
    del model, batch
    torch.cuda.empty_cache()
    return {"cfg": cfg, "launches": launches, "max_err": checker.max_err[kernel],
            "inputs": capture.best[kernel][1], "stats": stats}


def serve_parity(torch, dev, arch: str) -> dict:
    """The card against the CPU at full width, depth cut to PARITY_LAYERS, in
    float32: the same weights (drawn on the CPU from a seeded generator, then
    copied), one PARITY_PROMPT-token prompt, PARITY_STEPS greedy steps fed the
    CPU's tokens. Logits within PARITY_TOL + PARITY_TOL·|CPU|; the card's token
    equals the CPU's wherever the CPU's top-2 margin exceeds twice that limit
    (a smaller margin is logged, and its token not held)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.train.data import synth_batch

    cfg = replace(get_arch(arch), n_layers=PARITY_LAYERS, dtype="float32")
    cpu_model = init_params(cfg, seed=1, device="cpu")
    card = copy.deepcopy(cpu_model).to(dev)
    raw = synth_batch(cfg, step=1, global_batch=1, seq=PARITY_PROMPT)
    cpu_batch = {k: torch.from_numpy(v) for k, v in raw.items() if k != "labels"}
    cache_len = PARITY_PROMPT + PARITY_STEPS
    out = {"max_abs_err": 0.0, "held": 0, "not_held": []}

    def compare(want, got, what):
        got = got.float().cpu()
        lim = PARITY_TOL + PARITY_TOL * want.abs()
        err = (got - want).abs()
        if not bool(torch.isfinite(got).all()) or bool((err > lim).any()):
            raise AssertionError(f"{arch} depth {PARITY_LAYERS}: card logits differ from the "
                                 f"CPU's at {what} by {float(err.max())}")
        out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
        top2 = torch.topk(want, 2, dim=-1)
        for b in range(want.shape[0]):
            margin = float(top2.values[b, 0] - top2.values[b, 1])
            need = 2 * float(lim[b, top2.indices[b, 0]])
            card_tok, cpu_tok = int(got[b].argmax()), int(top2.indices[b, 0])
            if margin > need:
                if card_tok != cpu_tok:
                    raise AssertionError(f"{arch}: {what} token {card_tok} on the card, "
                                         f"{cpu_tok} on the CPU, margin {margin}")
                out["held"] += 1
            else:
                out["not_held"].append([what, margin, cpu_tok, card_tok])
                log(f"[serve] parity {arch}: {what} top-2 margin {margin:.3g} <= {need:.3g}: "
                    f"token not held (CPU {cpu_tok}, card {card_tok})")

    with torch.no_grad():
        want, cpu_cache = prefill(cfg, cpu_model, cpu_batch, cache_len=cache_len)
        got, card_cache = prefill(cfg, card, {k: v.to(dev) for k, v in cpu_batch.items()},
                                  cache_len=cache_len)
        compare(want, got, "prefill")
        for i in range(PARITY_STEPS):
            tok = torch.argmax(want, dim=-1).to(torch.int32)
            want, cpu_cache = decode_step(cfg, cpu_model, cpu_cache, tok)
            got, card_cache = decode_step(cfg, card, card_cache, tok.to(dev))
            compare(want, got, f"step {i}")
    log(f"[serve] parity {arch}, {PARITY_LAYERS} layers, float32, {PARITY_PROMPT}-token prompt "
        f"+ {PARITY_STEPS} steps, card against CPU: max |err| {out['max_abs_err']:.4g} "
        f"(limit {PARITY_TOL} + {PARITY_TOL}·|CPU|), {out['held']} tokens held equal, "
        f"{len(out['not_held'])} not held")
    del card, card_cache
    torch.cuda.empty_cache()
    return out


def phase_serve(torch, dev, smi: str) -> dict:
    """The serve phase: each of SERVE_CASES at full width and depth
    (``serve_model``), its kernel then timed at the largest inputs the serving
    run gave it (its ``kernels`` row: launches from the serving run, max |err|
    from the checked prefill), then each model's depth-cut card-against-CPU
    parity → the rows by kernel name."""
    rows = {}
    for tag, arch, kernel, mixer, names in SERVE_CASES:
        res = serve_model(torch, dev, tag, arch, kernel, mixer, names, smi)
        cfg, args = res["cfg"], res["inputs"]
        if kernel == "flash_attention":
            case = attention_case(torch, *args[:3], SERVE_BATCH, cfg.n_heads)
        else:
            case = ssd_case(torch, args[:5], args[5])
        rows[kernel] = library_row(torch, kernel, case, res["launches"], res["max_err"],
                                   f"serve {tag}", device_time=kernel == "ssd_chunk")
        log(f"[serve] {tag} summary on {smi}: {json.dumps(res['stats'])}")
        del res, args, case
        torch.cuda.empty_cache()
    for _, arch, _, _, _ in SERVE_CASES:
        serve_parity(torch, dev, arch)
    return rows


# ---------------------------------------------------------------------------
# Training: the LM training path at full width (``repro_torch.train``)
# ---------------------------------------------------------------------------

#: the train phase's models at their published width and depth, each in its
#: config's bf16 with its own ``remat`` ("nothing": every repeat of the pattern
#: runs its forward again in the backward), the kernel its forward runs once per
#: layer of the mixer named, and that kernel's device functions
TRAIN_CASES = (("train-danube", "h2o-danube-1.8b", "flash_attention", "attn", r"flash_fwd"),
               ("train-mamba2", "mamba2-780m", "ssd_chunk", "mamba", r"ssd_"))
# the load: batch x tokens of one repeated ``synth_batch`` (the serve phase's),
# steps, and the peak learning rate of ``launch/train.py``'s schedule for that many
# steps (warmup 2, cosine to 0.1 lr): the drivers' default 3e-4. h2o-danube-1.8b's
# loss doubles after the update at the peak rate, then falls below its first
# value within the run; at 1e-3 it stays above it
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 2048, 5, 3e-4
# the card against the CPU: the same models cut to 2 layers in float32, one step
# of batch 1 x 256; loss, gradients (against each leaf's largest |g|) and masters
# within 1e-3 + 1e-3·|CPU|
TRAIN_PARITY_SEQ, TRAIN_PARITY_ADAMW = 256, dict(lr=1e-3, warmup_steps=1, total_steps=10)
# AdamW's first update is lr·g/(|g| + 1e-8): where a gradient is zero within the
# gradient limit, the update's size and sign are decided by rounding; at most this
# share of the elements may leave the masters' limit, and only those
ROUNDING_DECIDED_MAX = 1e-5


def kernel_calls_per_step(cfg, mixer: str) -> int:
    """Kernel launches of one training step (one microbatch) of a decoder-only
    config: one per ``mixer`` layer per forward; with ``remat`` other than "none"
    the repeated pattern's layers run their forward a second time in the backward
    (the prefix layers are not rematerialised). The backward itself recomputes the
    plain function and launches no kernel. h2o-danube-1.8b: 24 x 2 = 48
    ``flash_attention``; mamba2-780m: 48 x 2 = 96 ``ssd_chunk``."""
    prefix = sum(b.mixer == mixer for b in cfg.prefix)
    repeated = sum(b.mixer == mixer for b in cfg.pattern) * cfg.n_repeats
    return prefix + repeated * (1 if cfg.remat == "none" else 2)


class GradCheck:
    """Wraps ``repro_torch.train.step.adamw_update`` while installed: times every
    call with CUDA events (``opt_ms``) and, on the first call, holds every
    gradient the step hands the optimizer to be finite and not identically zero
    (the guard against a kernel route whose output has no ``grad_fn``: the
    parameters before it would get zeros, or none); with ``keep`` it also keeps a
    CPU copy of each call's gradients (``grads``)."""

    def __init__(self, torch, tag: str, keep: bool = False):
        self.torch, self.tag, self.keep = torch, tag, keep
        self.opt_ms, self.grads, self.checked = [], [], 0

    def __enter__(self):
        from repro_torch.train import step as step_mod

        self._mod, self._orig = step_mod, step_mod.adamw_update
        torch = self.torch

        def wrapped(cfg, params, grads, state):
            if not self.checked:
                for name, p in params.items():
                    g = grads.get(name)
                    if g is None or g.shape != p.shape:
                        raise AssertionError(f"{self.tag}: {name} has no gradient")
                    if not bool(torch.isfinite(g).all()):
                        raise AssertionError(f"{self.tag}: {name}'s gradient is not finite")
                    if not bool((g != 0).any()):
                        raise AssertionError(f"{self.tag}: {name}'s gradient is identically 0")
                self.checked = len(params)
            if self.keep:
                self.grads.append({k: g.detach().float().cpu() for k, g in grads.items()})
            on_card = next(iter(params.values())).is_cuda
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            out = self._orig(cfg, params, grads, state)
            if on_card:
                end.record()
                end.synchronize()
                self.opt_ms.append(start.elapsed_time(end))
            return out

        step_mod.adamw_update = wrapped
        return self

    def __exit__(self, *exc):
        self._mod.adamw_update = self._orig
        return False


def train_model(torch, dev, tag: str, arch: str, kernel: str, mixer: str,
                kernel_names: str, smi: str) -> dict:
    """One model at its published width and depth, random weights from a seeded
    generator on the card, TRAIN_STEPS steps of ``make_train_step`` on one
    repeated TRAIN_BATCH x TRAIN_SEQ batch (the counts zeroed just before each
    step and read just after: exactly ``kernel_calls_per_step`` launches); every
    gradient of the first step finite and not identically zero; finite losses and
    grad norms, the last loss below the first; then the forward timed alone (the
    median of three), one step under torch.profiler and one with every kernel
    call held against its plain version."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.train.data import synth_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

    cfg = get_arch(arch)
    per_step = kernel_calls_per_step(cfg, mixer)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()          # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    # launch/train.py's schedule for --steps TRAIN_STEPS --lr TRAIN_LR
    tcfg = TrainConfig(adamw=AdamWConfig(lr=TRAIN_LR, warmup_steps=max(2, TRAIN_STEPS // 20),
                                         total_steps=TRAIN_STEPS))
    state = init_train_state(cfg, tcfg, model)
    step_fn = make_train_step(cfg, tcfg)
    raw = synth_batch(cfg, step=0, global_batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    torch.cuda.synchronize()
    state_gib = (torch.cuda.memory_allocated() - held) / 2**30
    log(f"[train] {tag}: {arch} {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}, "
        f"remat {cfg.remat!r}, {n_params:,} parameters; weights and optimizer state "
        f"{state_gib:.3f} GiB on the card; {kernel} expected {per_step} times a step")

    history, step_ms = [], []
    with GradCheck(torch, tag) as grad_check:
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            model, state, metrics = step_fn(model, state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            n = launch_counts([kernel])[kernel]
            if n != per_step:
                raise AssertionError(f"{tag}: step {i} launched {kernel} {n} times, want "
                                     f"{per_step}")
            history.append({k: float(metrics[k]) for k in ("loss", "ce", "grad_norm", "lr")})
    if grad_check.checked != len(list(model.parameters())):
        raise AssertionError(f"{tag}: the first step's gradients were not checked")
    losses = [h["loss"] for h in history]
    if not all(np.isfinite([h[k] for h in history for k in ("loss", "grad_norm")])):
        raise AssertionError(f"{tag}: a loss or grad norm is not finite: {history}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: the loss did not fall on the repeated batch: {losses}")
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    warm_ms = float(np.median(step_ms[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    opt_ms = float(np.median(grad_check.opt_ms[1:]))

    fwd_runs = []                   # the forward alone, graph kept; a median of 3
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss, _ = loss_fn(cfg, model, batch)
        torch.cuda.synchronize()
        fwd_runs.append((time.perf_counter() - t0) * 1e3)
        del loss
    fwd_ms = float(np.median(fwd_runs))
    bwd_ms = warm_ms - fwd_ms - opt_ms
    stats = {"cold_step_ms": step_ms[0], "warm_ms_per_step": warm_ms,
             "tokens_per_s": tokens / warm_ms * 1e3, "peak_gib": peak_gib,
             "state_gib": state_gib, "launches_per_step": per_step,
             "forward_ms": fwd_ms, "optimizer_ms": opt_ms, "backward_ms": bwd_ms,
             "backward_share": bwd_ms / warm_ms, "lr": TRAIN_LR,
             "loss": losses, "grad_norm": [h["grad_norm"] for h in history]}
    log(f"[train] {tag} on {smi}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"cold {step_ms[0]:.1f} ms, warm {warm_ms:.1f} ms a step "
        f"({stats['tokens_per_s']:,.0f} tokens/s; steps {[round(t, 1) for t in step_ms]}); "
        f"forward alone {fwd_ms:.1f} ms (median of {[round(t, 1) for t in fwd_runs]}), "
        f"optimizer {opt_ms:.1f} ms (CUDA events), backward "
        f"{bwd_ms:.1f} ms by difference ({stats['backward_share']:.3f} of the step); peak "
        f"device memory {peak_gib:.3f} GiB above the {held / 2**30:.3f} GiB held before; "
        f"{kernel} {per_step} launches every step; every gradient of step 0 finite and "
        f"nonzero ({grad_check.checked} tensors); lr {TRAIN_LR}; history {json.dumps(history)}")

    prof = profile_run(torch, lambda: step_fn(model, state, batch), kernel_names)
    stats.update({"kernel_share": prof["kernel_share"], "matmul_share": prof["matmul_share"],
                  "other_share": prof["other_share"], "idle_share": prof["idle_share"],
                  "step_device_ms": prof["device_ms"]})
    log(f"[train] {tag}: one profiled warm step on {smi}: {json.dumps(prof)}")

    with InputCapture(check=True, kernels=(kernel,)) as checker:
        step_fn(model, state, batch)
        torch.cuda.synchronize()
    if checker.checked.get(kernel, 0) != per_step:
        raise AssertionError(f"{tag}: the checked step held {checker.checked} calls, "
                             f"want {per_step}")
    log(f"[train] {tag}: checked step, {checker.checked[kernel]} {kernel} calls at "
        f"{checker.largest[kernel][1]} each within their limit of the plain version, "
        f"max |err| {checker.max_err[kernel]:.4g}")
    del model, state, batch, step_fn
    torch.cuda.empty_cache()
    return {"launches": per_step * TRAIN_STEPS, "per_step": per_step,
            "max_err": checker.max_err[kernel], "stats": stats}


def train_parity(torch, dev, arch: str) -> dict:
    """The card against the CPU at full width, depth cut to PARITY_LAYERS, in
    float32 (TF32 off): the same weights (drawn on the CPU, then copied), one
    ``make_train_step`` on one TRAIN_PARITY_SEQ-token row. The loss, every gradient
    (within PARITY_TOL of its leaf's largest |g| + PARITY_TOL·|g|) and every
    updated fp32 master within PARITY_TOL + PARITY_TOL·|CPU| (rounding-decided
    elements counted, at most ROUNDING_DECIDED_MAX of them); then the card's state
    through a ``CheckpointManager`` save / restore (and an async save), bit for bit,
    on the card's device and in each leaf's dtype."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.models.model import init_params
    from repro_torch.train.checkpoint import CheckpointManager, named_leaves
    from repro_torch.train.data import synth_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

    cfg = replace(get_arch(arch), n_layers=PARITY_LAYERS, dtype="float32")
    cpu_model = init_params(cfg, seed=1, device="cpu")
    card = copy.deepcopy(cpu_model).to(dev)
    tcfg = TrainConfig(adamw=AdamWConfig(**TRAIN_PARITY_ADAMW))
    step_fn = make_train_step(cfg, tcfg)
    raw = synth_batch(cfg, step=1, global_batch=1, seq=TRAIN_PARITY_SEQ)
    out = {}
    runs = {}
    for side, model, device in (("cpu", cpu_model, "cpu"), ("card", card, dev)):
        batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
        state = init_train_state(cfg, tcfg, model)
        with GradCheck(torch, f"parity {arch} {side}", keep=True) as gc:
            model, state, metrics = step_fn(model, state, batch)
        runs[side] = (model, state, metrics, gc.grads[0])
    cpu_m, card_m = runs["cpu"][2], runs["card"][2]
    for k in ("loss", "ce", "grad_norm"):
        want, got = float(cpu_m[k]), float(card_m[k])
        if not abs(got - want) <= PARITY_TOL + PARITY_TOL * abs(want):
            raise AssertionError(f"train parity {arch}: {k} {got} on the card, {want} on the CPU")
    want_g, got_g = runs["cpu"][3], runs["card"][3]
    worst_g = 0.0
    for k, w in want_g.items():
        scale = float(w.abs().max())
        err = (got_g[k] - w).abs()
        if bool((err > PARITY_TOL * scale + PARITY_TOL * w.abs()).any()):
            raise AssertionError(f"train parity {arch}: gradient {k} differs by {float(err.max())}"
                                 f" (leaf max {scale})")
        worst_g = max(worst_g, float(err.max()) / max(scale, 1e-30))
    worst_m, excused, total = 0.0, 0, 0
    for k, w in runs["cpu"][1]["adamw"]["master"].items():
        got = runs["card"][1]["adamw"]["master"][k].cpu()
        err = (got - w).abs()
        outside = err > PARITY_TOL + PARITY_TOL * w.abs()
        excused += int(outside.sum())
        total += w.numel()
        g = want_g[k].abs()
        decided = g <= PARITY_TOL * float(g.max())     # the update decided by rounding
        if bool((outside & ~decided).any()):
            raise AssertionError(f"train parity {arch}: master {k} differs by {float(err.max())}")
        worst_m = max(worst_m, float(err[~outside].max()) if bool((~outside).any()) else 0.0)
    if excused > ROUNDING_DECIDED_MAX * total:
        raise AssertionError(f"train parity {arch}: {excused} of {total} masters outside the "
                             "limit where the update is decided by rounding")
    out.update(loss_cpu=float(cpu_m["loss"]), loss_card=float(card_m["loss"]),
               grad_err_over_leaf_max=worst_g, master_max_abs_err=worst_m,
               rounding_decided_outside=excused, params=total)

    model, state = runs["card"][0], runs["card"][1]
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=1)
        template = {"params": model, "opt": state}
        mgr.save_async(0, template, {"arch": cfg.name})
        mgr.wait()
        mgr.save(1, template, {"arch": cfg.name})
        if sorted(mgr.all_steps()) != [1] or mgr.latest_step() != 1:
            raise AssertionError(f"checkpoint {arch}: steps {mgr.all_steps()}")
        restored, meta = mgr.restore(1, template)
    pairs = list(zip(named_leaves(template), named_leaves(restored)))
    for (ka, a), (kb, b) in pairs:
        if ka != kb or a.device != b.device or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"checkpoint {arch}: {ka} not restored bit for bit")
    out["checkpoint_leaves"] = len(pairs)
    log(f"[train] parity {arch}, {PARITY_LAYERS} layers, float32, 1 x {TRAIN_PARITY_SEQ} "
        f"tokens, one step, card against CPU: {json.dumps(out)} (limit {PARITY_TOL} + "
        f"{PARITY_TOL}·|CPU|); checkpoint round trip on the card bit for bit over "
        f"{len(pairs)} leaves, step {meta['step']}")
    del runs, model, state, restored, card
    torch.cuda.empty_cache()
    return out


def train_driver(torch) -> None:
    """``launch/train.py``'s ``main`` on the card, reduced mamba2-780m: 4 steps with
    a checkpoint every 2, then ``--resume`` with 6: exactly 2 more steps, every
    loss finite, ``ssd_chunk`` launched once per Mamba layer per step."""
    import tempfile

    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.launch.train import main as train_main

    cfg = reduced_for_smoke(get_arch("mamba2-780m"))
    per_step = kernel_calls_per_step(cfg, "mamba")
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--arch", "mamba2-780m", "--reduced", "--steps", "4", "--global-batch", "2",
                "--seq", "32", "--ckpt-dir", tmp, "--ckpt-every", "2", "--log-every", "10"]
        reset_counts()
        first = train_main(args)
        second = train_main([a if a != "4" else "6" for a in args] + ["--resume"])
        n = launch_counts(["ssd_chunk"])["ssd_chunk"]
    if (len(first["history"]) != 4 or len(second["history"]) != 2
            or not np.isfinite(first["history"] + second["history"]).all()
            or n != 6 * per_step):
        raise AssertionError(f"train driver: {first}, {second}, {n} ssd_chunk launches")
    log(f"[train] driver on the card: reduced mamba2-780m, losses {first['history']} then "
        f"{second['history']} after --resume; {n} ssd_chunk launches")


def phase_train(torch, dev, smi: str) -> dict:
    """The train phase: each of TRAIN_CASES at full width and depth
    (``train_model``), then each model's depth-cut card-against-CPU training step
    and checkpoint round trip, then the driver on the card → by kernel name, the
    train path's launches."""
    runs = {}
    for tag, arch, kernel, mixer, names in TRAIN_CASES:
        res = train_model(torch, dev, tag, arch, kernel, mixer, names, smi)
        log(f"[train] {tag} summary on {smi}: {json.dumps(res['stats'])}")
        runs[kernel] = res
    for _, arch, _, _, _ in TRAIN_CASES:
        train_parity(torch, dev, arch)
    train_driver(torch)
    return runs


# ---------------------------------------------------------------------------
# The mesh layer on a virtual mesh held on the card (``repro_torch.distributed``)
# ---------------------------------------------------------------------------

#: deepseek-moe-16b (src/repro_torch/configs/deepseek_moe_16b.py) at full width
#: and depth in bf16, served through the "a2a" MoE dispatch on a virtual
#: (data 1, model 16) mesh: the production model axis. 2 x 2048 tokens give 256
#: a shard, so cap = ceil(256·6/64·1.25) = 30 and the capacity formula, not its
#: floor of 8, governs; then greedy decode steps (batch 2: the dense fallback)
MESH_ARCH, MESH_SHAPE = "deepseek-moe-16b", ((1, 16), ("data", "model"))
MESH_BATCH, MESH_PROMPT, MESH_STEPS = 2, 2048, 16
# the card's a2a against the CPU's: depth 2, float32, 2 x 512 tokens on that mesh
MESH_PARITY_TOKENS = 512
# split-KV decode at h2o-danube-1.8b's decode widths: 32 query heads, 8 KV heads of
# 80, a 4096-token bf16 cache over model 16 (256 a slice: cache_pspecs' S >= tp·128)
SPLIT_KV = dict(batch=4, heads=32, kv_heads=8, seq=4096, head_dim=80, shards=16)
# hierarchical_mean over mamba2-780m's parameter shapes on a (pod 2, data 2) mesh
GRAD_SYNC_ARCH, GRAD_SYNC_MESH = "mamba2-780m", ((2, 2), ("pod", "data"))
# GPipe: h2o-danube-1.8b's 24 layers in bf16 as 4 stages of 6, 4 microbatches
PIPE_ARCH, PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = "h2o-danube-1.8b", 4, 4, 2048


class PackStats:
    """Counts ``models.moe._pack_capacity`` calls and their kept and total
    (token, k) entries while installed (device tensors, read at the end: no sync
    inside the timed runs)."""

    def __init__(self):
        self.calls, self.kept, self.entries, self.caps = 0, [], 0, set()

    def __enter__(self):
        from repro_torch.models import moe

        self._mod, self._orig = moe, moe._pack_capacity

        def wrapped(cfg, x_loc, idx_loc, cap):
            out = self._orig(cfg, x_loc, idx_loc, cap)
            self.calls += 1
            self.kept.append(out[2].sum())
            self.entries += out[2].numel()
            self.caps.add(cap)
            return out

        moe._pack_capacity = wrapped
        return self

    def __exit__(self, *exc):
        self._mod._pack_capacity = self._orig
        return False

    def dropped_share(self) -> float:
        return 1.0 - float(sum(int(k) for k in self.kept)) / max(self.entries, 1)


class RouterReplay:
    """Records every ``models.moe._router`` result (``replay=None``), or hands
    back a recorded run's results in call order, moved to the caller's device,
    counting the tokens whose own top-k expert set differs from the recorded one."""

    def __init__(self, replay=None):
        self.replay, self.record, self.differ = replay, [], 0

    def __enter__(self):
        from repro_torch.models import moe

        self._mod, self._orig = moe, moe._router

        def wrapped(cfg, p, x_flat):
            out = self._orig(cfg, p, x_flat)
            if self.replay is None:
                self.record.append(tuple(t.cpu() for t in out))
                return out
            want = self.replay[len(self.record)]
            self.record.append(want)
            mine = out[1].sort(-1).values.cpu()
            self.differ += int((mine != want[1].sort(-1).values).any(-1).sum())
            return tuple(t.to(x_flat.device) for t in want)

        moe._router = wrapped
        return self

    def __exit__(self, *exc):
        self._mod._router = self._orig
        return False


def mesh_serve(torch, dev, smi: str) -> dict:
    """deepseek-moe-16b at full width and depth through the "a2a" dispatch on
    the virtual (1, 16) mesh: a cold and a warm prefill of MESH_BATCH x
    MESH_PROMPT ``synth_batch`` tokens and MESH_STEPS greedy steps (the counts
    zeroed just before and read just after: one ``flash_attention`` launch per
    attention layer per prefill, one capacity pack per MoE layer per prefill,
    none in decode), one prefill with every kernel call held against its plain
    version, one that keeps the kernel's largest inputs (timed there beside its
    plain version, its bound and SDPA, one log line), and the same warm prefill
    through "loop" (no mesh axes) beside it."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.ctx import Mesh, MeshAxes, axes_context, set_mesh
    from repro_torch.models.model import init_params
    from repro_torch.train.data import synth_batch
    from repro_torch.train.step import make_serve_step

    cfg = get_arch(MESH_ARCH)
    n_attn = sum(cfg.block_at(i).mixer == "attn" for i in range(cfg.n_layers))
    n_moe = sum(cfg.block_at(i).moe for i in range(cfg.n_layers))
    mesh, axes = Mesh(*MESH_SHAPE), MeshAxes(("data",), "model")
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
    log(f"[mesh] serve-deepseek-a2a: {MESH_ARCH} {cfg.n_layers} layers ({n_attn} attention, "
        f"{n_moe} MoE: {cfg.n_experts} experts top-{cfg.top_k}, cf {cfg.capacity_factor}), "
        f"d_model {cfg.d_model}, head_dim {cfg.head_dim}, {n_params:,} parameters "
        f"({weight_gib:.3f} GiB {cfg.dtype}) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s; virtual mesh {mesh.shape}")
    raw = synth_batch(cfg, step=0, global_batch=MESH_BATCH, seq=MESH_PROMPT)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items() if k != "labels"}
    cache_len = MESH_PROMPT + MESH_STEPS
    serve_step = make_serve_step(cfg)

    with set_mesh(mesh), axes_context(axes), PackStats() as packs:
        reset_counts()
        logits, cache, cold_ms = serve_prefill(torch, cfg, model, batch, cache_len)
        per_prefill = launch_counts(["flash_attention"])["flash_attention"]
        if per_prefill != n_attn or packs.calls != n_moe:
            raise AssertionError(f"mesh serve: one prefill launched flash_attention "
                                 f"{per_prefill} times and packed {packs.calls} MoE layers, "
                                 f"want {n_attn} and {n_moe}")
        del cache
        logits, cache, warm_ms = serve_prefill(torch, cfg, model, batch, cache_len)
        a2a_last = logits.float().cpu()
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        gen = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_STEPS):
            tok, logits, cache = serve_step(model, cache, tok)
            gen.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches = launch_counts(["flash_attention"])["flash_attention"]
    if launches != 2 * n_attn or packs.calls != 2 * n_moe:
        raise AssertionError(f"mesh serve: {launches} flash_attention launches and "
                             f"{packs.calls} packs over two prefills and {MESH_STEPS} steps, "
                             f"want {2 * n_attn} and {2 * n_moe}")
    gen = torch.stack(gen, dim=1).cpu().numpy()
    if (gen.shape != (MESH_BATCH, MESH_STEPS + 1) or not bool(torch.isfinite(logits).all())
            or gen.min() < 0 or gen.max() >= cfg.vocab_padded
            or cache["pos"] != MESH_PROMPT + MESH_STEPS):
        raise AssertionError(f"mesh serve: bad output {gen.shape}, pos {cache['pos']}")
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    del cache, logits
    t_loc = MESH_BATCH * MESH_PROMPT // mesh.size
    stats = {"cold_prefill_ms": cold_ms, "warm_prefill_ms": warm_ms,
             "decode_ms_per_step": decode_s * 1e3 / MESH_STEPS, "peak_gib": peak_gib,
             "launches_per_prefill": per_prefill, "tokens_per_shard": t_loc,
             "capacity": sorted(packs.caps), "dropped_share": packs.dropped_share()}

    with set_mesh(mesh), axes_context(axes):
        with InputCapture(check=True, kernels=("flash_attention",)) as checker:
            serve_prefill(torch, cfg, model, batch, cache_len)
    if checker.checked.get("flash_attention", 0) != n_attn:
        raise AssertionError(f"mesh serve: the checked prefill held {checker.checked} calls")
    stats["checked_max_abs_err"] = checker.max_err["flash_attention"]
    capture = InputCapture(kernels=("flash_attention",))
    with set_mesh(mesh), axes_context(axes), capture:
        serve_prefill(torch, cfg, model, batch, cache_len)
    case = attention_case(torch, *capture.best["flash_attention"][1][:3], MESH_BATCH, cfg.n_heads)
    row = library_row(torch, "flash_attention", case, launches, stats["checked_max_abs_err"],
                      "mesh serve-deepseek-a2a", device_time=False)
    stats["flash_at_path_inputs"] = {k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                                         "library_ms")}
    del capture, case
    # the same model and prompts with no mesh axes: "a2a" resolves to the dropless loop
    loop_logits, _, loop_cold_ms = serve_prefill(torch, cfg, model, batch, cache_len)
    loop_logits, _, loop_warm_ms = serve_prefill(torch, cfg, model, batch, cache_len)
    stats.update(loop_cold_prefill_ms=loop_cold_ms, loop_warm_prefill_ms=loop_warm_ms,
                 a2a_vs_loop_last_logits_max_abs=float((loop_logits.float().cpu()
                                                        - a2a_last).abs().max()))
    log(f"[mesh] serve-deepseek-a2a on {smi}: batch {MESH_BATCH} x {MESH_PROMPT} tokens, "
        f"{t_loc} a shard, capacity {sorted(packs.caps)}; prefill cold {cold_ms:.1f} ms, warm "
        f"{warm_ms:.1f} ms (through \"loop\": cold {loop_cold_ms:.1f}, warm {loop_warm_ms:.1f} "
        f"ms); {MESH_STEPS} greedy steps {decode_s * 1e3:.1f} ms "
        f"({stats['decode_ms_per_step']:.3f} ms/step, dense fallback at batch "
        f"{MESH_BATCH}); dropped (token, k) entries {stats['dropped_share']:.5f} of "
        f"{packs.entries:,}; peak device memory {peak_gib:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held before; flash_attention {per_prefill} launches per "
        f"prefill at D={cfg.head_dim}, {launches} over the run, the checked prefill's "
        f"{checker.checked['flash_attention']} calls within their limit (max |err| "
        f"{stats['checked_max_abs_err']:.4g}); last-token logits a2a against loop max |diff| "
        f"{stats['a2a_vs_loop_last_logits_max_abs']:.4g} (not held: cf "
        f"{cfg.capacity_factor} drops entries); first row {gen[0][:12].tolist()}")
    del model, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "stats": stats}


def mesh_moe_parity(torch, dev) -> dict:
    """deepseek-moe-16b cut to 2 layers in float32, the same weights on the CPU
    and the card (seed 1), 2 x MESH_PARITY_TOKENS tokens on the virtual (1, 16)
    mesh: the card's "a2a" logits against the CPU's at the config's cf (with
    drops; the card replays the CPU's routing, and the tokens whose own routing
    differed are counted), then at a dropless cf (E / top_k) both sides' "a2a"
    against their own "loop" — every limit PARITY_TOL + PARITY_TOL·|want|."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.ctx import Mesh, MeshAxes, axes_context, set_mesh
    from repro_torch.models.model import init_params, model_forward
    from repro_torch.train.data import synth_batch

    cfg = replace(get_arch(MESH_ARCH), n_layers=PARITY_LAYERS, dtype="float32")
    dropless = replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    cpu_model = init_params(cfg, seed=1, device="cpu")
    card = copy.deepcopy(cpu_model).to(dev)
    raw = synth_batch(cfg, step=1, global_batch=MESH_BATCH, seq=MESH_PARITY_TOKENS)
    cpu_batch = {k: torch.from_numpy(v) for k, v in raw.items() if k != "labels"}
    card_batch = {k: v.to(dev) for k, v in cpu_batch.items()}
    mesh, axes = Mesh(*MESH_SHAPE), MeshAxes(("data",), "model")
    out = {}

    def hold(what, got, want):
        got, want = got.float().cpu(), want.float().cpu()
        err = (got - want).abs()
        if not bool(torch.isfinite(got).all()) or bool(
                (err > PARITY_TOL + PARITY_TOL * want.abs()).any()):
            raise AssertionError(f"mesh moe parity: {what} differs by {float(err.max())}")
        out[what] = float(err.max())

    def forward(c, model, b, mesh_on=True):
        with torch.no_grad():
            if not mesh_on:
                return model_forward(c, model, b)[0]
            with set_mesh(mesh), axes_context(axes), PackStats() as packs:
                logits = model_forward(c, model, b)[0]
            out.setdefault("dropped_share", {})[f"cf {c.capacity_factor:.4g}, "
                                                f"{b['tokens'].device.type}"] = \
                packs.dropped_share()
            return logits

    with RouterReplay() as rec:
        want = forward(cfg, cpu_model, cpu_batch)
    with RouterReplay(rec.record) as rep:
        got = forward(cfg, card, card_batch)
    hold("a2a card vs cpu", got, want)
    out["tokens_routed_differently_on_the_card"] = rep.differ
    del got, want
    for side, model, b in (("cpu", cpu_model, cpu_batch), ("card", card, card_batch)):
        loop = forward(cfg, model, b, mesh_on=False)
        hold(f"a2a dropless vs loop, {side}", forward(dropless, model, b), loop)
        del loop
    if out["dropped_share"][f"cf {cfg.capacity_factor:.4g}, cpu"] <= 0:
        raise AssertionError("mesh moe parity: the config's cf dropped nothing at this size")
    log(f"[mesh] parity {MESH_ARCH}, {PARITY_LAYERS} layers, float32, {MESH_BATCH} x "
        f"{MESH_PARITY_TOKENS} tokens on {mesh.shape}: {json.dumps(out)} (limit {PARITY_TOL} "
        f"+ {PARITY_TOL}·|want|; the dropless cf is E/top_k = {dropless.capacity_factor:.4g})")
    del card
    torch.cuda.empty_cache()
    return out


def split_kv_limit(torch, q, k, v, want):
    """The |Δ| (B, H, hd) by which the split-KV combine may differ from
    ``reference_decode_attention``'s bf16 output ``want``: every score is rounded
    to bf16 once on each side (|Δs_j| ≤ 2^-7·|s_j|, moving the output by at most
    Σ_j w_j·|Δs_j|·(|v_j| + |out|)), and at most four more roundings of 2^-8 on
    either side fall on the weights, the shards' partial sums and the output
    (2^-6·(Σ_j w_j·|v_j| + |out|)); w, s in float32 from the same inputs."""
    b, h, hd = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, kv, h // kv, hd)
    s = torch.einsum("bkrd,bskd->bkrs", qg, k.float()) * hd ** -0.5
    w = torch.softmax(s, dim=-1)
    va = v.float().abs()
    o = want.float().abs().reshape(b, kv, h // kv, hd)
    ws = w * s.abs()
    score = torch.einsum("bkrs,bskd->bkrd", ws, va) + ws.sum(-1, keepdim=True) * o
    rest = torch.einsum("bkrs,bskd->bkrd", w, va) + o
    return (2.0 ** -7 * score + 2.0 ** -6 * rest).reshape(b, h, hd)


def mesh_decode(torch, dev, smi: str) -> dict:
    """``split_kv_decode_attention`` at SPLIT_KV's widths against
    ``reference_decode_attention`` within ``split_kv_limit``, both timed."""
    from repro_torch.dataplane.decode_attn import (reference_decode_attention,
                                                   split_kv_decode_attention)
    from repro_torch.distributed.ctx import Mesh

    w = SPLIT_KV
    g = torch.Generator(device=dev).manual_seed(21)
    q = torch.randn(w["batch"], w["heads"], w["head_dim"], generator=g, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(w["batch"], w["seq"], w["kv_heads"], w["head_dim"], generator=g,
                        device=dev, dtype=torch.bfloat16) for _ in range(2))
    mesh = Mesh((w["shards"],), ("model",))
    got = split_kv_decode_attention(mesh, "model", q, k, v)
    want = reference_decode_attention(q, k, v)
    lim = split_kv_limit(torch, q, k, v, want)
    err = (got.float() - want.float()).abs()
    used = float((err / lim).max())
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) or used > 1:
        raise AssertionError(f"split-KV decode: differs by {float(err.max())} ({used:.3g} of "
                             "the limit)")
    split_ms = cuda_ms(torch, lambda: split_kv_decode_attention(mesh, "model", q, k, v))
    ref_ms = cuda_ms(torch, lambda: reference_decode_attention(q, k, v))
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
    res = {"split_ms": split_ms, "reference_ms": ref_ms, "max_abs_err": float(err.max()),
           "limit_used": used, "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    log(f"[mesh] split-KV decode on {smi}: q {tuple(q.shape)}, cache {tuple(k.shape)} bf16 "
        f"over model {w['shards']} ({w['seq'] // w['shards']} a slice): {json.dumps(res)} "
        "(CUDA events, 10 calls after 2 warm-ups)")
    return res


def mesh_grad_sync(torch, dev, smi: str) -> dict:
    """``hierarchical_mean`` over GRAD_SYNC_ARCH's parameter shapes (from its
    meta-device model), float32, on the virtual (pod 2, data 2) mesh: distinct
    replicas against a plain mean over the replica dims within float32 rounding
    (each side at most n_rep - 1 additions and one division: 2^-21·Σ_r|x_r|/n_rep
    together), timed against the bytes bound (every replica read once, one copy
    of the mean written: the result is one tensor broadcast over the replicas);
    replicated input comes back bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.ctx import Mesh
    from repro_torch.distributed.specs import P, place
    from repro_torch.launch.inputs import params_specs
    from repro_torch.train.grad_sync import hierarchical_mean

    shapes = {k: tuple(p.shape) for k, p in params_specs(get_arch(GRAD_SYNC_ARCH))
              .named_parameters()}
    mesh = Mesh(*GRAD_SYNC_MESH)
    n_rep = mesh.size
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(22)
    grads = {k: torch.randn(*mesh.sizes, *s, generator=g, device=dev) for k, s in shapes.items()}
    n = sum(math.prod(s) for s in shapes.values())
    in_bytes = n * 4 * n_rep
    out = hierarchical_mean(grads, mesh)
    worst = 0.0
    for k, x in grads.items():
        want = x.mean(dim=(0, 1))
        lim = 2.0 ** -21 * x.abs().sum(dim=(0, 1)) / n_rep
        err = (out[k] - want).abs()
        if bool((err > lim).any()):
            raise AssertionError(f"hierarchical mean: {k} differs from the mean by "
                                 f"{float(err.max())}")
        worst = max(worst, float((err / lim.clamp_min(1e-30)).max()))
    del out
    ms = cuda_ms(torch, lambda: hierarchical_mean(grads, mesh), reps=5)
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    replicated = {k: x[0, 0] for k, x in grads.items()}
    back = hierarchical_mean({k: place(x, mesh, P()) for k, x in replicated.items()}, mesh)
    for k, x in replicated.items():
        if not torch.equal(back[k], place(x, mesh, P())):
            raise AssertionError(f"hierarchical mean: replicated {k} came back changed")
    bound_ms = (in_bytes + n * 4) / HBM_BYTES_PER_S * 1e3
    res = {"leaves": len(shapes), "params": n, "input_gb": in_bytes / 1e9, "ms": ms,
           "bytes_bound_ms": bound_ms, "limit_used": worst, "peak_gib": peak_gib}
    log(f"[mesh] hierarchical mean on {smi}: {GRAD_SYNC_ARCH}'s {len(shapes)} parameter "
        f"shapes ({n:,} float32 each) x {n_rep} distinct replicas on {mesh.shape}: "
        f"{json.dumps(res)} (CUDA events, 5 calls after 2 warm-ups); replicated input came "
        "back bit for bit")
    del grads, back
    torch.cuda.empty_cache()
    return res


def mesh_pipeline(torch, dev, smi: str) -> dict:
    """``pipelined_forward`` over PIPE_ARCH's layers at full width in bf16, split
    into PIPE_STAGES stages on a virtual stage axis, PIPE_MICRO microbatches of
    1 x PIPE_SEQ embedded tokens, against the serial forward of every layer on the
    same microbatches: bit-equal (each stage runs its layers on the shapes of the
    serial run), else within 2e-2 + 2e-2·|serial| (the bf16 limit of the CPU
    tests) — the log says which held. ``flash_attention`` launches: a stage
    runs every tick, bubbles included: (M + S - 1)·S·layers a stage."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.ctx import Mesh
    from repro_torch.models.layers import embed_apply
    from repro_torch.models.model import _block_apply, init_params
    from repro_torch.train.data import synth_batch
    from repro_torch.train.pipeline import pipelined_forward

    cfg = get_arch(PIPE_ARCH)
    per_stage = cfg.n_layers // PIPE_STAGES
    if per_stage * PIPE_STAGES != cfg.n_layers or any(cfg.block_at(i).mixer != "attn"
                                                       for i in range(cfg.n_layers)):
        raise AssertionError(f"{PIPE_ARCH}: {cfg.n_layers} layers do not split into "
                             f"{PIPE_STAGES} attention stages")
    model = init_params(cfg, seed=0)
    raw = synth_batch(cfg, step=0, global_batch=PIPE_MICRO, seq=PIPE_SEQ)
    positions = torch.arange(PIPE_SEQ, device=dev)[None, :]
    with torch.no_grad():
        x = embed_apply(cfg, model.embed, torch.from_numpy(raw["tokens"]).to(dev))[:, None]
    stages = [list(model.layers[s * per_stage:(s + 1) * per_stage]) for s in range(PIPE_STAGES)]

    def stage_fn(xm, layers):
        for layer in layers:
            xm, _ = _block_apply(cfg, layer.spec, layer, xm, positions)
        return xm

    def serial():
        return torch.stack([stage_fn(x[m], list(model.layers)) for m in range(PIPE_MICRO)])

    mesh = Mesh((PIPE_STAGES,), ("stage",))

    def piped():
        return pipelined_forward(mesh, "stage", PIPE_STAGES, PIPE_MICRO, stage_fn, x, stages)

    with torch.no_grad():
        reset_counts()
        want = serial()
        n_serial = launch_counts(["flash_attention"])["flash_attention"]
        reset_counts()
        got = piped()
        n_piped = launch_counts(["flash_attention"])["flash_attention"]
        timed = {}
        for name, fn in (("serial", serial), ("pipelined", piped), ("pipelined", piped),
                         ("serial", serial)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            timed.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
    ticks = PIPE_MICRO + PIPE_STAGES - 1
    if n_serial != PIPE_MICRO * cfg.n_layers or n_piped != ticks * cfg.n_layers:
        raise AssertionError(f"pipeline: flash_attention launched {n_serial} serial / "
                             f"{n_piped} pipelined times, want {PIPE_MICRO * cfg.n_layers} / "
                             f"{ticks * cfg.n_layers}")
    bit_equal = bool(torch.equal(got, want))
    err = float((got.float() - want.float()).abs().max())
    if not bit_equal and bool((((got.float() - want.float()).abs()
                                > 2e-2 + 2e-2 * want.float().abs())).any()):
        raise AssertionError(f"pipeline: differs from the serial forward by {err}")
    res = {"bit_equal": bit_equal, "max_abs_err": err, "serial_ms": timed["serial"],
           "pipelined_ms": timed["pipelined"], "flash_launches_serial": n_serial,
           "flash_launches_pipelined": n_piped,
           "bubble_fraction": (PIPE_STAGES - 1) / ticks}
    log(f"[mesh] GPipe on {smi}: {PIPE_ARCH} {cfg.n_layers} layers as {PIPE_STAGES} stages x "
        f"{per_stage}, {PIPE_MICRO} microbatches of 1 x {PIPE_SEQ}, {cfg.dtype}: "
        f"{json.dumps(res)} (host clock with a sync; serial, pipelined, pipelined, serial)")
    del model, x, got, want
    torch.cuda.empty_cache()
    return res


def mesh_memory() -> dict:
    """Host arithmetic: deepseek-moe-16b's bytes per device under ``param_pspecs``
    (fsdp on) on both production meshes: the parameters in their dtypes, and the
    optimizer state (fp32 master, m, v under the same specs, and the step)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.specs import param_pspecs
    from repro_torch.launch.inputs import params_specs
    from repro_torch.launch.mesh import axes_for, make_production_mesh

    model = params_specs(get_arch(MESH_ARCH))
    out = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        specs = param_pspecs(model, mesh, axes_for(mesh))
        params = opt = 0.0
        for name, p in model.named_parameters():
            split = math.prod(mesh.shape[a] for e in specs[name] if e is not None
                              for a in ((e,) if isinstance(e, str) else e))
            params += p.numel() * p.element_size() / split
            opt += p.numel() * 12 / split
        out["x".join(map(str, mesh.sizes))] = {"params_gb": params / 1e9,
                                               "opt_state_gb": (opt + 4) / 1e9}
    log(f"[mesh] {MESH_ARCH} per-device memory from param_pspecs (host arithmetic): "
        f"{json.dumps(out)}")
    return out


def phase_mesh(torch, dev, smi: str) -> dict:
    """The mesh phase: deepseek-moe-16b served through "a2a" on the virtual
    (1, 16) mesh (its ``flash_attention`` launches are this path's count), its
    depth-2 card-against-CPU parity, split-KV decode, the hierarchical mean, the
    GPipe pipeline and the spec rules' per-device memory → the path's launches."""
    served = mesh_serve(torch, dev, smi)
    log(f"[mesh] serve-deepseek-a2a summary on {smi}: {json.dumps(served['stats'])}")
    mesh_moe_parity(torch, dev)
    mesh_decode(torch, dev, smi)
    mesh_grad_sync(torch, dev, smi)
    mesh_pipeline(torch, dev, smi)
    mesh_memory()
    return {"flash_attention": served["launches"]}


# ---------------------------------------------------------------------------
# The dry run and the roofline (``launch/dryrun.py``, ``analysis/``)
# ---------------------------------------------------------------------------

#: the full matrix, every arch x shape on both production meshes: ok cells and
#: the long_500k skips of the archs with full attention (6 archs x 2 meshes)
DRYRUN_OK, DRYRUN_SKIPPED = 68, 12
# past this many seconds, the matrix is logged as over budget
DRYRUN_BUDGET_S = 180
#: the counted steps on the card: (tag, arch, step kind, kernel, launches a step)
DRYRUN_STEPS = (("roofline-danube-prefill", "h2o-danube-1.8b", "prefill", "flash_attention", 24),
                ("roofline-mamba2-train", "mamba2-780m", "train", "ssd_chunk", 96))


def dryrun_matrix(smi: str) -> dict:
    """``launch/dryrun.py``'s ``main`` over every arch x shape on both production
    meshes into a fresh ``artifacts/dryrun_torch/``: one process per arch
    (``--arch A --both-meshes --force``), all started together, each counting its
    cells on meta tensors on the host. DRYRUN_OK cells ok and DRYRUN_SKIPPED
    skipped, every ok cell with collectives from the partitioner count
    (``analysis/partition.py``); one log line per cell with its terms on the H100,
    its bottleneck and the partitioner's share of its collective bytes."""
    import shutil

    from repro_torch.configs import ARCHS
    from repro_torch.launch.dryrun import ART_DIR

    shutil.rmtree(ART_DIR, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--both-meshes",
         "--force"], cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for arch in sorted(ARCHS)}
    outputs = {arch: proc.communicate()[0] for arch, proc in procs.items()}
    wall_s = time.perf_counter() - t0
    failed = [arch for arch, proc in procs.items() if proc.returncode != 0]
    if failed:
        raise AssertionError(f"dry run failed for {failed}: "
                             + " | ".join(outputs[a][-2000:] for a in failed))
    cells = [json.loads(path.read_text()) for path in sorted(ART_DIR.glob("*.json"))]
    status = {k: sum(c["status"] == k for c in cells) for k in ("ok", "skipped", "error")}
    if status != {"ok": DRYRUN_OK, "skipped": DRYRUN_SKIPPED, "error": 0}:
        raise AssertionError(f"dry-run matrix: {status} over {len(cells)} cells")
    no_partitioner = []
    for c in cells:
        tag = f"{c['arch']} {c['shape']} {'pod2' if c['multi_pod'] else 'pod1'}"
        if c["status"] != "ok":
            log(f"[dryrun] {tag}: skipped ({c['reason']})")
            continue
        r = c["roofline_h100"]
        part = c["collectives_partitioner"]["total_bytes"]
        if not part > 0:
            no_partitioner.append(tag)
        log(f"[dryrun] {tag}: {c['n_chips']} devices, per device {c['flops_per_device']:.4g} "
            f"FLOPs, {c['bytes_per_device']:.4g} bytes, {c['coll_bytes_per_device']:.4g} "
            f"collective bytes ({part:.4g} from the partitioner, "
            f"{part / c['coll_bytes_per_device']:.3f} of them); H100 t_compute "
            f"{r['t_compute_s']:.4g} s, t_memory {r['t_memory_s']:.4g} s, t_collective "
            f"{r['t_collective_s']:.4g} s: {r['bottleneck']} (TPU figures: "
            f"{c['roofline']['bottleneck']}); kernel units {c['kernel_units']}; argument "
            f"bytes {c['memory_analysis']['argument_bytes']:,}; counted in {c['compile_s']} s")
    if no_partitioner:
        raise AssertionError(f"dry-run cells with no partitioner collectives: {no_partitioner}")
    slowest = max((c for c in cells if c["status"] == "ok"), key=lambda c: c["compile_s"])
    log(f"[dryrun] matrix on the host of {smi}: {status['ok']} ok, {status['skipped']} skipped, "
        f"{wall_s:.1f} s wall over {len(procs)} processes (budget {DRYRUN_BUDGET_S} s"
        f"{'' if wall_s <= DRYRUN_BUDGET_S else ': OVER'}); slowest cell {slowest['arch']} "
        f"{slowest['shape']} {slowest['compile_s']} s")
    return {"wall_s": wall_s, **status}


def counted_step(torch, kind: str, cfg, device, batch):
    """(the step, its arguments) for ``kind`` at ``cfg`` on ``device``: a prefill of
    ``batch`` (labels dropped), or a ``make_train_step`` step at the train phase's
    schedule with fresh optimizer state. Random weights from seed 0; on ``meta``
    nothing is drawn."""
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import (TrainConfig, init_train_state, make_prefill_step,
                                        make_train_step)

    model = init_params(cfg, seed=0, device=device)
    if kind == "prefill":
        return make_prefill_step(cfg), (model, {k: v for k, v in batch.items()
                                                if k != "labels"})
    tcfg = TrainConfig(adamw=AdamWConfig(lr=TRAIN_LR, warmup_steps=max(2, TRAIN_STEPS // 20),
                                         total_steps=TRAIN_STEPS))
    return make_train_step(cfg, tcfg), (model, init_train_state(cfg, tcfg, model), batch)


def count_diff(card, meta) -> list:
    """The aten ops whose [calls, flops, bytes] differ between two counters."""
    keys = sorted(set(card.by_op) | set(meta.by_op))
    return [[k, card.by_op.get(k), meta.by_op.get(k)] for k in keys
            if card.by_op.get(k) != meta.by_op.get(k)][:12]


def dryrun_counts(torch, dev, smi: str) -> dict:
    """``CostCounter`` on the card: each of DRYRUN_STEPS at full width and depth in
    its config's dtype, on the serve / train phases' 4 x 2048 ``synth_batch``, run
    once cold and once warm (host clock, a sync), then twice counted on CUDA
    tensors (its kernel launched exactly ``launches`` times in each, read from the
    counts zeroed just before) and once counted on meta stand-ins of the same
    shapes: FLOPs, bytes, kernel units and collectives equal. Then once more on each
    under the single-pod production mesh's layout (``analysis/partition.py``): the
    partitioner's collectives equal. The warm ms beside ``roofline_terms``' bound of
    the count on the H100 → the launches by kernel."""
    from repro_torch.analysis.cost import CostCounter
    from repro_torch.analysis.roofline import HW_H100, roofline_terms
    from repro_torch.configs import get_arch
    from repro_torch.train.data import synth_batch

    def partitioned(cfg, step, args):
        """The step counted under the production mesh's layout → its partitioner
        collectives."""
        from repro_torch.analysis.partition import Layout
        from repro_torch.distributed.specs import batch_pspecs, param_pspecs
        from repro_torch.launch.mesh import axes_for, make_production_mesh

        mesh = make_production_mesh()
        axes = axes_for(mesh, sequence_parallel=cfg.sequence_parallel)
        model, batch = args[0], args[-1]
        layout = Layout(mesh, axes, model, param_pspecs(model, mesh, axes),
                        batch_pspecs(batch, mesh, axes))
        with CostCounter(layout=layout) as counter:
            step(*args)
        return counter.partitioner_collectives

    launches = {}
    for tag, arch, kind, kernel, want in DRYRUN_STEPS:
        cfg = get_arch(arch)
        raw = synth_batch(cfg, step=0, global_batch=SERVE_BATCH, seq=SERVE_PROMPT)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        step, args = counted_step(torch, kind, cfg, dev, batch)
        times = []
        for _ in range(2):                           # cold, then warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counted = []                                 # twice: the first pays one-time costs
        for _ in range(2):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with CostCounter() as card:
                step(*args)
                torch.cuda.synchronize()
            counted.append(((time.perf_counter() - t0) * 1e3, card,
                            launch_counts([kernel])[kernel]))
        card_parts = partitioned(cfg, step, args)
        torch.cuda.synchronize()
        del step, args
        torch.cuda.empty_cache()
        meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                      for k, v in batch.items()}
        step, args = counted_step(torch, kind, cfg, "meta", meta_batch)
        t0 = time.perf_counter()
        with CostCounter() as meta:
            step(*args)
        meta_ms = (time.perf_counter() - t0) * 1e3
        meta_parts = partitioned(cfg, step, args)
        del step, args
        for _, card, n in counted:
            got = (card.flops, card.bytes, card.units, card.collectives)
            want_count = (meta.flops, meta.bytes, meta.units, meta.collectives)
            if got != want_count:
                raise AssertionError(f"{tag}: the card's count {got} differs from the meta "
                                     f"count {want_count}: {json.dumps(count_diff(card, meta))}")
            if n != want or card.units.get(kernel) != want:
                raise AssertionError(f"{tag}: {kernel} launched {n} times ({card.units} "
                                     f"units), want {want}")
        if card_parts != meta_parts or not card_parts["total_bytes"] > 0:
            raise AssertionError(f"{tag}: the partitioner's count on the card {card_parts} "
                                 f"differs from the meta count {meta_parts}")
        n = counted[-1][2]
        terms = roofline_terms(card.flops, card.bytes, 0.0, HW_H100)
        warm_ms = times[1]
        top = sorted(card.by_op.items(), key=lambda kv: -kv[1][2])[:6]
        log(f"[dryrun] {tag} on {smi}: {arch} {kind}, {SERVE_BATCH} x {SERVE_PROMPT} tokens, "
            f"cold {times[0]:.1f} ms, warm {warm_ms:.1f} ms; counted {card.flops:,} FLOPs and "
            f"{card.bytes:,} bytes (equal on meta), {card.units} kernel units, {n} {kernel} "
            f"launches; H100 bound {terms['t_bound_s'] * 1e3:.3f} ms ({terms['bottleneck']}: "
            f"t_compute {terms['t_compute_s'] * 1e3:.3f} ms, t_memory "
            f"{terms['t_memory_s'] * 1e3:.3f} ms), warm / bound "
            f"{warm_ms / (terms['t_bound_s'] * 1e3):.2f}; the counted runs "
            f"{counted[0][0]:.1f} and {counted[1][0]:.1f} ms, the meta count {meta_ms:.1f} ms; "
            f"most bytes {json.dumps(top)}; under the (16, 16) mesh's layout the partitioner "
            f"counts {card_parts['total_bytes']:,} collective bytes a device "
            f"(all-reduce {card_parts['all-reduce_bytes']:,}, all-gather "
            f"{card_parts['all-gather_bytes']:,}), equal on meta")
        launches[kernel] = n
        del batch, meta_batch
        torch.cuda.empty_cache()
    return launches


def phase_dryrun(torch, dev, smi: str) -> dict:
    """The dryrun phase: the full dry-run matrix on the host, then the cost counter
    on the card against its meta count → the counted runs' launches."""
    dryrun_matrix(smi)
    return dryrun_counts(torch, dev, smi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile two warm submits of the 2M-edge triangle query")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    # the plain versions' float32 products run in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def timed(label, fn, *a):
        t0 = time.perf_counter()
        res = fn(*a)
        log(f"[time] {label}: {time.perf_counter() - t0:.1f} s")
        return res

    env = timed("phase 1 (environment and build)", phase_env, torch)
    log("[env] TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    timed("phase 2 (join kernels)", phase_kernels, torch, dev)
    timed("phase 2 (library kernels)", phase_library_kernels, torch, dev)
    digest_row = timed("phase digest", phase_digest, torch, dev)

    from repro_torch.mpc import JoinSession

    capture = InputCapture()
    capture.install()
    reset_counts()
    session = JoinSession(p=64, verify=False)
    main3 = timed("phase 3", phase_triangle, torch, session, 500_000, 2_000_000, 0.9, 0, None,
                  "triangle-2M")
    heavy = timed("phase 4", phase_triangle, torch, session, 100_000, 300_000, 1.5, 1, 24,
                  "heavy")
    # round_us holds only rounds that dispatched work: HashPartition is
    # "step2-unary", SemiJoin "step2-bx"/"step2-by"
    if not {"step2-unary", "step2-bx"} <= heavy["rounds"]:
        raise AssertionError(f"heavy graph ran no HashPartition/SemiJoin: {heavy['rounds']}")
    timed("phase 5", phase_parity, torch)
    # the sessions' submits digest their tables of at least
    # CARD_DIGEST_MIN_BYTES on the card
    launches = launch_counts(JOIN_KERNELS + ("blake2b_chunks",))
    capture.remove()
    log(f"[main] kernel launches over phases 3-5: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name}: no launch on the main path")
    if args.profile:
        phase_profile(torch, session, main3["query"], None)
    timed("phase patterns", phase_patterns, torch, session, main3)
    timed("phase service", phase_service, torch)
    verified = timed("phase verify", phase_verify, torch, session, heavy)
    timed("phase simulator", phase_simulator, verified)
    general_capture = InputCapture()
    timed("phase general", phase_general, torch, main3, general_capture)

    del session, main3, heavy, verified
    torch.cuda.empty_cache()
    rows = timed("phase 6", phase_timing, torch, capture, launches)
    timed("phase 6 (general inputs)", phase_timing_general, torch, general_capture)
    del capture, general_capture
    rows += timed("phase 7", phase_library, torch, dev)
    rows.append(dict(digest_row, launches=launches["blake2b_chunks"]))
    # the two LM kernels' rows come from the serve path, their main path
    served = timed("phase serve", phase_serve, torch, dev, env["smi"])
    rows = [served.get(row["name"], row) for row in rows]
    trained = timed("phase train", phase_train, torch, dev, env["smi"])
    for row in rows:
        run = trained.get(row["name"])
        if run is not None:
            row["train_launches"] = run["launches"]
            row["train_launches_per_step"] = run["per_step"]
            row["train_max_abs_err"] = run["max_err"]
    meshed = timed("phase mesh", phase_mesh, torch, dev, env["smi"])
    for row in rows:
        if row["name"] in meshed:
            row["mesh_launches"] = meshed[row["name"]]
    counted = timed("phase dryrun", phase_dryrun, torch, dev, env["smi"])
    for row in rows:
        if row["name"] in counted:
            row["dryrun_launches"] = counted[row["name"]]
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(f"{env['smi']}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
