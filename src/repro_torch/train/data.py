"""Deterministic, stateless-resumable synthetic data pipeline.

Every batch is a pure function of (seed, step, rank geometry): restart-safe by
construction — resuming at step k regenerates exactly the same stream with no iterator
state to checkpoint (the fault-tolerance story's data leg). Shardable: each DP rank
materializes only its slice.

The token stream is a hash-mixed Zipf-ish LM surrogate with enough structure for loss
to fall (next token depends on current token + position parity). A copy of the JAX
package's generator: numpy only, the same arrays for the same arguments."""

from __future__ import annotations

from typing import Dict

import numpy as np


def _mix(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> 30)) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> 27)) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> 31)


def synth_batch(
    cfg,
    step: int,
    global_batch: int,
    seq: int,
    seed: int = 0,
    rank: int = 0,
    n_ranks: int = 1,
) -> Dict[str, np.ndarray]:
    """Batch slice for `rank` of `n_ranks`. tokens/labels (B_loc, seq)."""
    assert global_batch % n_ranks == 0
    b_loc = global_batch // n_ranks
    rows = np.arange(rank * b_loc, (rank + 1) * b_loc, dtype=np.uint64)
    base = _mix(
        rows[:, None] * np.uint64(1_000_003)
        + np.uint64(step) * np.uint64(7_919)
        + np.uint64(seed)
    )
    pos = np.arange(seq, dtype=np.uint64)[None, :]
    raw = _mix(base + pos * np.uint64(2_654_435_761))
    vocab = cfg.vocab
    # structured stream: half the positions repeat a rank-specific motif (learnable)
    motif = (base % np.uint64(max(1, vocab // 8))).astype(np.int64)
    noise = (raw % np.uint64(vocab)).astype(np.int64)
    parity = (np.arange(seq) % 2 == 0)[None, :]
    tokens = np.where(parity, motif, noise).astype(np.int32)
    out = {"tokens": tokens, "labels": tokens.copy()}
    if cfg.frontend == "prefix_embeds":
        emb = _mix(base[:, :1] + np.uint64(17)).astype(np.float64)
        rng = np.random.default_rng(int(emb[0, 0]) % (2**32))
        out["vision_embeds"] = rng.standard_normal(
            (b_loc, cfg.n_frontend, cfg.d_model), dtype=np.float32
        )
        out["tokens"] = tokens[:, : seq - cfg.n_frontend]
        out["labels"] = out["tokens"].copy()
    elif cfg.frontend == "encoder_frames":
        rng = np.random.default_rng((seed * 977 + step * 31 + rank) % (2**32))
        out["frames"] = rng.standard_normal(
            (b_loc, cfg.n_frontend, cfg.d_model), dtype=np.float32
        )
    return out
