"""MPC simulator with exact load accounting (paper Sec. 1.1 model).

Machines hold numpy arrays in a tag-indexed store. An algorithm runs in rounds; within a
round every machine *prepares messages from its local storage only* (enforced by the
orchestration structure: message construction reads the store, delivery mutates it after
the round closes). The per-round load is max over machines of received words
(1 word = one int64 value; a (n, a) array = n·a words). Total load of a constant-round
algorithm = sum of per-round loads (asymptotically the max round, paper Sec. 1.1).

Shared randomness (paper footnote 2) is modeled by HashFamily seeded from a single seed
that all machines are assumed to have pre-agreed on; this costs no load, as in the paper.
"""

from __future__ import annotations

import hashlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

Tag = Hashable

_PRIME = (1 << 61) - 1  # Mersenne prime for 2-universal hashing


def _mod_mersenne61(y: np.ndarray) -> np.ndarray:
    """y mod (2^61 - 1) for uint64 y. Since 2^61 ≡ 1, fold the high bits down;
    one fold leaves a value < 2^61 + 7, so a single conditional subtract finishes."""
    r = (y >> np.uint64(61)) + (y & np.uint64(_PRIME))
    return np.where(r >= np.uint64(_PRIME), r - np.uint64(_PRIME), r)


def _mulmod_mersenne61(a: int, x: np.ndarray) -> np.ndarray:
    """(a · x) mod (2^61 - 1), exact, vectorized. a < 2^61; x uint64 < 2^61.

    Split both factors at 32 bits: a·x = ah·xh·2^64 + (ah·xl + al·xh)·2^32 + al·xl.
    Every partial product fits uint64 (ah, xh < 2^29; al, xl < 2^32), and
    2^64 ≡ 8, 2^32 shifts are folded via 2^61 ≡ 1."""
    mask32 = np.uint64(0xFFFFFFFF)
    ah, al = np.uint64(a >> 32), np.uint64(a & 0xFFFFFFFF)
    xh, xl = x >> np.uint64(32), x & mask32
    hi = _mod_mersenne61(ah * xh) * np.uint64(8)            # ·2^64 ≡ ·8  (< 2^64)
    mid = _mod_mersenne61(ah * xl + al * xh)                 # < 2^61
    # mid·2^32: split at bit 29 so the shifted halves stay below 2^61
    mid = (mid >> np.uint64(29)) + ((mid & np.uint64((1 << 29) - 1)) << np.uint64(32))
    lo = _mod_mersenne61(al * xl)
    return _mod_mersenne61(_mod_mersenne61(hi) + _mod_mersenne61(mid) + lo)


class HashFamily:
    """Shared 2-universal hash functions h_key(v) ∈ [0, range). Deterministic in
    (seed, key): every machine evaluates identical functions without communication.

    Evaluation is exact modular arithmetic under the Mersenne prime 2^61 - 1,
    vectorized in uint64 (no Python-int loop); tests/test_program_ir.py
    cross-checks it against the scalar big-int reference."""

    def __init__(self, seed: int):
        self.seed = seed

    def _coeffs(self, key: Hashable) -> Tuple[int, int]:
        h = hashlib.blake2b(repr((self.seed, key)).encode(), digest_size=16).digest()
        a = int.from_bytes(h[:8], "little") % (_PRIME - 1) + 1
        b = int.from_bytes(h[8:], "little") % _PRIME
        return a, b

    def hash(self, key: Hashable, values: np.ndarray, mod: int) -> np.ndarray:
        a, b = self._coeffs(key)
        values = np.asarray(values, dtype=np.int64)
        uniq, inv = np.unique(values, return_inverse=True)
        x = np.mod(uniq, _PRIME).astype(np.uint64)           # Python-mod semantics on negatives
        hashed = _mod_mersenne61(_mulmod_mersenne61(a, x) + np.uint64(b))
        hashed = (hashed % np.uint64(mod)).astype(np.int64)
        return hashed[inv].reshape(values.shape)


@dataclass
class RoundLoad:
    name: str
    received_words: np.ndarray  # (p,) words received per machine this round

    @property
    def load(self) -> int:
        return int(self.received_words.max()) if self.received_words.size else 0


class MPCSimulator:
    """p machines, tag-indexed stores, exact received-word metering."""

    def __init__(self, p: int, seed: int = 0):
        self.p = p
        self.hashes = HashFamily(seed)
        self.stores: List[Dict[Tag, List[np.ndarray]]] = [defaultdict(list) for _ in range(p)]
        self.rounds: List[RoundLoad] = []
        self._outbox: Optional[List[Tuple[int, Tag, np.ndarray]]] = None

    # -- round protocol ------------------------------------------------------

    def begin_round(self, name: str) -> None:
        if self._outbox is not None:
            raise RuntimeError("previous round not closed")
        self._round_name = name
        self._outbox = []

    def send(self, dst: int, tag: Tag, rows: np.ndarray) -> None:
        """Queue a message (delivered at end_round). rows: (n,) or (n, a) int64."""
        if self._outbox is None:
            raise RuntimeError("send outside a round")
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return
        if rows.ndim == 1:
            rows = rows.reshape(-1, 1)
        self._outbox.append((int(dst) % self.p, tag, rows))

    def broadcast(self, tag: Tag, rows: np.ndarray) -> None:
        for dst in range(self.p):
            self.send(dst, tag, rows)

    def end_round(self) -> RoundLoad:
        assert self._outbox is not None
        words = np.zeros(self.p, dtype=np.int64)
        for dst, tag, rows in self._outbox:
            words[dst] += rows.size
            self.stores[dst][tag].append(rows)
        rl = RoundLoad(name=self._round_name, received_words=words)
        self.rounds.append(rl)
        self._outbox = None
        return rl

    # -- store access --------------------------------------------------------

    def local(self, mid: int, tag: Tag, arity: int = 2) -> np.ndarray:
        parts = self.stores[mid].get(tag)
        if not parts:
            return np.zeros((0, arity), dtype=np.int64)
        return np.concatenate(parts, axis=0)

    def machines_with(self, tag: Tag) -> List[int]:
        return [i for i in range(self.p) if self.stores[i].get(tag)]

    def clear_tag(self, tag: Tag) -> None:
        for s in self.stores:
            s.pop(tag, None)

    # -- metrics ---------------------------------------------------------------

    @property
    def total_load(self) -> int:
        """Paper Sec 1.1: total load = Σ per-round loads (constant #rounds ⇒ same as max
        up to constants; we report the sum, the stricter number)."""
        return sum(r.load for r in self.rounds)

    @property
    def max_round_load(self) -> int:
        return max((r.load for r in self.rounds), default=0)

    def load_report(self) -> List[Tuple[str, int]]:
        return [(r.name, r.load) for r in self.rounds]

    def merged_round_loads(self) -> Dict[str, int]:
        """Rounds that share a name are 'the same logical round' executed for different
        H-subsets/configurations in parallel (paper Sec. 6: processing all H in parallel
        costs a constant factor). Their receive-words add per machine."""
        acc: Dict[str, np.ndarray] = {}
        for r in self.rounds:
            if r.name in acc:
                acc[r.name] = acc[r.name] + r.received_words
            else:
                acc[r.name] = r.received_words.copy()
        return {k: int(v.max()) for k, v in acc.items()}

    @property
    def parallel_total_load(self) -> int:
        """Total load when same-named rounds run in parallel (the paper's execution)."""
        return sum(self.merged_round_loads().values())


def scatter_input(
    sim: MPCSimulator, tag: Tag, data: np.ndarray, seed: int = 1
) -> None:
    """Distribute input tuples evenly across machines (paper: input starts evenly
    spread, Θ(m/p) per machine). Deterministic round-robin after a seeded shuffle;
    costs no load (initial placement)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(data.shape[0])
    data = data[perm]
    for mid in range(sim.p):
        part = data[mid :: sim.p]
        if part.size:
            sim.stores[mid][tag].append(part.astype(np.int64))
