"""Relations, join queries, and a reference (oracle) join evaluator.

Data model (paper Sec. 1.1): a relation is a set of tuples over a named scheme;
values live in **dom** (encoded as int64 words). A simple query is a set of
relations with pairwise-distinct schemes.  The paper's own algorithm is binary
(2-attribute schemes); arbitrary-arity relations are accepted and route through
the general compiler (GYO join trees for acyclic queries, generalized HyperCube
shares for cyclic ones — see ``repro.core.jointree`` / ``repro.mpc.program``).

The oracle ``reference_join`` computes Join(Q) exactly by pairwise hash joins over an
order that prefers connected relations (cartesian products only when the remainder is
disconnected). It is intended for validation on test-sized inputs, not for scale — the
scalable path is the MPC engine itself.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from .hypergraph import Edge, Hypergraph

Attr = str


def _dedup_rows(a: np.ndarray) -> np.ndarray:
    if a.size == 0:
        return a
    return np.unique(a, axis=0)


def rows_sorted_unique(a: np.ndarray) -> bool:
    """True when the rows of the (n, k) array ``a``, read as int64, strictly
    increase in lexicographic signed order: the order ``np.unique(axis=0)``
    gives, so :func:`_dedup_rows` would hand them back unchanged.  One O(n·k)
    pass over neighbouring rows, no sort."""
    a = np.asarray(a, dtype=np.int64)
    if a.shape[0] < 2:
        return True
    prev, nxt = a[:-1], a[1:]
    less = np.zeros(a.shape[0] - 1, dtype=bool)
    tied = np.ones(a.shape[0] - 1, dtype=bool)
    for j in range(a.shape[1]):
        less |= tied & (prev[:, j] < nxt[:, j])
        tied &= prev[:, j] == nxt[:, j]
    return bool(less.all())


@dataclass(frozen=True)
class Relation:
    """A binary (or unary) relation with named attributes.

    ``data`` has shape (n, arity); column j holds values of ``scheme[j]``.
    Tuples are sets — constructors dedup rows: :meth:`make` and
    :func:`query_from_arrays` give int64 rows sorted lexicographically and
    unique (``np.unique(axis=0)``'s order).  A relation built with
    ``Relation(...)`` directly holds whatever rows it was given, which may be
    unsorted or repeated; :func:`rows_sorted_unique` tells the two apart.

    ``table`` optionally names the *physical* table behind this logical
    relation: self-join-shaped queries (e.g. the subgraph-enumeration
    reduction, where every pattern edge binds a copy of the graph's edge set)
    give all copies the same ``table`` id and the same ``data`` object, and
    backends place the shared tuples once instead of once per copy (the
    shared-input Scatter path — see ``SimulatorExecutor.place_inputs``).
    Statistics and planning still treat each copy as its own relation, as the
    paper's m = Σ_e |R_e| accounting requires.
    """

    scheme: Tuple[Attr, ...]
    data: np.ndarray
    table: Optional[str] = None

    @staticmethod
    def make(
        scheme: Sequence[Attr], data: np.ndarray, table: Optional[str] = None
    ) -> "Relation":
        scheme = tuple(scheme)
        data = np.asarray(data, dtype=np.int64).reshape(-1, len(scheme))
        if len(set(scheme)) != len(scheme):
            raise ValueError(f"duplicate attribute in scheme {scheme}")
        return Relation(scheme=scheme, data=_dedup_rows(data), table=table)

    @property
    def arity(self) -> int:
        return len(self.scheme)

    @property
    def edge(self) -> Edge:
        return frozenset(self.scheme)

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def column(self, attr: Attr) -> np.ndarray:
        return self.data[:, self.scheme.index(attr)]

    def project(self, attrs: Sequence[Attr]) -> "Relation":
        idx = [self.scheme.index(a) for a in attrs]
        return Relation.make(tuple(attrs), self.data[:, idx])

    def rows_as_set(self) -> set:
        return set(map(tuple, self.data.tolist()))


#: the bytes of one leaf of the table digest
DIGEST_CHUNK = 16 * 1024


def host_chunk_digests(buf) -> bytes:
    """``hashlib.blake2b(chunk, digest_size=32)`` of each ``DIGEST_CHUNK``-byte
    chunk of the bytes ``buf`` (a 1-D uint8 array or any buffer; the last
    chunk may be shorter, an empty buffer has none), concatenated.  Hashes
    memoryview slices: the bytes are not copied."""
    mv = memoryview(buf).cast("B")
    return b"".join(hashlib.blake2b(mv[i:i + DIGEST_CHUNK], digest_size=32).digest()
                    for i in range(0, len(mv), DIGEST_CHUNK))


def table_digest(data: np.ndarray, chunk_digests=host_chunk_digests) -> bytes:
    """Content digest of one bound table, a Merkle tree of BLAKE2b: its
    C-order bytes are cut into ``DIGEST_CHUNK``-byte chunks (the last may be
    shorter, an empty table has none), each chunk's digest is
    ``hashlib.blake2b(chunk, digest_size=32)``, and the table's is
    blake2b (16 bytes) over the dtype string, the shape's repr, the byte
    length (8 bytes, little-endian) and the chunk digests in order.  Equal
    content gives an equal digest; any differing byte, dtype or shape gives
    another, short of a BLAKE2b collision.

    ``chunk_digests`` maps the table's bytes, a 1-D uint8 array, to the
    concatenated chunk digests: :func:`host_chunk_digests`, or a device's
    path (``kernels.digest.chunk_digests``), which gives the same bytes."""
    d = np.ascontiguousarray(data)
    u8 = d.reshape(-1).view(np.uint8)
    h = hashlib.blake2b(digest_size=16)
    h.update(str(d.dtype).encode())
    h.update(repr(d.shape).encode())
    h.update(u8.nbytes.to_bytes(8, "little"))
    h.update(chunk_digests(u8))
    return h.digest()


def relation_digests(query: "JoinQuery", memo: Optional[Dict] = None,
                     chunk_digests=host_chunk_digests) -> Tuple[bytes, ...]:
    """:func:`table_digest` of each relation's ``data``, in relation order,
    its chunks hashed by ``chunk_digests``.

    A table bound several times (a self-join) is hashed once.  ``memo``
    carries the digests across the queries of one batch, keyed by
    ``id(data)``; it holds the array beside its digest, so no other array
    can take that id while the entry lives.  It is sound only while the
    tables are not written to, so it lives no longer than one batch."""
    memo = {} if memo is None else memo
    out = []
    for rel in query.relations:
        hit = memo.get(id(rel.data))
        if hit is None:
            hit = memo[id(rel.data)] = (rel.data, table_digest(rel.data, chunk_digests))
        out.append(hit[1])
    return tuple(out)


@dataclass(frozen=True)
class JoinQuery:
    """A simple join query: relations with pairwise-distinct schemes.

    ``force_general`` routes a binary query through the general (join-tree /
    HyperCube-shares) compiler instead of the paper's Theorem 6.2 pipeline —
    used to express e.g. a triangle as a generic 3-ary-capable plan.  Queries
    containing any non-binary relation always take the general route.
    """

    relations: Tuple[Relation, ...]
    force_general: bool = False

    @staticmethod
    def make(
        relations: Sequence[Relation], force_general: bool = False
    ) -> "JoinQuery":
        rels = tuple(relations)
        schemes = [r.edge for r in rels]
        if len(set(schemes)) != len(schemes):
            raise ValueError("query is not simple: duplicate schemes")
        for r in rels:
            if r.arity < 1:
                raise ValueError("relations need at least one attribute")
        return JoinQuery(relations=rels, force_general=force_general)

    @property
    def is_general(self) -> bool:
        """True when this query must take the general (non-Theorem-6.2) route."""
        return self.force_general or any(r.arity != 2 for r in self.relations)

    @property
    def attset(self) -> Tuple[Attr, ...]:
        return tuple(sorted({a for r in self.relations for a in r.scheme}))

    @property
    def m(self) -> int:
        return sum(len(r) for r in self.relations)

    @property
    def hypergraph(self) -> Hypergraph:
        return Hypergraph.from_edges([r.edge for r in self.relations])

    def relation_for(self, e: Edge) -> Relation:
        for r in self.relations:
            if r.edge == frozenset(e):
                return r
        raise KeyError(e)


# ---------------------------------------------------------------------------
# Reference evaluator (oracle)
# ---------------------------------------------------------------------------


def _hash_join(a_scheme: Tuple[Attr, ...], a: np.ndarray, b_rel: Relation):
    """Join intermediate (a_scheme, a) with b_rel; returns (scheme, rows)."""
    common = [x for x in a_scheme if x in b_rel.scheme]
    b_new = [x for x in b_rel.scheme if x not in a_scheme]
    out_scheme = tuple(a_scheme) + tuple(b_new)
    if a.shape[0] == 0 or len(b_rel) == 0:
        return out_scheme, np.zeros((0, len(out_scheme)), dtype=np.int64)

    if not common:  # cartesian product
        na, nb = a.shape[0], len(b_rel)
        left = np.repeat(a, nb, axis=0)
        right = np.tile(b_rel.data, (na, 1))
        return out_scheme, np.concatenate([left, right], axis=1)

    b_key_cols = [b_rel.scheme.index(x) for x in common]
    b_new_cols = [b_rel.scheme.index(x) for x in b_new]
    index: Dict[tuple, List[int]] = {}
    for i, row in enumerate(b_rel.data):
        index.setdefault(tuple(row[b_key_cols].tolist()), []).append(i)

    a_key_cols = [a_scheme.index(x) for x in common]
    out_rows = []
    for row in a:
        key = tuple(row[a_key_cols].tolist())
        for i in index.get(key, ()):
            if b_new_cols:
                out_rows.append(np.concatenate([row, b_rel.data[i, b_new_cols]]))
            else:
                out_rows.append(row.copy())
    if not out_rows:
        return out_scheme, np.zeros((0, len(out_scheme)), dtype=np.int64)
    return out_scheme, np.stack(out_rows)


def reference_join(query: JoinQuery) -> Relation:
    """Exact Join(Q) over sorted(attset) — the correctness oracle."""
    rels = list(query.relations)
    if not rels:
        raise ValueError("empty query")
    # Greedy connected order: start from the smallest relation, prefer the join
    # sharing the MOST attributes with the current intermediate (a multi-shared
    # join filters instead of fanning out — on a clique pattern it closes
    # triangles instead of growing Σ deg^k star intermediates), cartesian
    # products only when the remainder is disconnected.  Ranked over the full
    # k-ary schemes: shared-attribute count first (any arity, not capped at 2),
    # then fewest NEW attributes (bounds the intermediate width growth), then
    # input order for determinism.
    rels.sort(key=len)
    first = rels.pop(0)
    scheme, rows = first.scheme, first.data
    while rels:
        cur = set(scheme)
        j = max(
            range(len(rels)),
            key=lambda i: (
                len(set(rels[i].scheme) & cur),
                -len(set(rels[i].scheme) - cur),
                -i,
            ),
        )
        scheme, rows = _hash_join(scheme, rows, rels.pop(j))
    out_attrs = query.attset
    perm = [scheme.index(a) for a in out_attrs]
    return Relation.make(out_attrs, rows[:, perm] if rows.size else rows.reshape(0, len(perm)))


# ---------------------------------------------------------------------------
# Query/data generators (shared by tests + benchmarks)
# ---------------------------------------------------------------------------


def query_from_pattern(edges: Sequence[Tuple[Attr, Attr]], tables: Dict[Tuple[Attr, Attr], np.ndarray]) -> JoinQuery:
    rels = [Relation.make(e, tables[e]) for e in edges]
    return JoinQuery.make(rels)


def pattern_edges(kind: str, n: int) -> List[Tuple[Attr, Attr]]:
    """Named query families from the paper: cycles, cliques, lines (paths), stars."""
    attrs = [f"X{i}" for i in range(n)]
    if kind == "cycle":
        return [(attrs[i], attrs[(i + 1) % n]) for i in range(n)]
    if kind == "clique":
        return [(attrs[i], attrs[j]) for i in range(n) for j in range(i + 1, n)]
    if kind == "line":
        return [(attrs[i], attrs[i + 1]) for i in range(n - 1)]
    if kind == "star":
        return [(attrs[0], attrs[i]) for i in range(1, n)]
    raise ValueError(kind)


def zipf_relation(
    rng: np.random.Generator,
    scheme: Tuple[Attr, ...],
    n: int,
    dom_size: int,
    skew: float = 0.0,
) -> Relation:
    """n tuples; each column drawn Zipf(skew) over [0, dom_size) (skew=0 → uniform).
    Arity follows ``scheme`` (one sampled column per attribute)."""
    cols = []
    for _ in range(len(scheme)):
        if skew <= 0.0:
            cols.append(rng.integers(0, dom_size, size=n))
        else:
            ranks = np.arange(1, dom_size + 1, dtype=np.float64)
            probs = ranks ** (-skew)
            probs /= probs.sum()
            cols.append(rng.choice(dom_size, size=n, p=probs))
    return Relation.make(scheme, np.stack(cols, axis=1))


def random_query(
    rng: np.random.Generator,
    kind: str,
    n_attrs: int,
    tuples_per_rel: int,
    dom_size: int,
    skew: float = 0.0,
) -> JoinQuery:
    edges = pattern_edges(kind, n_attrs)
    rels = [zipf_relation(rng, e, tuples_per_rel, dom_size, skew) for e in edges]
    return JoinQuery.make(rels)


def hub_triangle_query(
    n: int,
    hub_n: int,
    dom_size: int,
    hub: int = 999,
    seed: int = 1,
) -> JoinQuery:
    """Triangle with one planted heavy value (``hub``) on X0 only: ``hub_n``
    tuples with distinct partners on each X0-edge (so dedup keeps them all)
    plus ``n`` uniform tuples per relation.  With λ chosen so that
    hub_n ≥ ⌈m/λ⌉ > per-value uniform counts, the taxonomy yields exactly the
    H=∅ stage (a cyclic light join) and an H={X0} stage (cross-edge
    semi-joins, no isolated attributes) — the canonical light-subquery
    exercise shared by tests and benchmarks."""
    rng = np.random.default_rng(seed)
    planted = np.stack([np.full(hub_n, hub), np.arange(hub_n)], axis=1)
    r01 = np.concatenate([planted, rng.integers(0, dom_size, (n, 2))])
    r02 = np.concatenate([planted, rng.integers(0, dom_size, (n, 2))])
    r12 = rng.integers(0, dom_size, size=(n, 2))
    return JoinQuery.make(
        [
            Relation.make(("X0", "X1"), r01),
            Relation.make(("X0", "X2"), r02),
            Relation.make(("X1", "X2"), r12),
        ]
    )


def hub_star_query(
    n: int,
    hub_n: int,
    dom_size: int,
    hub: int = 777,
    seed: int = 2,
    leaves: Sequence[Attr] = ("X1", "X2", "X3"),
) -> JoinQuery:
    """Star with a planted heavy hub on the center X0: ``hub_n`` tuples with
    distinct partners per leaf edge plus ``n`` uniform tuples.  With λ chosen
    so the hub is heavy, the H={X0} stage has *every* leaf isolated and no
    surviving light edges — the pure Lemma 3.1 CP-grid exercise shared by the
    parity tests, the multi-device checks, and the backend benchmark."""
    rng = np.random.default_rng(seed)
    rels = []
    for leaf in leaves:
        planted = np.stack([np.full(hub_n, hub), np.arange(hub_n) + 100], axis=1)
        noise = rng.integers(0, dom_size, size=(n, 2))
        rels.append(Relation.make(("X0", leaf), np.concatenate([planted, noise])))
    return JoinQuery.make(rels)


def general_pattern_schemes(kind: str) -> List[Tuple[Attr, ...]]:
    """Named arbitrary-arity query families (the general-join workloads).

    * ``star3``     — a 3-ary fact F(A,B,C) with one binary dimension per key:
                      the smallest k≥3 acyclic shape (TPC-H-ish star).
    * ``snowflake`` — star3 with one dimension normalized a level deeper.
    * ``path4``     — four relations chained in a path, mixing arities 2 and 3.
    * ``triangle``  — the binary triangle (cyclic; pair with force_general to
                      exercise the generalized HyperCube-shares route).
    """
    if kind == "star3":
        return [("A", "B", "C"), ("A", "A1"), ("B", "B1"), ("C", "C1")]
    if kind == "snowflake":
        return [("A", "B", "C"), ("A", "A1"), ("A1", "A2"), ("B", "B1"), ("C", "C1")]
    if kind == "path4":
        return [("X0", "X1"), ("X1", "X2", "X3"), ("X3", "X4"), ("X4", "X5", "X6")]
    if kind == "triangle":
        return [("X0", "X1"), ("X0", "X2"), ("X1", "X2")]
    raise ValueError(kind)


def general_query(
    kind: str,
    n: int,
    dom_size: int,
    skew: float = 0.0,
    seed: int = 7,
    force_general: bool = True,
) -> JoinQuery:
    """Instantiate a `general_pattern_schemes` family with zipf/uniform data."""
    rng = np.random.default_rng(seed)
    rels = [
        zipf_relation(rng, s, n, dom_size, skew)
        for s in general_pattern_schemes(kind)
    ]
    return JoinQuery.make(rels, force_general=force_general)


def random_general_query(
    rng: np.random.Generator,
    n_rels: int = 3,
    max_arity: int = 4,
    n_attrs: int = 5,
    tuples_per_rel: int = 24,
    dom_size: int = 8,
    skew: float = 0.0,
    share_tables: bool = False,
    allow_empty: bool = True,
) -> JoinQuery:
    """Random k-ary query for the differential harness: arities in [1, max_arity],
    pairwise-distinct schemes over ``n_attrs`` attributes (acyclic and cyclic
    shapes both arise), optional shared physical tables between same-scheme-size
    relations, and occasional empty/singleton relations."""
    attrs = [f"X{i}" for i in range(n_attrs)]
    schemes: List[Tuple[Attr, ...]] = []
    seen = set()
    guard = 0
    while len(schemes) < n_rels and guard < 200:
        guard += 1
        arity = int(rng.integers(1, max_arity + 1))
        arity = min(arity, n_attrs)
        s = tuple(sorted(rng.choice(n_attrs, size=arity, replace=False).tolist()))
        if s in seen:
            continue
        seen.add(s)
        schemes.append(tuple(attrs[i] for i in s))
    rels = []
    shared: Dict[int, Relation] = {}
    for s in schemes:
        if allow_empty and rng.random() < 0.08:
            n = 0
        elif rng.random() < 0.08:
            n = 1
        else:
            n = int(rng.integers(1, tuples_per_rel + 1))
        if share_tables and len(s) in shared and rng.random() < 0.5:
            src = shared[len(s)]
            rels.append(Relation.make(s, src.data, table=src.table))
            continue
        r = zipf_relation(rng, s, n, dom_size, skew)
        if share_tables:
            # name by relation index — unique even when several same-arity
            # relations are generated independently (only the first of each
            # arity is kept as the reusable shared table)
            r = Relation.make(s, r.data, table=f"t{len(s)}_{len(rels)}")
            shared.setdefault(len(s), r)
        rels.append(r)
    return JoinQuery.make(rels)


def disconnected_query(
    n: int, dom_size: int, skew: float = 0.0, seed: int = 11
) -> JoinQuery:
    """Two components (A,B) ⋈ (C,D): the H=∅ light subquery is disconnected
    (an in-cell cartesian across HyperCube components); with skew > 0 heavy
    values add stages mixing an isolated attribute with a light component."""
    rng = np.random.default_rng(seed)
    return JoinQuery.make(
        [
            zipf_relation(rng, ("A", "B"), n, dom_size, skew),
            zipf_relation(rng, ("C", "D"), n, dom_size, skew),
        ]
    )


def query_from_arrays(
    relations: Sequence[Tuple[Sequence[Attr], np.ndarray, Optional[str]]],
    force_general: bool = False,
) -> JoinQuery:
    """Build a query from ``(scheme, data, table)`` triples.

    Each ``data`` array is deduplicated like :meth:`Relation.make`; triples
    that pass the same array object under the same ``table`` share one
    deduplicated copy, so a self-join-shaped query keeps a single physical
    table behind all of its relations."""
    memo: Dict[Tuple[int, Optional[str]], np.ndarray] = {}
    rels = []
    for scheme, data, table in relations:
        key = (id(data), table)
        if key not in memo:
            memo[key] = Relation.make(scheme, data, table=table).data
        rels.append(Relation(scheme=tuple(scheme), data=memo[key], table=table))
    return JoinQuery.make(rels, force_general=force_general)
