"""GYO reduction, acyclicity detection, and join trees for general queries.

An (α-)acyclic hypergraph is one that GYO-reduces to a single edge: repeatedly
remove an *ear* — an edge e whose vertices are each either exclusive to e or
all contained in a single witness edge f — until one edge remains.  Recording
(ear, witness) pairs during the reduction yields a **join tree**: nodes are the
query's relations and every tree edge (child, parent) is labeled with
scheme(child) ∩ scheme(parent).  The classic result (Beeri–Fagin–Maier–
Yannakakis) gives the *running intersection property*: for any two nodes, the
attributes they share appear on every node along the unique tree path between
them — exactly the invariant that makes Yannakakis' two semijoin sweeps a full
reducer.  GYO is confluent: greedy ear removal in any order succeeds iff the
hypergraph is acyclic (tests/test_jointree.py brute-forces all removal orders
to confirm).

Disconnected acyclic queries reduce component-by-component; the components are
stitched into one tree with empty-label edges (a semijoin over ∅ shared
attributes degenerates to "keep the parent iff the child is non-empty", which
is exactly the cartesian-product semantics the executor implements).

The join tree drives the general compiler in ``repro_torch.mpc.program``
(Yannakakis semijoin sweeps + tree-ordered bottom-up join) and is re-checked
structurally by the ``join-tree`` rule in ``repro_torch.mpc.verify``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

Attrs = FrozenSet[str]


@dataclass(frozen=True)
class JoinTree:
    """A rooted join tree over relation indices 0..n-1.

    ``edges`` lists (child, parent, shared_attrs) in **GYO removal order** —
    children always appear before any edge that removes their parent, so the
    sequence read forward is a valid leaves-to-root semijoin sweep (the "up"
    sweep) and read backward a valid root-to-leaves sweep (the "down" sweep).
    ``root`` is the single surviving node.  A query with one relation has no
    edges.
    """

    n_nodes: int
    root: int
    edges: Tuple[Tuple[int, int, Attrs], ...]

    @property
    def parent(self) -> Dict[int, int]:
        return {c: p for c, p, _ in self.edges}

    def path(self, a: int, b: int) -> List[int]:
        """Nodes on the unique tree path from a to b (inclusive)."""
        up: Dict[int, Optional[int]] = self.parent  # type: ignore[assignment]
        anc_a = [a]
        while anc_a[-1] in up:
            anc_a.append(up[anc_a[-1]])
        anc_b = [b]
        while anc_b[-1] in up:
            anc_b.append(up[anc_b[-1]])
        seen = set(anc_a)
        meet = next(x for x in anc_b if x in seen)
        pa = anc_a[: anc_a.index(meet) + 1]
        pb = anc_b[: anc_b.index(meet)]
        return pa + pb[::-1]


def _find_ear(
    alive: List[int], schemes: Sequence[Attrs]
) -> Optional[Tuple[int, int]]:
    """One GYO step over the still-alive edges: return (ear, witness) or None.

    A vertex is *exclusive* to e if no other alive edge contains it; e is an
    ear with witness f when every non-exclusive vertex of e lies in f.  An edge
    whose vertices are all exclusive (an isolated component remnant) takes any
    other alive edge as witness with an empty shared label.  Deterministic:
    lowest ear index first, then lowest witness index."""
    for i in alive:
        others = [j for j in alive if j != i]
        if not others:
            return None
        shared = {
            v for v in schemes[i]
            if any(v in schemes[j] for j in others)
        }
        if not shared:
            return i, others[0]
        for j in others:
            if shared <= schemes[j]:
                return i, j
    return None


def gyo_reduction(
    schemes: Sequence[Attrs],
) -> Optional[List[Tuple[int, int, Attrs]]]:
    """Run GYO to completion.  Returns the (ear, witness, shared) removal
    sequence when the hypergraph is acyclic, None when it is cyclic.
    ``shared`` is scheme(ear) ∩ scheme(witness) *at removal time's original
    schemes* — the semijoin attributes of the corresponding join-tree edge."""
    schemes = [frozenset(s) for s in schemes]
    alive = list(range(len(schemes)))
    out: List[Tuple[int, int, Attrs]] = []
    while len(alive) > 1:
        step = _find_ear(alive, schemes)
        if step is None:
            return None
        ear, witness = step
        # ear ∩ witness equals the ear's non-exclusive vertex set (the ear
        # condition puts every shared vertex inside the witness), so the label
        # is exactly the semijoin attribute set of this tree edge.
        out.append((ear, witness, frozenset(schemes[ear] & schemes[witness])))
        alive.remove(ear)
    return out


def is_acyclic(schemes: Sequence[Attrs]) -> bool:
    return gyo_reduction(schemes) is not None


def build_join_tree(schemes: Sequence[Attrs]) -> Optional[JoinTree]:
    """GYO-derived join tree over relation indices, or None when cyclic."""
    seq = gyo_reduction(schemes)
    if seq is None:
        return None
    n = len(schemes)
    if n == 1:
        return JoinTree(n_nodes=1, root=0, edges=())
    removed = {ear for ear, _, _ in seq}
    root = next(i for i in range(n) if i not in removed)
    return JoinTree(n_nodes=n, root=root, edges=tuple(seq))


def running_intersection_ok(
    schemes: Sequence[Attrs], tree: JoinTree
) -> bool:
    """Direct check of the running intersection property: for every node pair
    (a, b), scheme(a) ∩ scheme(b) ⊆ scheme(x) for every x on path(a, b).
    Also validates the tree's structural integrity (labels match the schemes,
    every non-root node has exactly one parent edge, no cycles)."""
    schemes = [frozenset(s) for s in schemes]
    n = tree.n_nodes
    if n != len(schemes) or not (0 <= tree.root < n):
        return False
    parent = {}
    for c, p, shared in tree.edges:
        if c in parent or c == tree.root or not (0 <= c < n and 0 <= p < n):
            return False
        parent[c] = p
        if not frozenset(shared) <= (schemes[c] & schemes[p]):
            return False
    if set(parent) != set(range(n)) - {tree.root}:
        return False
    # acyclicity of the parent pointers (root reachable from everywhere)
    for c in parent:
        seen = {c}
        while c in parent:
            c = parent[c]
            if c in seen:
                return False
            seen.add(c)
    for a in range(n):
        for b in range(a + 1, n):
            common = schemes[a] & schemes[b]
            if not common:
                continue
            for x in tree.path(a, b):
                if not common <= schemes[x]:
                    return False
    return True


def brute_force_acyclic(schemes: Sequence[Attrs]) -> bool:
    """Reference acyclicity: does ANY ear-removal order reduce to one edge?
    Exponential — test-only (GYO's greedy confluence is what it validates)."""
    schemes = [frozenset(s) for s in schemes]

    def ears(alive: Tuple[int, ...]) -> List[int]:
        out = []
        for i in alive:
            others = [j for j in alive if j != i]
            shared = {v for v in schemes[i] if any(v in schemes[j] for j in others)}
            if not shared or any(shared <= schemes[j] for j in others):
                out.append(i)
        return out

    def solve(alive: Tuple[int, ...]) -> bool:
        if len(alive) <= 1:
            return True
        return any(
            solve(tuple(j for j in alive if j != i)) for i in ears(alive)
        )

    return solve(tuple(range(len(schemes))))
