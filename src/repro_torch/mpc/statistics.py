"""Distributed heavy-value statistics (the paper's 'histogram', Sec. 6 preprocessing).

Three metered rounds (see DESIGN.md §6 for the deviation note):

  1. ``stats-candidates``: machine i broadcasts, per (relation R, attribute X), every
     value with local count ≥ L_{i,R}/λ (weighted pigeonhole: any globally heavy value
     is a candidate on ≥1 machine), plus its local |R| counts. ≤ λ candidates per
     (machine, R, X) ⇒ round load O(p·λ).
  2. ``stats-counts``: every machine broadcasts its local count for every candidate;
     all machines now agree on exact global counts ⇒ exact heavy sets. Load O(p·λ).
  3. ``stats-extended``: heavy-conditioned counts needed to compute m_η exactly:
     cond(e, X, x)=|{u∈R_e : u(X)=x heavy, other light}|, pair(e, x, y) for heavy-heavy
     pairs, light_cnt(e). Load O(p·λ²).

All ≤ O(p·λ²+p) received words per machine — dominated by m/p^{1/ρ} when m ≥ p³
(the paper's own O(p²) Step-3 statistic round is bigger). The output HeavyStats is
identical on every machine by construction; we return one copy and tests assert it
matches the centralized ``compute_stats`` oracle.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from ..core.query import JoinQuery
from ..core.taxonomy import HeavyStats
from .simulator import MPCSimulator


def distributed_stats(sim: MPCSimulator, query: JoinQuery, lam: int) -> HeavyStats:
    edges = [rel.edge for rel in query.relations]
    eidx = {e: i for i, e in enumerate(edges)}
    schemes = {rel.edge: rel.scheme for rel in query.relations}

    # ---- round 1: candidates + local sizes ---------------------------------
    sim.begin_round("stats-candidates")
    for mid in range(sim.p):
        size_rows = []
        cand_rows = []
        for rel in query.relations:
            local = sim.local(mid, ("in", rel.edge), arity=rel.arity)
            size_rows.append([eidx[rel.edge], local.shape[0]])
            n_local = local.shape[0]
            if n_local == 0:
                continue
            thr = max(1, int(np.ceil(n_local / lam)))
            for col, attr in enumerate(rel.scheme):
                vals, cnts = np.unique(local[:, col], return_counts=True)
                cands = vals[cnts >= thr]
                for v in cands.tolist():
                    cand_rows.append([eidx[rel.edge], col, v])
        sim.broadcast(("st-size", mid), np.array(size_rows, dtype=np.int64))
        if cand_rows:
            sim.broadcast(("st-cand", mid), np.array(cand_rows, dtype=np.int64))
    sim.end_round()

    # every machine reconstructs the identical candidate set + global m
    cand_set = set()
    m_global = 0
    for mid in range(sim.p):
        sizes = sim.local(0, ("st-size", mid), arity=2)
        m_global += int(sizes[:, 1].sum())
        rows = sim.local(0, ("st-cand", mid), arity=3)
        for e_i, col, v in rows.tolist():
            cand_set.add((e_i, col, v))
    cand_list = sorted(cand_set)
    cand_pos = {c: i for i, c in enumerate(cand_list)}

    # ---- round 2: exact counts for candidates ------------------------------
    sim.begin_round("stats-counts")
    for mid in range(sim.p):
        rows = []
        for rel in query.relations:
            local = sim.local(mid, ("in", rel.edge), arity=rel.arity)
            if local.shape[0] == 0:
                continue
            for col in range(rel.arity):
                vals, cnts = np.unique(local[:, col], return_counts=True)
                for v, c in zip(vals.tolist(), cnts.tolist()):
                    key = (eidx[rel.edge], col, v)
                    if key in cand_pos:
                        rows.append([cand_pos[key], c])
        if rows:
            sim.broadcast(("st-cnt", mid), np.array(rows, dtype=np.int64))
    sim.end_round()

    global_cnt = np.zeros(len(cand_list), dtype=np.int64)
    for mid in range(sim.p):
        rows = sim.local(0, ("st-cnt", mid), arity=2)
        for pos, c in rows.tolist():
            global_cnt[pos] += c

    threshold = max(1, -(-m_global // lam))  # ceil(m/λ)
    heavy_sets: Dict[str, set] = defaultdict(set)
    for (e_i, col, v), cnt in zip(cand_list, global_cnt.tolist()):
        if cnt >= threshold:
            attr = schemes[edges[e_i]][col]
            heavy_sets[attr].add(v)
    heavy = {a: np.array(sorted(s), dtype=np.int64) for a, s in heavy_sets.items()}

    stats = HeavyStats(
        lam=lam, m=m_global, heavy=heavy, cond={}, pair={}, light_cnt={}
    )

    # ---- round 3: extended (heavy-conditioned) records ---------------------
    sim.begin_round("stats-extended")
    for mid in range(sim.p):
        cond_rows, pair_rows, light_rows = [], [], []
        for rel in query.relations:
            local = sim.local(mid, ("in", rel.edge), arity=rel.arity)
            if local.shape[0] == 0:
                continue
            if rel.arity != 2:
                # k-ary edges carry no binary cond/pair records (the general
                # route never reads them) — only the all-light count, exactly
                # mirroring the centralized compute_stats guard.
                heavy_any = np.zeros(local.shape[0], dtype=bool)
                for col, attr in enumerate(rel.scheme):
                    heavy_any |= stats.is_heavy(attr, local[:, col])
                light_rows.append([eidx[rel.edge], int((~heavy_any).sum())])
                continue
            x_attr, y_attr = rel.scheme
            hx = stats.is_heavy(x_attr, local[:, 0])
            hy = stats.is_heavy(y_attr, local[:, 1])
            light_rows.append([eidx[rel.edge], int((~hx & ~hy).sum())])
            for col, (mask_h, mask_other) in enumerate([(hx, hy), (hy, hx)]):
                sel = mask_h & ~mask_other
                vals, cnts = np.unique(local[sel, col], return_counts=True)
                for v, c in zip(vals.tolist(), cnts.tolist()):
                    cond_rows.append([eidx[rel.edge], col, v, c])
            sel = hx & hy
            if sel.any():
                uniq, cnts = np.unique(local[sel], axis=0, return_counts=True)
                for (vx, vy), c in zip(uniq.tolist(), cnts.tolist()):
                    pair_rows.append([eidx[rel.edge], vx, vy, c])
        if cond_rows:
            sim.broadcast(("st-cond", mid), np.array(cond_rows, dtype=np.int64))
        if pair_rows:
            sim.broadcast(("st-pair", mid), np.array(pair_rows, dtype=np.int64))
        sim.broadcast(("st-light", mid), np.array(light_rows, dtype=np.int64))
    sim.end_round()

    light_acc: Dict[int, int] = defaultdict(int)
    for mid in range(sim.p):
        for e_i, col, v, c in sim.local(0, ("st-cond", mid), arity=4).tolist():
            attr = schemes[edges[e_i]][col]
            key = (edges[e_i], attr, v)
            stats.cond[key] = stats.cond.get(key, 0) + c
        for e_i, vx, vy, c in sim.local(0, ("st-pair", mid), arity=4).tolist():
            key = (edges[e_i], vx, vy)
            stats.pair[key] = stats.pair.get(key, 0) + c
        for e_i, c in sim.local(0, ("st-light", mid), arity=2).tolist():
            light_acc[e_i] += c
    for e_i, c in light_acc.items():
        stats.light_cnt[edges[e_i]] = c
    for rel in query.relations:  # edges never seen (all-empty locals)
        stats.light_cnt.setdefault(rel.edge, 0)

    # drop the broadcast working tags from stores (they are metadata, not relation data)
    for mid in range(sim.p):
        for tag in list(sim.stores[mid].keys()):
            if isinstance(tag, tuple) and str(tag[0]).startswith("st-"):
                del sim.stores[mid][tag]
    return stats
