"""Community-based reorderings: Rabbit Order [5] and SlashBurn [37]."""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import HostCSR
from repro_torch.core.reorder.graph import (Adjacency, bfs_levels, build_adjacency,
                                      connected_components)

__all__ = ["rabbit_order", "slashburn"]


def _label_propagation(adj: Adjacency, seed: int,
                       max_rounds: int = 10) -> np.ndarray:
    """Community labels via synchronous-ish label propagation."""
    rng = np.random.default_rng(seed)
    labels = np.arange(adj.n, dtype=np.int64)
    order = np.arange(adj.n)
    for _ in range(max_rounds):
        rng.shuffle(order)
        changed = 0
        for v in order:
            nbrs = adj.neighbors(int(v))
            if nbrs.size == 0:
                continue
            lbls = labels[nbrs]
            vals, counts = np.unique(lbls, return_counts=True)
            best = vals[np.argmax(counts)]
            if best != labels[v]:
                labels[v] = best
                changed += 1
        if changed < max(1, adj.n // 200):
            break
    return labels


def rabbit_order(a: HostCSR, seed: int = 0) -> np.ndarray:
    """Hierarchical community reordering in the spirit of Rabbit Order.

    Communities from label propagation are laid out contiguously; communities
    are sequenced by a BFS over the community quotient graph (keeping
    connected communities adjacent — Rabbit's hierarchical locality), and
    within a community vertices are ordered by descending internal degree.
    """
    adj = build_adjacency(a)
    labels = _label_propagation(adj, seed)
    uniq, inv = np.unique(labels, return_inverse=True)
    ncomm = uniq.size
    # community quotient adjacency
    edges = set()
    for v in range(adj.n):
        cv = inv[v]
        for u in adj.neighbors(v):
            cu = inv[u]
            if cu != cv:
                edges.add((min(cv, cu), max(cv, cu)))
    qadj: list[set[int]] = [set() for _ in range(ncomm)]
    for x, y in edges:
        qadj[x].add(y)
        qadj[y].add(x)
    sizes = np.bincount(inv, minlength=ncomm)
    # BFS over communities from the largest
    comm_order = []
    seen = np.zeros(ncomm, dtype=bool)
    for s in np.argsort(-sizes, kind="stable"):
        if seen[s]:
            continue
        stack = [int(s)]
        seen[s] = True
        while stack:
            c = stack.pop(0)
            comm_order.append(c)
            nxt = sorted(qadj[c] - set(np.flatnonzero(seen).tolist()),
                         key=lambda x: -sizes[x])
            for nn in nxt:
                if not seen[nn]:
                    seen[nn] = True
                    stack.append(nn)
    deg = adj.degrees()
    perm_parts = []
    members_by_comm: list[list[int]] = [[] for _ in range(ncomm)]
    for v in range(adj.n):
        members_by_comm[inv[v]].append(v)
    for c in comm_order:
        mem = np.asarray(members_by_comm[c], dtype=np.int64)
        perm_parts.append(mem[np.argsort(-deg[mem], kind="stable")])
    perm = np.concatenate(perm_parts)
    if a.nrows > adj.n:
        perm = np.concatenate([perm, np.arange(adj.n, a.nrows,
                                               dtype=np.int64)])
    return perm


def slashburn(a: HostCSR, seed: int = 0, k_frac: float = 0.01,
              max_iter: int = 64) -> np.ndarray:
    """SlashBurn: hubs to the front, non-GCC spokes to the back, recurse."""
    adj = build_adjacency(a)
    n = adj.n
    k = max(1, int(np.ceil(k_frac * n)))
    active = np.ones(n, dtype=bool)
    front: list[np.ndarray] = []
    back: list[np.ndarray] = []
    deg = adj.degrees().astype(np.int64)

    for _ in range(max_iter):
        live = np.flatnonzero(active)
        if live.size == 0:
            break
        if live.size <= k:
            front.append(live[np.argsort(-deg[live], kind="stable")])
            active[live] = False
            break
        # 1) slash top-k hubs by current degree within the active subgraph
        live_deg = np.zeros(n, dtype=np.int64)
        for v in live:
            nbrs = adj.neighbors(int(v))
            live_deg[v] = int(active[nbrs].sum())
        hubs = live[np.argsort(-live_deg[live], kind="stable")[:k]]
        front.append(hubs)
        active[hubs] = False
        # 2) spokes: every non-giant component goes to the back
        comp = connected_components(adj, active)
        live = np.flatnonzero(active)
        if live.size == 0:
            break
        cids, counts = np.unique(comp[live], return_counts=True)
        giant = cids[np.argmax(counts)]
        spokes = live[comp[live] != giant]
        if spokes.size:
            # smaller components last, ordered by size then id
            back.append(spokes[np.argsort(comp[spokes], kind="stable")])
            active[spokes] = False

    rest = np.flatnonzero(active)
    mid = [rest[np.argsort(-deg[rest], kind="stable")]] if rest.size else []
    perm = np.concatenate(front + mid + back[::-1]) if (front or mid or back) \
        else np.empty(0, np.int64)
    assert np.unique(perm).size == n
    if a.nrows > n:
        perm = np.concatenate([perm, np.arange(n, a.nrows, dtype=np.int64)])
    return perm
