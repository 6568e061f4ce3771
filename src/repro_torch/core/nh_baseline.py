"""Sequential NH baseline (Sariyüce–Pinar [49]) + pure-Python oracles.

Counterpart of ``repro.core.nh_baseline``: a numpy/Python copy of the
reference's module, so agreement between it and the vectorized code means
something.  Two roles:

  * the paper's sequential comparison point (Fig. 9): interleaved peeling
    one r-clique at a time over a heap, and a union-find hierarchy;
  * the correctness oracle (exact coreness, hierarchy join levels).

``nh_coreness`` backs the registered ``nh`` backend
(``repro_torch.core.backends``).  The problem's tensors are copied to the
host once; everything after that is Python over numpy, so its cost does
not depend on the device.
"""
from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np
import torch

from .hierarchy import HierarchyTree
from .incidence import NucleusProblem


def _host(x) -> np.ndarray:
    """A host numpy view of a tensor (any device) or array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def nh_coreness(problem: NucleusProblem) -> Tuple[np.ndarray, int]:
    """Sequential exact peeling: one r-clique (min s-degree) at a time.

    Returns (core numbers, number of *batched* peeling rounds that the
    parallel algorithm would need = the peeling complexity rho observed).
    """
    n_r = problem.n_r
    inc = _host(problem.inc_rid)          # (n_s, C)
    mem_off = _host(problem.mem_offsets)  # (n_r + 1,)
    mem_sid = _host(problem.mem_sids)
    deg = _host(problem.deg0).copy()
    core = np.zeros(n_r, np.int64)
    peeled = np.zeros(n_r, bool)
    s_alive = np.ones(inc.shape[0], bool)

    heap = [(int(deg[i]), i) for i in range(n_r)]
    heapq.heapify(heap)
    kmax = 0
    done = 0
    while done < n_r:
        d, i = heapq.heappop(heap)
        if peeled[i] or d != deg[i]:
            continue  # stale entry
        kmax = max(kmax, d)
        core[i] = kmax
        peeled[i] = True
        done += 1
        for sid in mem_sid[mem_off[i]:mem_off[i + 1]]:
            if not s_alive[sid]:
                continue
            s_alive[sid] = False
            for rid in inc[sid]:
                if not peeled[rid]:
                    deg[rid] -= 1
                    heapq.heappush(heap, (int(deg[rid]), int(rid)))
    # observed batched peeling complexity: rounds where all current-min
    # cliques are removed together.
    rho = len(np.unique(core)) if n_r else 0
    return core, rho


class _SeqUnionFind:
    __slots__ = ("parent",)

    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if ra > rb:
            ra, rb = rb, ra
        self.parent[rb] = ra  # min-id root, matching the batched UF
        return ra


def nh_hierarchy(problem: NucleusProblem, core: np.ndarray) -> HierarchyTree:
    """Sequential bottom-up hierarchy via union-find (the NH strategy).

    Edges between s-clique-adjacent r-cliques carry weight
    min(core_u, core_v); sweeping levels descending and uniting edges of the
    current level reproduces Algorithm 1's per-level connectivity.
    """
    n_r = problem.n_r
    inc = _host(problem.inc_rid)
    core = _host(core)
    # All adjacent pairs (the paper's L_i lists), deduped.
    pairs = set()
    C = inc.shape[1] if inc.size else 0
    for row in inc:
        for a in range(C):
            for b in range(a + 1, C):
                u, v = int(row[a]), int(row[b])
                if u == v:
                    continue
                if u > v:
                    u, v = v, u
                pairs.add((u, v))
    by_level: dict[int, list[tuple[int, int]]] = {}
    for (u, v) in pairs:
        w = int(min(core[u], core[v]))
        by_level.setdefault(w, []).append((u, v))

    cap = 2 * max(n_r, 1)
    parent = np.full(cap, -1, np.int64)
    level = np.zeros(cap, np.int64)
    level[:n_r] = core
    node_of = np.arange(n_r, dtype=np.int64)  # uf root -> tree node carrying it
    uf = _SeqUnionFind(n_r)
    next_id = n_r
    for w in sorted(by_level, reverse=True):
        # group this level's edges into merged components
        touched_roots = set()
        for (u, v) in by_level[w]:
            touched_roots.add(uf.find(u))
            touched_roots.add(uf.find(v))
        for (u, v) in by_level[w]:
            uf.union(u, v)
        groups: dict[int, list[int]] = {}
        for old_root in touched_roots:
            groups.setdefault(uf.find(old_root), []).append(old_root)
        for new_root, olds in sorted(groups.items()):
            if len(olds) < 2:
                continue
            nid = next_id
            next_id += 1
            level[nid] = w
            for o in sorted(olds):
                parent[node_of[o]] = nid
            node_of[new_root] = nid
    return HierarchyTree(n_leaves=n_r, parent=parent[:next_id].copy(),
                         level=level[:next_id].copy())


def nh_full(problem: NucleusProblem):
    """End-to-end sequential NH: coreness + hierarchy (the Fig. 9 baseline)."""
    core, rho = nh_coreness(problem)
    tree = nh_hierarchy(problem, core)
    return core, tree, rho


def brute_force_coreness(problem: NucleusProblem) -> np.ndarray:
    """Definition-level oracle: iteratively delete r-cliques with s-degree < c.

    O(n_r^2 * n_s)-ish; only for tiny graphs in tests. Independent of the
    peeling implementations above (different algorithm entirely).
    """
    n_r = problem.n_r
    inc = _host(problem.inc_rid)
    core = np.zeros(n_r, np.int64)
    c = 1
    alive = np.ones(n_r, bool)
    while alive.any():
        # prune to the c-(r,s) nucleus: every r-clique needs s-degree >= c
        changed = True
        cur = alive.copy()
        while changed:
            s_ok = cur[inc].all(axis=1) if inc.size else np.zeros(0, bool)
            deg = np.zeros(n_r, np.int64)
            if inc.size:
                np.add.at(deg, inc[s_ok].reshape(-1), 1)
            nxt = cur & (deg >= c)
            changed = bool((nxt != cur).any())
            cur = nxt
        core[cur] = c
        alive = cur
        c += 1
    return core
