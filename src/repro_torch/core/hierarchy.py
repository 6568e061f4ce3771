"""Hierarchy construction: the tree container and the ANH-TE / ANH-BL
analogs (counterpart of ``repro.core.hierarchy``).

Tree representation: node ids 0..n_r-1 are leaves (one per r-clique),
internal nodes are appended.  ``parent[i] == -1`` marks roots; ``level[i]``
is the merge level (for leaves: the clique's core number).  A forest with
n_r leaves where every internal node has >= 2 children has < 2 * n_r
nodes, so arrays are preallocated.

  * ``hierarchy_edges`` builds Algorithm 1's per-level edge tables as flat
    (u, v, w) tensors on the problem's device: per s-clique the members
    sorted by core descending and linked consecutively (chain reduction,
    connectivity-equivalent to all C(C,2) pairs at every level), then one
    sort by (w descending, lo, hi) and a dedup.  The sorts are stable, key
    by key, so the order is the reference's ``lexsort`` order.
  * ``build_hierarchy_levels`` (``hierarchy="two_phase"``) sweeps one
    union-find forest over the levels descending, one
    ``graph.connectivity.connected_components(init=)`` per level;
    ``build_hierarchy_basic`` (``"basic"``) re-runs connectivity from
    scratch per level (the paper's deliberately work-inefficient
    baseline).  Both are host-driven over levels; the merges are recorded
    by ``emit_merges`` in host numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.connectivity import connected_components, pointer_jump
from ..graph.container import INT


@dataclasses.dataclass
class HierarchyTree:
    n_leaves: int
    parent: np.ndarray  # (n_nodes,) int64, -1 for roots
    level: np.ndarray   # (n_nodes,) int64

    @property
    def n_nodes(self) -> int:
        return int(self.parent.shape[0])

    @property
    def n_internal(self) -> int:
        return self.n_nodes - self.n_leaves

    def ancestor_at_level(self, c: int) -> np.ndarray:
        """For each leaf: highest ancestor with level >= c (-1 if core < c).

        The "cut the hierarchy" query behind Fig. 10: the returned node ids
        label the c-(r,s) nuclei.
        """
        node = np.arange(self.n_leaves, dtype=np.int64)
        cur = np.where(self.level[: self.n_leaves] >= c, node, -1)
        # climb one level a step; a leaf whose parent fails the test never
        # moves again, so each step visits only the leaves still climbing
        act = np.flatnonzero(cur >= 0)
        while act.size:
            p = self.parent[cur[act]]
            ok = p >= 0
            ok[ok] = self.level[p[ok]] >= c
            act = act[ok]
            cur[act] = p[ok]
        return cur


def new_tree_buffers(n_r: int, core_np: np.ndarray):
    cap = 2 * max(n_r, 1)
    parent = np.full(cap, -1, np.int64)
    level = np.zeros(cap, np.int64)
    level[:n_r] = core_np
    node_of = np.arange(n_r, dtype=np.int64)
    return parent, level, node_of


def finish_tree(n_r: int, parent: np.ndarray, level: np.ndarray,
                next_id: int) -> HierarchyTree:
    return HierarchyTree(n_leaves=n_r, parent=parent[:next_id].copy(),
                         level=level[:next_id].copy())


# ---------------------------------------------------------------------------
# Hierarchy edge construction (the L_i tables of Algorithm 1, flattened)
# ---------------------------------------------------------------------------

def _core_on(problem, core) -> torch.Tensor:
    """Core numbers as an int32 tensor on the problem's device."""
    if not isinstance(core, torch.Tensor):
        core = torch.as_tensor(np.asarray(core))
    return core.to(device=problem.device, dtype=INT)


def _stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """``np.lexsort(keys)`` (last key primary) by stable sorts, key by key
    from the least significant."""
    idx = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        idx = idx[torch.argsort(k[idx], stable=True)]
    return idx


def hierarchy_edges(problem, core):
    """(u, v, w) r-clique adjacency edges with w = min(core_u, core_v).

    Emits C-1 consecutive edges per s-clique after an in-row stable sort
    by core descending (connectivity-equivalent to all C(C,2) pairs at
    every level).  The result is deduped and sorted by weight descending,
    then (lo, hi); int32 tensors on the problem's device.
    """
    inc = problem.inc_rid
    n_s, C = inc.shape
    if n_s == 0 or C < 2:
        z = torch.zeros((0,), dtype=INT, device=inc.device)
        return z, z, z
    cores = _core_on(problem, core)[inc.long()]  # (n_s, C)
    order = torch.argsort(-cores, dim=1, stable=True)
    rid_s = torch.gather(inc, 1, order)
    c_s = torch.gather(cores, 1, order)
    u = rid_s[:, :-1].reshape(-1)
    v = rid_s[:, 1:].reshape(-1)
    w = c_s[:, 1:].reshape(-1)
    lo = torch.minimum(u, v)
    hi = torch.maximum(u, v)
    # the reference's lexsort((hi, lo, -w)); lo, hi >= 0 pack into one key
    pair = (lo.to(torch.int64) << 32) | hi.to(torch.int64)
    order = _stable_order(pair, -w)
    lo, hi, w = lo[order], hi[order], w[order]
    dup = torch.zeros_like(lo, dtype=torch.bool)
    dup[1:] = (lo[1:] == lo[:-1]) & (hi[1:] == hi[:-1]) & (w[1:] == w[:-1])
    keep = ~dup
    return lo[keep], hi[keep], w[keep]


def emit_merges(t_old: np.ndarray, t_new: np.ndarray, wv: int,
                parent: np.ndarray, level: np.ndarray, node_of: np.ndarray,
                next_id: int) -> int:
    """Group old roots by new root; every group of >= 2 gets a new parent."""
    if t_old.shape[0] == 0:
        return next_id
    order = np.argsort(t_new, kind="stable")
    tn, to = t_new[order], t_old[order]
    uniq, counts = np.unique(tn, return_counts=True)
    merged = counts >= 2
    if not merged.any():
        return next_id
    n_new = int(merged.sum())
    ids = np.full(uniq.shape[0], -1, np.int64)
    ids[merged] = next_id + np.arange(n_new)
    inv = np.repeat(np.arange(uniq.shape[0]), counts)
    child_mask = merged[inv]
    children_nodes = node_of[to[child_mask]]
    parent[children_nodes] = ids[inv][child_mask]
    level[next_id:next_id + n_new] = int(wv)
    node_of[uniq[merged]] = ids[merged]
    return next_id + n_new


def build_hierarchy_levels(problem, core) -> HierarchyTree:
    """ANH-TE analog: one union-find forest swept over levels descending."""
    n_r = problem.n_r
    core_np = _core_on(problem, core).cpu().numpy()
    u, v, w = hierarchy_edges(problem, core)
    w_np = w.cpu().numpy()
    parent, level, node_of = new_tree_buffers(n_r, core_np)
    next_id = n_r
    comp = torch.arange(n_r, dtype=INT, device=problem.device)
    neg, starts = np.unique(-w_np, return_index=True)
    distinct = -neg  # descending levels; starts index the sorted edges
    bounds = list(starts) + [w_np.shape[0]]
    for gi, wv in enumerate(distinct):
        sl = slice(int(bounds[gi]), int(bounds[gi + 1]))
        uu, vv = u[sl], v[sl]
        old = pointer_jump(comp)
        new = connected_components(n_r, uu, vv, init=old)
        touched = np.unique(old[torch.cat([uu, vv]).long()].cpu().numpy())
        t_new = new.cpu().numpy()[touched]
        next_id = emit_merges(touched, t_new, int(wv), parent, level,
                              node_of, next_id)
        comp = new
    return finish_tree(n_r, parent, level, next_id)


def build_hierarchy_basic(problem, core) -> HierarchyTree:
    """ANH-BL analog: connectivity re-run from scratch per level (k passes).

    Deliberately work-inefficient (the paper's LINK-BASIC baseline): level
    i re-unions every edge of weight >= i instead of reusing the forest.
    """
    n_r = problem.n_r
    core_np = _core_on(problem, core).cpu().numpy()
    u, v, w = hierarchy_edges(problem, core)
    w_np = w.cpu().numpy()
    parent, level, node_of = new_tree_buffers(n_r, core_np)
    next_id = n_r
    prev = np.arange(n_r, dtype=np.int64)
    for wv in np.unique(w_np)[::-1]:
        sel = w >= int(wv)  # every qualifying edge, from scratch
        new_np = connected_components(n_r, u[sel], v[sel]).cpu().numpy()
        prev_roots = np.unique(prev)
        next_id = emit_merges(prev_roots, new_np[prev_roots], int(wv),
                              parent, level, node_of, next_id)
        prev = new_np
    return finish_tree(n_r, parent, level, next_id)
