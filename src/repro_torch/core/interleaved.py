"""ANH-EL tree post-pass (counterpart of ``repro.core.interleaved``).

The engine's fused LINK fixpoint returns the join forest (resolved
``parent`` + nearest-lower-core table ``L``); ``link_state_from_forest``
adapts it to a ``LinkState`` and ``construct_tree_efficient`` (Alg. 5,
lines 28-36) turns that into a ``HierarchyTree``.  Host numpy code, copied
from the reference; the host trace replay is not ported in this slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .hierarchy import HierarchyTree


def _resolve(parent: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Vectorized find: chase parent pointers to roots."""
    x = x.copy()
    while True:
        p = parent[x]
        if (p == x).all():
            return x
        x = p


@dataclasses.dataclass
class LinkState:
    """The two arrays of LINK-EFFICIENT: uf parents + nearest-core table L."""

    parent: np.ndarray  # (n_r,) int64 — same-core union-find
    L: np.ndarray       # (n_r,) int64 — nearest lower core per root, -1 empty
    core: np.ndarray    # (n_r,) int64 — peel values of the peeled cliques


def link_state_from_forest(peel_value, uf_parent, uf_L) -> LinkState:
    """Adapt the engine's join forest (parent resolved, L) plus the raw
    peel values to the ``LinkState`` the tree post-pass consumes."""
    return LinkState(parent=np.asarray(uf_parent).astype(np.int64),
                     L=np.asarray(uf_L).astype(np.int64),
                     core=np.asarray(peel_value).astype(np.int64))


def construct_tree_efficient(problem, state: LinkState) -> HierarchyTree:
    """CONSTRUCT-TREE-EFFICIENT (Alg. 5, Lines 28–36), fully batched.

    ``problem`` is anything with an ``n_r`` attribute.
    """
    n_r = problem.n_r
    parent_uf = _resolve(state.parent, np.arange(n_r, dtype=np.int64))
    core = state.core
    cap = 2 * max(n_r, 1)
    parent = np.full(cap, -1, np.int64)
    level = np.zeros(cap, np.int64)
    level[:n_r] = core
    next_id = n_r
    # one internal node per multi-member uf component
    roots, counts = np.unique(parent_uf, return_counts=True)
    multi = counts >= 2
    node_of = np.arange(n_r, dtype=np.int64)  # root -> representing tree node
    n_new = int(multi.sum())
    ids = next_id + np.arange(n_new)
    node_of[roots[multi]] = ids
    level[ids] = core[roots[multi]]
    # leaves of multi components point at their component node
    comp_node = node_of[parent_uf]
    is_multi_leaf = comp_node != np.arange(n_r)
    parent[:n_r][is_multi_leaf] = comp_node[is_multi_leaf]
    next_id += n_new
    # hook each component to its nearest enclosing core via L
    lvals = state.L[roots]
    has = lvals >= 0
    tgt_roots = _resolve(state.parent, lvals[has])
    parent[node_of[roots[has]]] = node_of[tgt_roots]
    return HierarchyTree(n_leaves=n_r, parent=parent[:next_id].copy(),
                         level=level[:next_id].copy())
