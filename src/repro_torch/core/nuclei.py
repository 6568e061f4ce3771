"""Nuclei extraction for the Fig. 10 queries (counterpart of
``repro.core.nuclei``).

``cut_hierarchy`` extracts every c-(r,s) nucleus from a built hierarchy
tree by one upward sweep (cheap); ``nuclei_without_hierarchy`` answers the
same query from core numbers alone by running connectivity over the
qualifying r-cliques on the problem's device (the expensive comparison
baseline).  Vertex sets, densities and canonical labels are host numpy
code, copied from the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..graph.connectivity import connected_components
from .hierarchy import HierarchyTree, hierarchy_edges


def cut_hierarchy(tree: HierarchyTree, c: int) -> np.ndarray:
    """Label each leaf (r-clique) with its c-(r,s) nucleus id; -1 if
    core < c.

    Removing all internal nodes of level < c makes each surviving subtree
    one c-nucleus; the subtree root id is the label.
    """
    return tree.ancestor_at_level(c)


def nuclei_without_hierarchy(problem, core, c: int) -> np.ndarray:
    """The no-hierarchy baseline: connectivity over r-cliques with
    core >= c."""
    u, v, w = hierarchy_edges(problem, core)
    sel = w >= c
    labels = connected_components(problem.n_r, u[sel], v[sel])
    out = labels.cpu().numpy().astype(np.int64)
    core_np = core.cpu().numpy() if isinstance(core, torch.Tensor) \
        else np.asarray(core)
    out[core_np < c] = -1
    return out


def nucleus_vertex_sets(r_cliques: np.ndarray, labels: np.ndarray
                        ) -> Dict[int, np.ndarray]:
    """Expand nucleus labels over r-cliques into vertex sets per nucleus:
    {label: sorted unique vertex ids}.  ``r_cliques`` is the (n_r, r)
    r-clique table."""
    rc = np.asarray(r_cliques)
    labels = np.asarray(labels)
    rids = np.nonzero(labels >= 0)[0]
    if rids.shape[0] == 0:
        return {}
    order = np.argsort(labels[rids], kind="stable")
    rids = rids[order]
    labs = labels[rids]
    uniq, starts = np.unique(labs, return_index=True)
    groups = np.split(rids, starts[1:])
    return {int(lab): np.unique(rc[g].reshape(-1))
            for lab, g in zip(uniq, groups)}


def edge_densities(g_edges: np.ndarray, sets: Dict[int, np.ndarray]
                   ) -> Dict[int, float]:
    """``edge_density`` of every vertex set at once.

    One pass over the edges for all sets together (the reference calls
    ``edge_density`` per nucleus, an O(|E|) scan each): every edge (u, v)
    is expanded over the sets holding u, and (set, v) is looked up in the
    sorted (set, vertex) keys.  Same values as ``edge_density``.
    """
    labs = np.asarray(list(sets), dtype=np.int64)
    out = {int(lab): 0.0 for lab in labs}
    e = np.asarray(g_edges, dtype=np.int64).reshape(-1, 2)
    if labs.size == 0 or e.shape[0] == 0:
        return out
    sizes = np.asarray([np.asarray(sets[int(lab)]).shape[0] for lab in labs],
                       dtype=np.int64)
    verts = np.concatenate([np.asarray(sets[int(lab)], dtype=np.int64)
                            for lab in labs])
    if verts.size == 0:
        return out
    slot = np.repeat(np.arange(labs.size, dtype=np.int64), sizes)
    n_v = int(max(verts.max(), e.max())) + 1
    keys = np.sort(slot * n_v + verts)          # (set slot, vertex), sorted
    by_vertex = np.argsort(verts, kind="stable")
    v_sorted = verts[by_vertex]
    # sets holding each edge's u endpoint
    lo = np.searchsorted(v_sorted, e[:, 0], side="left")
    hi = np.searchsorted(v_sorted, e[:, 0], side="right")
    cnt = hi - lo
    eidx = np.repeat(np.arange(e.shape[0], dtype=np.int64), cnt)
    pos = np.arange(eidx.size, dtype=np.int64) - \
        np.repeat(np.cumsum(cnt) - cnt, cnt) + np.repeat(lo, cnt)
    s_of = slot[by_vertex[pos]]
    q = s_of * n_v + e[eidx, 1]
    at = np.clip(np.searchsorted(keys, q), 0, keys.size - 1)
    inside = np.bincount(s_of[keys[at] == q], minlength=labs.size)
    for i, lab in enumerate(labs):
        k = int(sizes[i])
        if k >= 2:
            out[int(lab)] = int(inside[i]) / (k * (k - 1) / 2)
    return out


def edge_density(g_edges: np.ndarray, vertices: np.ndarray) -> float:
    """|E(S)| / C(|S|, 2) — the paper's subgraph quality metric (Fig. 10)."""
    return edge_densities(g_edges, {0: np.asarray(vertices)})[0]


def canonicalize_labels(labels: np.ndarray) -> np.ndarray:
    """Canonical partition form: each label -> rank of its first occurrence.

    Negative labels (outside every nucleus) are preserved as -1; the golden
    fixtures store this form.
    """
    labels = np.asarray(labels)
    out = np.full(labels.shape[0], -1, np.int64)
    sel = labels >= 0
    x = labels[sel]
    if x.shape[0]:
        _, first, inv = np.unique(x, return_index=True, return_inverse=True)
        rank = np.argsort(np.argsort(first))  # unique-label -> occurrence rank
        out[sel] = rank[inv]
    return out


def same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """Do two labelings induce the same partition (ignoring label names)?"""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        return False
    if ((a < 0) != (b < 0)).any():
        return False
    return bool((canonicalize_labels(a) == canonicalize_labels(b)).all())
