"""Nuclei extraction for the Fig. 10 queries (counterpart of
``repro.core.nuclei``).

``cut_hierarchy`` extracts every c-(r,s) nucleus from a built hierarchy
tree by one upward sweep (cheap); ``nuclei_without_hierarchy`` answers the
same query from core numbers alone by running connectivity over the
qualifying r-cliques on the problem's device (the expensive comparison
baseline).  Vertex sets, densities and canonical labels are host numpy
code with the reference's results; the vertex sets and densities of all
nuclei come from one sort each (the reference loops over the nuclei).
"""
from __future__ import annotations

from typing import Dict, List

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


def grouped_vertex_sets(r_cliques: np.ndarray, labels: np.ndarray):
    """The nuclei's vertex sets laid end to end: ``(labs, starts, verts)``
    with ``labs`` the labels ascending and ``verts[starts[i]:starts[i+1]]``
    the sorted unique vertex ids of nucleus ``labs[i]``.  One sort over
    every (label, vertex) pair, so the cost does not grow with the number
    of nuclei."""
    rc = np.asarray(r_cliques)
    labels = np.asarray(labels)
    rids = np.nonzero(labels >= 0)[0]
    if rids.shape[0] == 0:
        empty = np.zeros((0,), np.int64)
        return empty, empty, rc.reshape(-1)[:0]
    rows = rc[rids]                                       # (k, r)
    lab = np.repeat(labels[rids], rows.shape[1])
    verts = rows.reshape(-1)
    order = np.lexsort((verts, lab))
    lab, verts = lab[order], verts[order]
    keep = np.ones((lab.shape[0],), bool)
    keep[1:] = (lab[1:] != lab[:-1]) | (verts[1:] != verts[:-1])
    lab, verts = lab[keep], verts[keep]
    labs, starts = np.unique(lab, return_index=True)
    return labs, starts, verts


def nucleus_vertex_sets(r_cliques: np.ndarray, labels: np.ndarray
                        ) -> Dict[int, np.ndarray]:
    """Expand nucleus labels over r-cliques into vertex sets per nucleus:
    {label: sorted unique vertex ids}.  ``r_cliques`` is the (n_r, r)
    r-clique table."""
    labs, starts, verts = grouped_vertex_sets(r_cliques, labels)
    return dict(zip(labs.tolist(), split_groups(verts, starts)))


def split_groups(verts: np.ndarray, starts: np.ndarray) -> List[np.ndarray]:
    """``verts`` cut at ``starts`` into views (``np.split`` costs a few
    microseconds a piece)."""
    ends = starts[1:].tolist() + [verts.shape[0]]
    return [verts[a:b] for a, b in zip(starts.tolist(), ends)]


def grouped_densities(g_edges: np.ndarray, sizes: np.ndarray,
                      verts: np.ndarray) -> np.ndarray:
    """``edge_density`` of vertex sets laid end to end (set i holds the
    next ``sizes[i]`` entries of ``verts``), for all sets at once.

    One pass over the edges for all sets together (the reference calls
    ``edge_density`` per nucleus, an O(|E|) scan each): every edge is
    expanded over the sets holding its endpoint in fewer sets, and (set,
    other endpoint) is looked up in the sorted (set, vertex) keys.  Same
    values as ``edge_density``.
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    out = np.zeros((sizes.shape[0],), np.float64)
    e = np.asarray(g_edges, dtype=np.int64).reshape(-1, 2)
    verts = np.asarray(verts, dtype=np.int64)
    if sizes.size == 0 or e.shape[0] == 0 or verts.size == 0:
        return out
    slot = np.repeat(np.arange(sizes.size, dtype=np.int64), sizes)
    n_v = int(max(verts.max(), e.max())) + 1
    keys = np.sort(slot * n_v + verts)          # (set slot, vertex), sorted
    by_vertex = np.argsort(verts, kind="stable")
    # the sets holding vertex x are by_vertex[first[x]:first[x + 1]]
    first = np.zeros((n_v + 1,), np.int64)
    np.cumsum(np.bincount(verts, minlength=n_v), out=first[1:])
    held = first[1:] - first[:-1]
    # each edge from the endpoint held by fewer sets
    swap = held[e[:, 0]] > held[e[:, 1]]
    a = np.where(swap, e[:, 1], e[:, 0])
    b = np.where(swap, e[:, 0], e[:, 1])
    cnt = held[a]
    eidx = np.repeat(np.arange(e.shape[0], dtype=np.int64), cnt)
    pos = np.arange(eidx.size, dtype=np.int64) - \
        np.repeat(np.cumsum(cnt) - cnt, cnt) + np.repeat(first[a], cnt)
    # the (set, other endpoint) queries, sorted so that the lookups in
    # the sorted keys walk forward through them
    q = np.sort(slot[by_vertex[pos]] * n_v + b[eidx])
    at = np.clip(np.searchsorted(keys, q), 0, keys.size - 1)
    inside = np.bincount(q[keys[at] == q] // n_v, minlength=sizes.size)
    pairs = sizes >= 2
    out[pairs] = inside[pairs] / (sizes[pairs] * (sizes[pairs] - 1) / 2)
    return out


def edge_densities(g_edges: np.ndarray, sets: Dict[int, np.ndarray]
                   ) -> Dict[int, float]:
    """``edge_density`` of every vertex set at once
    (``grouped_densities`` over the sets in key order)."""
    labs = [int(lab) for lab in sets]
    arrays = [np.asarray(sets[lab]) for lab in labs]
    sizes = np.asarray([a.shape[0] for a in arrays], dtype=np.int64)
    verts = np.concatenate(arrays) if arrays else np.zeros((0,), np.int64)
    return dict(zip(labs, grouped_densities(g_edges, sizes, verts)
                    .tolist()))


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
