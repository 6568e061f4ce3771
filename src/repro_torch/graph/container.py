"""Graph container: canonical edge tensors + CSR views built with sorts.

Counterpart of ``repro.graph.container``.  A ``Graph`` holds the canonical
undirected edge list (u < v, lexicographically sorted, unique) as an
``(m, 2)`` int32 tensor on one device; a ``Digraph`` is its orientation into
a DAG with a CSR and a PAD-padded ``(n, dmax)`` adjacency whose rows are
sorted, so batched ``searchsorted`` membership tests are valid on every row.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, same_device

INT = torch.int32
# Sentinel used to pad adjacency rows; must compare greater than any vertex id.
PAD = int(np.iinfo(np.int32).max)


def _pair_key(hi_major: torch.Tensor, lo_minor: torch.Tensor) -> torch.Tensor:
    """int64 key ordering pairs like ``lexsort((minor, major))`` (ids >= 0)."""
    return (hi_major.to(torch.int64) << 32) | lo_minor.to(torch.int64)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Simple undirected graph.

    Attributes:
      n: number of vertices.
      edges: (m, 2) int32, canonical (u < v), lexicographically sorted, unique.
    """

    n: int
    edges: torch.Tensor  # (m, 2) int32

    @property
    def m(self) -> int:
        return int(self.edges.shape[0])

    @property
    def device(self) -> torch.device:
        return self.edges.device

    def to(self, device: torch.device) -> "Graph":
        if same_device(self.edges.device, device):
            return self
        return Graph(n=self.n, edges=self.edges.to(device))

    def degrees(self) -> torch.Tensor:
        deg = torch.zeros((self.n,), dtype=INT, device=self.device)
        ones = torch.ones((self.m,), dtype=INT, device=self.device)
        deg.index_add_(0, self.edges[:, 0].long(), ones)
        deg.index_add_(0, self.edges[:, 1].long(), ones)
        return deg


def make_graph(n: int, edges, device: DeviceLike = None) -> Graph:
    """Canonicalize an edge list: undirected, dedup, drop self-loops."""
    dev = resolve_device(device)
    if isinstance(edges, torch.Tensor):
        e = edges.to(device=dev, dtype=INT).reshape(-1, 2)
    else:
        e = torch.as_tensor(np.asarray(edges, dtype=np.int64).reshape(-1, 2),
                            dtype=INT, device=dev)
    if e.shape[0]:
        lo = torch.minimum(e[:, 0], e[:, 1])
        hi = torch.maximum(e[:, 0], e[:, 1])
        keep = lo != hi
        lo, hi = lo[keep], hi[keep]
        # one int64 key sorts like lexsort((hi, lo)); equal keys are equal
        # rows, so stability cannot matter here
        key = torch.unique(_pair_key(lo, hi))  # sorted, deduplicated
        e = torch.stack([(key >> 32).to(INT), (key & 0xFFFFFFFF).to(INT)],
                        dim=1)
    return Graph(n=int(n), edges=e.contiguous())


@dataclasses.dataclass(frozen=True)
class Digraph:
    """Oriented graph (DAG under a total order), CSR + padded adjacency.

    adj is (n, dmax) int32 with rows sorted ascending and padded with PAD so
    that batched ``searchsorted`` membership tests are valid on every row.
    """

    n: int
    offsets: torch.Tensor    # (n + 1,) int32
    neighbors: torch.Tensor  # (m,) int32 sorted within each row
    adj: torch.Tensor        # (n, dmax) int32, PAD-padded
    outdeg: torch.Tensor     # (n,) int32

    @property
    def dmax(self) -> int:
        return int(self.adj.shape[1])


def orient_arcs(g: Graph, rank: torch.Tensor):
    """(src, dst): each edge directed from lower to higher (rank, id)."""
    u, v = g.edges[:, 0], g.edges[:, 1]
    ru, rv = rank[u.long()], rank[v.long()]
    forward = (ru < rv) | ((ru == rv) & (u < v))
    return torch.where(forward, u, v), torch.where(forward, v, u)


def orient(g: Graph, rank: torch.Tensor) -> Digraph:
    """Direct each edge from lower to higher `rank` (ties by vertex id).

    `rank` is a total-order key; with a degeneracy-like order the resulting
    out-degree is O(alpha) which bounds the clique-extension candidate sets.
    """
    src, dst = orient_arcs(g, rank)
    return _build_digraph(g.n, src, dst)


def _build_digraph(n: int, src: torch.Tensor, dst: torch.Tensor) -> Digraph:
    dev = src.device
    m = int(src.shape[0])
    # Sort by (src, dst) so each row's neighbor list is ascending; arcs are
    # unique, so the int64 key has no ties.
    order = torch.argsort(_pair_key(src, dst))
    src_s, dst_s = src[order], dst[order]
    outdeg = torch.bincount(src_s.long(), minlength=n).to(INT)
    offsets = torch.zeros((n + 1,), dtype=INT, device=dev)
    offsets[1:] = torch.cumsum(outdeg, 0).to(INT)
    dmax = int(outdeg.max()) if m else 1
    dmax = max(dmax, 1)
    # Scatter neighbors into a padded (n, dmax) matrix.
    pos_in_row = torch.arange(m, dtype=torch.int64, device=dev) - \
        offsets[src_s.long()].long()
    adj = torch.full((n, dmax), PAD, dtype=INT, device=dev)
    adj[src_s.long(), pos_in_row] = dst_s
    return Digraph(n=n, offsets=offsets, neighbors=dst_s.contiguous(),
                   adj=adj, outdeg=outdeg)


def csr_from_pairs(keys: torch.Tensor, vals: torch.Tensor, n_keys: int):
    """Build a CSR (offsets, vals grouped by key) from (key, val) pairs."""
    order = torch.argsort(keys, stable=True)
    v = vals[order]
    counts = torch.bincount(keys.long(), minlength=n_keys).to(INT) \
        if int(keys.shape[0]) else \
        torch.zeros((n_keys,), dtype=INT, device=keys.device)
    offsets = torch.zeros((n_keys + 1,), dtype=INT, device=keys.device)
    offsets[1:] = torch.cumsum(counts, 0).to(INT)
    return offsets, v
