"""Level-synchronous k-clique listing over a low-out-degree orientation.

Counterpart of ``repro.graph.cliques``.  Level t holds all t-cliques as a
flat (N_t, t) tensor plus each clique's candidate set (the intersection of
its members' out-neighborhoods) as a padded, row-sorted (N_t, w) tensor.
Extension is one batched ``searchsorted`` plus a row sort.  Each clique is
produced exactly once, in the reference's order, because the DAG
orientation gives every clique a unique discovery path.

Row-wise work is done in row blocks of at most ``_BLOCK_ELEMS`` candidate
entries, and each level's candidate tensor is cut to the widest surviving
row: both are exact (rows are independent, and columns past a row's count
hold only PAD), and they keep the eager build's memory near the size of its
output on graphs with millions of edges.
"""
from __future__ import annotations

from itertools import combinations
from typing import Dict, List

import torch

from .container import Digraph, INT, PAD

# candidate entries processed per row block of the batched intersection
_BLOCK_ELEMS = 1 << 26


def _intersect_rows(cand: torch.Tensor, w: torch.Tensor, adj: torch.Tensor,
                    outdeg: torch.Tensor):
    """Row-wise cand[i] := cand[i] & adj[w[i]]; rows stay sorted/PAD-padded.

    The reference's jnp version also takes the candidate counts, which it
    does not read (the search is bounded by ``outdeg[w]``); this signature
    is its numpy twin's, ``_intersect_rows_np``.
    """
    rows = adj[w.long()]
    wl = rows.shape[1]
    pos = torch.searchsorted(rows, cand)
    pos = torch.clamp(pos, 0, wl - 1)
    hit = (torch.gather(rows, 1, pos) == cand) & \
        (pos < outdeg[w.long()][:, None]) & (cand != PAD)
    kept = torch.where(hit, cand, torch.full_like(cand, PAD))
    kept = torch.sort(kept, dim=1).values  # PADs (int32 max) move to the tail
    nkept = (kept != PAD).sum(dim=1, dtype=torch.int32)
    return kept, nkept


def _next_candidates(cand: torch.Tensor, rep: torch.Tensor, c: torch.Tensor,
                     adj: torch.Tensor, outdeg: torch.Tensor):
    """``_intersect_rows(cand[rep], c, adj, outdeg)`` in row blocks, each
    block cut to its widest row and the result padded to the global widest
    row (never wider than the reference's, never losing a candidate)."""
    total = int(rep.shape[0])
    width = max(int(cand.shape[1]), 1)
    step = max(1, _BLOCK_ELEMS // width)
    parts: List[torch.Tensor] = []
    counts: List[torch.Tensor] = []
    wmax = 0
    for b0 in range(0, total, step):
        r = rep[b0:b0 + step]
        kept, nkept = _intersect_rows(cand[r], c[b0:b0 + step], adj, outdeg)
        wb = int(nkept.max()) if nkept.numel() else 0
        parts.append(kept[:, :wb])
        counts.append(nkept)
        wmax = max(wmax, wb)
    wmax = max(wmax, 1)
    out = torch.full((total, wmax), PAD, dtype=INT, device=cand.device)
    at = 0
    for p in parts:
        out[at:at + p.shape[0], :p.shape[1]] = p
        at += p.shape[0]
    ncand = torch.cat(counts) if counts else \
        torch.zeros((0,), dtype=INT, device=cand.device)
    return out, ncand


def expand_levels(dg: Digraph, seeds: torch.Tensor,
                  ks) -> Dict[int, torch.Tensor]:
    """Level-synchronous expansion from the level-1 `seeds` vertices.

    Returns ``{t: (N_t, t) rows for t in ks}`` with rows of ascending vertex
    ids, row for row equal to the reference's first return value.  (The
    reference also returns a peak-memory estimate for its chunked builder,
    which this slice does not port.)
    """
    ks = sorted(set(int(k) for k in ks))
    kmax = ks[-1]
    dev = dg.adj.device
    out: Dict[int, torch.Tensor] = {}
    verts = seeds.to(INT)[:, None]
    if int(seeds.shape[0]) == dg.n:  # full frontier: no gather copy needed
        cand, ncand = dg.adj, dg.outdeg
    else:
        cand, ncand = dg.adj[seeds.long()], dg.outdeg[seeds.long()]
    if 1 in ks:
        out[1] = verts

    for t in range(2, kmax + 1):
        # rows with no candidate simply repeat zero times (the reference
        # drops them first; the surviving order is the same)
        total = int(ncand.sum(dtype=torch.int64)) if ncand.numel() else 0
        if total == 0:
            for kk in ks:
                if kk >= t:
                    out[kk] = torch.zeros((0, kk), dtype=INT, device=dev)
            return out
        counts = ncand.long()
        rep = torch.repeat_interleave(
            torch.arange(verts.shape[0], device=dev), counts,
            output_size=total)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(total, device=dev) - starts[rep]
        c = cand[rep, pos]
        verts = torch.cat([verts[rep], c[:, None]], dim=1)
        if t in ks:
            out[t] = torch.sort(verts, dim=1).values
        if t < kmax:
            cand, ncand = _next_candidates(cand, rep, c, dg.adj, dg.outdeg)
        del rep, pos, c
    return out


def lexsort_rows(rows: torch.Tensor) -> torch.Tensor:
    """Order that sorts rows lexicographically (column 0 most significant).

    A chain of stable sorts from the least significant column reproduces
    ``jnp.lexsort`` exactly, ties included.
    """
    return _lexsort_keys(tuple(rows[:, c]
                               for c in reversed(range(rows.shape[1]))))


def _lexsort_keys(keys) -> torch.Tensor:
    """``jnp.lexsort(keys)``: the last key is the primary one, all stable."""
    order = torch.arange(int(keys[0].shape[0]), device=keys[0].device)
    for key in keys:
        order = order[torch.argsort(key[order], stable=True)]
    return order


def sort_join(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Map each query row to its index in `table` (-1 when absent).

    `table` must be lexicographically sorted unique rows (ids = positions).
    One lexsort + forward cummax, as in the reference.
    """
    T, Q = int(table.shape[0]), int(queries.shape[0])
    dev = queries.device
    if Q == 0:
        return torch.zeros((0,), dtype=INT, device=dev)
    if T == 0:
        return torch.full((Q,), -1, dtype=INT, device=dev)
    comb = torch.cat([table, queries], dim=0)
    flag = torch.cat([torch.zeros((T,), dtype=INT, device=dev),
                      torch.ones((Q,), dtype=INT, device=dev)])
    keys = (flag,) + tuple(comb[:, c] for c in reversed(range(comb.shape[1])))
    order = _lexsort_keys(keys)
    ids_sorted = torch.where(order < T, order, torch.full_like(order, -1))
    filled = torch.cummax(ids_sorted, dim=0).values
    # validate that the fill actually matches (guards absent queries)
    matched_rows = table[torch.clamp(filled, 0, T - 1)]
    ok = (filled >= 0) & (matched_rows == comb[order]).all(dim=1)
    ids_sorted = torch.where(ok, filled, torch.full_like(filled, -1)).to(INT)
    inv = torch.empty_like(order)  # comb index -> sorted position
    inv[order] = torch.arange(order.shape[0], device=dev)
    return ids_sorted[inv[T:]]


def subset_columns(s: int, r: int):
    """All C(s, r) sorted column-index subsets (static python)."""
    return list(combinations(range(s), r))
