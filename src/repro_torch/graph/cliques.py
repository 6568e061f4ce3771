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

import dataclasses
from itertools import combinations
from typing import Dict, List, Optional

import torch

from .container import Digraph, Graph, INT, PAD, orient
from .orientation import degree_rank

# candidate entries processed per row block of the batched intersection
_BLOCK_ELEMS = 1 << 26


def _intersect_rows(cand: torch.Tensor, w: torch.Tensor, adj: torch.Tensor,
                    outdeg: torch.Tensor):
    """Row-wise cand[i] := cand[i] & adj[w[i]]; rows stay sorted/PAD-padded.

    The reference's jnp version also takes the candidate counts, which it
    does not read (the search is bounded by ``outdeg[w]``); this signature
    is its numpy twin's, ``_intersect_rows_np``, and so is the third
    return value: the bytes of the transients this call held (gathered
    adjacency rows, int64 positions, the hit-masked rows).
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
    work = rows.numel() * 4 + pos.numel() * 8 + 2 * kept.numel() * 4
    return kept, nkept, work


def _next_candidates(cand: torch.Tensor, rep: torch.Tensor, c: torch.Tensor,
                     adj: torch.Tensor, outdeg: torch.Tensor):
    """``_intersect_rows(cand[rep], c, adj, outdeg)`` in row blocks, each
    block cut to its widest row and the result padded to the global widest
    row (never wider than the reference's, never losing a candidate).
    Also returns the largest block's transient bytes."""
    total = int(rep.shape[0])
    width = max(int(cand.shape[1]), 1)
    step = max(1, _BLOCK_ELEMS // width)
    parts: List[torch.Tensor] = []
    counts: List[torch.Tensor] = []
    wmax = 0
    work = 0
    for b0 in range(0, total, step):
        r = rep[b0:b0 + step]
        kept, nkept, w = _intersect_rows(cand[r], c[b0:b0 + step], adj,
                                         outdeg)
        work = max(work, w + kept.numel() * 4)
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
    return out, ncand, work


def _pairs(cand: torch.Tensor, ncand: torch.Tensor):
    """Every (row, candidate) pair of a level, row-major: (rep, c, total),
    or None when the level has no candidate (rows with none repeat zero
    times; the reference drops them first, and the surviving order is
    the same)."""
    total = int(ncand.sum(dtype=torch.int64)) if ncand.numel() else 0
    if total == 0:
        return None
    dev = cand.device
    counts = ncand.long()
    rep = torch.repeat_interleave(
        torch.arange(int(ncand.shape[0]), device=dev), counts,
        output_size=total)
    pos = torch.arange(total, device=dev) - \
        (torch.cumsum(counts, 0) - counts)[rep]
    return rep, cand[rep, pos], total


def expand_levels(dg: Digraph, seeds: torch.Tensor,
                  ks) -> Dict[int, torch.Tensor]:
    """Level-synchronous expansion from the level-1 `seeds` vertices.

    Returns ``{t: (N_t, t) rows for t in ks}`` with rows of ascending vertex
    ids, row for row equal to the reference's first return value.  Because
    the DAG orientation gives every clique a unique discovery path,
    expansions from disjoint seed ranges are duplicate-free and their
    outputs, concatenated in seed order, are the all-vertices expansion
    row for row: the chunked build's invariant.  (The reference also
    returns a peak-memory estimate; ``iter_clique_chunks`` yields the
    port's own.)
    """
    return expand_levels_metered(dg, seeds, ks)[0]


def expand_levels_metered(dg: Digraph, seeds: torch.Tensor, ks):
    """``expand_levels`` plus the port's account of its peak device bytes:
    the largest level's vertex rows (gathered, then concatenated), its
    repeat/position index tensors, the next candidate tensor and one row
    block of the intersection's transients."""
    ks = sorted(set(int(k) for k in ks))
    kmax = ks[-1]
    dev = dg.adj.device
    out: Dict[int, torch.Tensor] = {}
    verts = seeds.to(INT)[:, None]
    if int(seeds.shape[0]) == dg.n:  # full frontier: no gather copy needed
        cand, ncand = dg.adj, dg.outdeg
    else:
        cand, ncand = dg.adj[seeds.long()], dg.outdeg[seeds.long()]
    peak = (verts.numel() + cand.numel() + ncand.numel()) * 4
    if 1 in ks:
        out[1] = verts

    for t in range(2, kmax + 1):
        pairs = _pairs(cand, ncand)
        if pairs is None:
            for kk in ks:
                # nucleuslint: disable=NL102 (host ints, additive taint)
                if kk >= t:
                    out[kk] = torch.zeros((0, kk), dtype=INT, device=dev)
            return out, peak
        rep, c, total = pairs
        verts = torch.cat([verts[rep], c[:, None]], dim=1)
        # nucleuslint: disable=NL102 (host ints, additive taint)
        if t in ks:
            out[t] = torch.sort(verts, dim=1).values
        work = 0
        # nucleuslint: disable=NL102 (host ints, additive taint)
        if t < kmax:
            cand, ncand, work = _next_candidates(cand, rep, c, dg.adj,
                                                 dg.outdeg)
            work += (cand.numel() + ncand.numel()) * 4
        # verts (gathered + concatenated), rep/pos int64, c int32
        peak = max(peak, 2 * verts.numel() * 4 + total * 20 + work)
        del rep, c, pairs
    return out, peak


@dataclasses.dataclass
class CliqueLevels:
    """t-cliques for the levels requested; rows are ascending vertex ids."""

    levels: Dict[int, torch.Tensor]

    def count(self, t: int) -> int:
        return int(self.levels[t].shape[0])


def list_cliques(g: Graph, ks, rank: Optional[torch.Tensor] = None,
                 dg: Optional[Digraph] = None) -> CliqueLevels:
    """List all t-cliques for each t in `ks` (max(ks) drives the expansion),
    on `g`'s device.  Without `dg` the graph is oriented by `rank`, else by
    ``degree_rank``, the reference's default."""
    if dg is None:
        dg = orient(g, degree_rank(g) if rank is None else rank)
    return CliqueLevels(expand_levels(
        dg, torch.arange(g.n, dtype=INT, device=g.device), ks))


def iter_clique_chunks(dg: Digraph, ks, chunk_size: int, *,
                       start: int = 0, stop: Optional[int] = None):
    """Chunked clique listing: expand `chunk_size` source vertices at a time.

    Yields ``(start, levels, peak_bytes)`` per contiguous seed range, with
    levels as tensors on the digraph's device and ``peak_bytes`` the port's
    account of that chunk's expansion (``expand_levels_metered``).
    Concatenating each level over chunks in yield order is row-identical to
    ``list_cliques``; peak live memory is one chunk's expansion instead of
    the whole graph's.

    ``start``/``stop`` restrict the walk to the seed range [start, stop), a
    shard of the level-1 frontier.  Chunk boundaries are anchored at
    ``start``, so a sharded build whose shard boundaries fall on chunk
    boundaries (``repro_torch.distbuild``) yields exactly the chunks the
    whole-frontier walk gives for that range.
    """
    chunk_size = max(1, int(chunk_size))
    stop = dg.n if stop is None else min(int(stop), dg.n)
    dev = dg.adj.device
    for s0 in range(int(start), stop, chunk_size):
        seeds = torch.arange(s0, min(s0 + chunk_size, stop), dtype=INT,
                             device=dev)
        levels, peak = expand_levels_metered(dg, seeds, ks)
        yield s0, levels, peak


def count_cliques(g: Graph, k: int,
                  rank: Optional[torch.Tensor] = None) -> int:
    """Count k-cliques on the `rank` orientation (None: the degree
    orientation); the last level's rows are never materialized."""
    if k == 1:
        return g.n
    if k == 2:
        return g.m
    dg = orient(g, degree_rank(g) if rank is None else rank)
    cand, ncand = dg.adj, dg.outdeg
    for _ in range(2, k):
        pairs = _pairs(cand, ncand)
        if pairs is None:
            return 0
        rep, c, _ = pairs
        cand, ncand, _ = _next_candidates(cand, rep, c, dg.adj, dg.outdeg)
    return int(ncand.sum(dtype=torch.int64))


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


def unique_rows(rows: torch.Tensor):
    """(unique_sorted_rows, inverse_ids), as the reference's."""
    if rows.shape[0] == 0:
        return rows, torch.zeros((0,), dtype=INT, device=rows.device)
    order = lexsort_rows(rows)
    srows = rows[order]
    first = torch.ones((int(rows.shape[0]),), dtype=torch.bool,
                       device=rows.device)
    first[1:] = (srows[1:] != srows[:-1]).any(dim=1)
    ids_sorted = (torch.cumsum(first, 0) - 1).to(INT)
    inverse = torch.empty_like(ids_sorted)
    inverse[order] = ids_sorted
    return srows[first], inverse


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
