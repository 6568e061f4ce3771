"""Cross-shard count-then-fill exchange for the membership CSR
(counterpart of ``repro.distbuild.exchange``).

The membership CSR (r-clique id -> incident s-clique ids) is the one
structure whose rows mix contributions from every shard.  The exchange
moves only (n_r,)-sized count vectors:

  pass 1 (count / all-reduce)
      each shard bincounts the r-ids of its own ``inc`` slab; the sum of
      the per-shard vectors is ``deg0`` and its cumsum ``mem_offsets``, so
      shard k's contribution to r-clique ``rid`` starts at

          base_k[rid] = mem_offsets[rid] + sum_{j<k} counts_j[rid]

  pass 2 (fill, no communication)
      shard k writes its slab's s-ids into the disjoint cursor ranges
      ``[base_k, base_k + counts_k)`` with a stable-argsort cursor fill;
      slabs are ascending global s-id ranges, so each r-clique's run is
      ``csr_from_pairs``' stable grouping and ``mem_sids`` is bit-identical
      to the eager builder's.

Everything runs on the device of ``inc``.  ``exchange_bytes`` charges the
count all-reduce (each shard contributes one (n_r,) int64 vector); the
caller adds the r-table broadcast.  The chunked builder runs the same two
passes over one slab.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

INT = torch.int32


def shard_degree_counts(inc: torch.Tensor, slab_bounds: Sequence[int],
                        n_r: int) -> torch.Tensor:
    """Pass 1: (n_shards, n_r) int64 per-shard r-clique degree counts."""
    n_shards = len(slab_bounds) - 1
    counts = torch.zeros((n_shards, n_r), dtype=torch.int64,
                         device=inc.device)
    for k in range(n_shards):
        lo, hi = int(slab_bounds[k]), int(slab_bounds[k + 1])
        if hi > lo:
            counts[k] = torch.bincount(inc[lo:hi].reshape(-1).long(),
                                       minlength=n_r)
    return counts


def assemble_mem_csr(inc: torch.Tensor, slab_bounds: Sequence[int],
                     n_r: int, q_block: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                int]:
    """Two-pass exchange: ``(mem_offsets, mem_sids, deg0, exchange_bytes)``.

    ``inc`` is the global (n_s, C) member-id table, ``slab_bounds`` the
    (n_shards + 1,) global-row boundaries of each shard's slab, ``q_block``
    the fill block size (rows) bounding pass-2 transients.
    """
    dev = inc.device
    n_s, C = int(inc.shape[0]), int(inc.shape[1])
    n_shards = len(slab_bounds) - 1

    counts = shard_degree_counts(inc, slab_bounds, n_r)
    deg0 = counts.sum(dim=0).to(INT)  # the all-reduce result
    mem_offsets = torch.zeros((n_r + 1,), dtype=INT, device=dev)
    mem_offsets[1:] = torch.cumsum(deg0, 0, dtype=torch.int64).to(INT)

    mem_sids = torch.empty((n_s * C,), dtype=INT, device=dev)
    earlier = torch.zeros((n_r,), dtype=torch.int64, device=dev)
    for k in range(n_shards):
        lo, hi = int(slab_bounds[k]), int(slab_bounds[k + 1])
        cursor = mem_offsets[:-1].to(torch.int64) + earlier
        # blocks never cross the slab boundary: the cursor state is
        # shard-local, so shard k's fill touches only its own ranges
        for b0 in range(lo, hi, q_block):
            blk = inc[b0:min(b0 + q_block, hi)]
            rid = blk.reshape(-1).long()
            sid = torch.repeat_interleave(
                torch.arange(b0, b0 + blk.shape[0], dtype=INT, device=dev),
                C)
            ordr = torch.argsort(rid, stable=True)
            rid_s, sid_s = rid[ordr], sid[ordr]
            uniq, cnts = torch.unique_consecutive(rid_s, return_counts=True)
            run_starts = torch.cumsum(cnts, 0) - cnts
            occ = torch.arange(rid_s.numel(), device=dev) - \
                torch.repeat_interleave(run_starts, cnts)
            mem_sids[cursor[rid_s] + occ] = sid_s
            cursor[uniq] += cnts
        earlier += counts[k]

    exchange_bytes = counts.numel() * counts.element_size()
    return mem_offsets, mem_sids, deg0, int(exchange_bytes)
