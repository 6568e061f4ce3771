"""Chunk -> shard work planner for the sharded incidence build, and the
eager build's memory estimate (counterpart of ``repro.distbuild.planner``).

Two nested partitions of the level-1 frontier (the seed vertices):

  * **Chunks** bound peak expansion memory per worker with the chunked
    builder's budget-derived sizing (``incidence._derive_chunk_size``).
  * **Shards** get contiguous *chunk ranges* balanced by a per-seed work
    estimate.  Contiguity is load-bearing: seed ranges expand to
    contiguous row ranges of the expansion-ordered clique tables, so each
    shard's s-clique output is a contiguous slab of the final s-table.

The work estimate is ``w(v) = outdeg(v) * dmax^(s-2) + 1``, the rows seed
v can materialize; per-chunk totals come off one prefix sum and shard
boundaries sit at the equal-work quantiles of the chunk-work prefix, so

    max shard work <= total work / n_shards + max single-chunk work.

The plan is a few host numbers per chunk, computed in float64 numpy as the
reference does, so both packages plan the same shards for the same graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..graph.container import Digraph


def seed_work_estimate(dg: Digraph, s: int) -> np.ndarray:
    """(n,) float64 per-seed expansion-work estimate (rows materialized)."""
    outdeg = dg.outdeg.cpu().numpy().astype(np.float64)
    depth = float(max(dg.dmax, 1)) ** max(s - 2, 0)
    # +1 keeps zero-out-degree seeds visible, so all-zero work never
    # degenerates the quantile search
    return outdeg * depth + 1.0


def estimate_eager_build_bytes(dg: Digraph, s: int) -> int:
    """Upper estimate of the eager builder's peak intermediate bytes.

    The same per-seed constant ``incidence._derive_chunk_size`` budgets
    with (~28 B per candidate element at the deepest level), summed over
    the whole frontier: what the planner compares against
    ``memory_budget_bytes`` to decide one device cannot afford the
    one-burst expansion.  Host float64, as the reference, so both give the
    same integer."""
    outdeg = dg.outdeg.cpu().numpy().astype(np.float64)
    dmax = max(dg.dmax, 1)
    rows = outdeg * float(dmax) ** max(s - 2, 0)
    return int(28.0 * (s + dmax) * float(rows.sum()))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """The planner's decision: chunk boundaries + contiguous shard ranges.

    ``chunk_bounds``  (n_chunks + 1,) seed-vertex boundaries; chunk i is
                      seeds [chunk_bounds[i], chunk_bounds[i+1]).
    ``shard_bounds``  (n_shards + 1,) chunk-index boundaries; shard k owns
                      chunks [shard_bounds[k], shard_bounds[k+1]), possibly
                      none on tiny graphs.
    ``chunk_work``    (n_chunks,) estimated rows per chunk.
    """

    n_shards: int
    chunk_size: int
    chunk_bounds: Tuple[int, ...]
    shard_bounds: Tuple[int, ...]
    chunk_work: Tuple[float, ...]

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_bounds) - 1

    def shard_seed_range(self, k: int) -> Tuple[int, int]:
        """Seed-vertex range [start, stop) shard k expands."""
        c0, c1 = self.shard_bounds[k], self.shard_bounds[k + 1]
        return self.chunk_bounds[c0], self.chunk_bounds[c1]

    def chunks_per_shard(self) -> Tuple[int, ...]:
        b = self.shard_bounds
        return tuple(b[k + 1] - b[k] for k in range(self.n_shards))

    def shard_work(self) -> Tuple[float, ...]:
        w = np.asarray(self.chunk_work)
        b = self.shard_bounds
        return tuple(float(w[b[k]:b[k + 1]].sum())
                     for k in range(self.n_shards))

    def skew(self) -> float:
        """max/mean of estimated shard work (1.0 is perfect balance; empty
        plans report 1.0)."""
        work = self.shard_work()
        mean = sum(work) / max(len(work), 1)
        return float(max(work) / mean) if mean > 0 else 1.0


def plan_shards(dg: Digraph, s: int, n_shards: int, *,
                memory_budget_bytes: Optional[int] = None,
                chunk_size: Optional[int] = None) -> ShardPlan:
    """Partition the frontier into chunks and assign them to shards.

    ``chunk_size`` pins the chunk width; otherwise it derives from the
    budget as the chunked builder's does, capped at ``ceil(n / n_shards)``
    so every shard can get a chunk.
    """
    from ..core.incidence import DEFAULT_BUILD_BUDGET, _derive_chunk_size
    n_shards = max(int(n_shards), 1)
    if chunk_size is None:
        budget = memory_budget_bytes if memory_budget_bytes is not None \
            else DEFAULT_BUILD_BUDGET
        chunk_size = _derive_chunk_size(dg, s, budget)
        if dg.n:
            chunk_size = min(chunk_size, -(-int(dg.n) // n_shards))
    chunk_size = max(1, int(chunk_size))
    n = int(dg.n)
    chunk_bounds = list(range(0, n, chunk_size)) + [n]
    if n == 0:
        chunk_bounds = [0, 0]
    n_chunks = len(chunk_bounds) - 1

    w = seed_work_estimate(dg, s)
    cum = np.concatenate([[0.0], np.cumsum(w)]) if n else np.zeros((1,))
    chunk_work = tuple(
        float(cum[chunk_bounds[i + 1]] - cum[chunk_bounds[i]])
        for i in range(n_chunks))

    # equal-work quantiles over the chunk-work prefix: shard k ends at the
    # first chunk boundary whose cumulative work reaches k/n_shards of the
    # total; a chunk is never split
    prefix = np.concatenate([[0.0], np.cumsum(np.asarray(chunk_work))])
    total = float(prefix[-1])
    targets = total * np.arange(1, n_shards) / n_shards
    inner = np.clip(np.searchsorted(prefix, targets, side="left"),
                    0, n_chunks)
    shard_bounds = (0,) + tuple(int(x) for x in np.sort(inner)) + (n_chunks,)
    return ShardPlan(n_shards=n_shards, chunk_size=chunk_size,
                     chunk_bounds=tuple(chunk_bounds),
                     shard_bounds=shard_bounds,
                     chunk_work=chunk_work)
