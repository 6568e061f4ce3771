"""``repro_torch.distbuild``: sharded clique listing + incidence build
(counterpart of ``repro.distbuild``).

  * ``planner``  — partition the level-1 frontier into budget-sized
    source-vertex chunks and assign contiguous chunk ranges to shards by
    an oriented-degree work estimate; also the eager build's memory
    estimate that ``backend="auto"`` reads.
  * ``builder``  — each shard expands its own chunks, and its s-clique
    rows land as a contiguous slab of the global s-table, the s-axis
    layout ``core.distributed`` partitions.
  * ``exchange`` — the membership CSR by a two-pass count-then-fill over
    per-shard degree counts.

The output is bit-identical to the eager and chunked builders for every
shard count; ``build_problem(..., build="sharded")`` is the front door.
"""
from .builder import build_problem_sharded
from .planner import (ShardPlan, estimate_eager_build_bytes, plan_shards,
                      seed_work_estimate)

__all__ = [
    "ShardPlan",
    "build_problem_sharded",
    "estimate_eager_build_bytes",
    "plan_shards",
    "seed_work_estimate",
]
