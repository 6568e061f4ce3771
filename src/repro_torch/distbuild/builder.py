"""Shard-local expansion + direct slab assembly of the incidence structure
(counterpart of ``repro.distbuild.builder``).

Shard k expands only its planned seed range (contiguous chunks, each
budget-bounded like the chunked builder's), so its s-clique rows are a
contiguous slab of the global expansion-ordered s-table.  The slab bounds
follow from the per-shard row counts, so ``inc_rid`` is allocated once and
every shard joins its rows into its own ``[slab_lo, slab_hi)`` range; the
membership CSR comes from ``exchange``'s two-pass count-then-fill.

The only globally shared inputs are the r-clique table (every shard joins
against it: the broadcast a multi-host run would issue) and the
per-r-clique degree counts (the all-reduce); both are charged to
``build_stats["exchange_bytes"]``.  Bit-identity with the eager and chunked
builders follows from the reference's three facts: contiguous seed ranges
expand independently and duplicate-free, the sort-join is a per-row
function of (table, row), and slabs are filled in ascending s-id order.

As in the reference, the shards run one after another in one process.
Unlike it, every step runs on the graph's device through the port's
``graph.cliques`` and ``core.incidence`` helpers, not on host numpy.
"""
from __future__ import annotations

from math import comb
from typing import Any, Dict, List, Optional

import torch

from ..graph.cliques import iter_clique_chunks, lexsort_rows
from ..graph.container import Graph, INT
from .exchange import assemble_mem_csr
from .planner import estimate_eager_build_bytes, plan_shards


def build_problem_sharded(g: Graph, r: int, s: int,
                          rank: Optional[torch.Tensor] = None, *,
                          n_shards: Optional[int] = None,
                          memory_budget_bytes: Optional[int] = None,
                          chunk_size: Optional[int] = None):
    """Sharded twin of ``incidence.build_problem`` (the front door for
    ``build="sharded"``), on ``g``'s device.

    ``n_shards=None`` means the length of ``launch.mesh.make_host_mesh``
    for that device, so build slabs line up with the peel's.  The arrays
    are bit-identical to the eager builder's for every shard count.
    """
    # late import: incidence dispatches here from build_problem
    from ..core.incidence import (DEFAULT_BUILD_BUDGET, NucleusProblem,
                                  _fill_parts, _resolve_digraph, join_into,
                                  join_block_rows)
    if not 1 <= r < s:
        raise ValueError(f"need 1 <= r < s, got (r, s) = ({r}, {s})")
    dev = g.device
    if n_shards is None:
        from ..launch.mesh import make_host_mesh
        n_shards = len(make_host_mesh(dev))
    dg, orientation = _resolve_digraph(g, rank)
    budget = memory_budget_bytes if memory_budget_bytes is not None \
        else DEFAULT_BUILD_BUDGET
    plan = plan_shards(dg, s, n_shards,
                       memory_budget_bytes=memory_budget_bytes,
                       chunk_size=chunk_size)

    # --- shard-local expansion: each shard walks only its chunk range ----
    C = comb(s, r)
    all_r_parts: List[torch.Tensor] = []
    s_slabs: List[Optional[torch.Tensor]] = []
    expand_peak = 0
    for k in range(plan.n_shards):
        seed0, seed1 = plan.shard_seed_range(k)
        s_parts: List[torch.Tensor] = []
        for _s0, levels, chunk_peak in iter_clique_chunks(
                dg, [r, s], plan.chunk_size, start=seed0, stop=seed1):
            expand_peak = max(expand_peak, int(chunk_peak))
            all_r_parts.append(levels[r])
            s_parts.append(levels[s])
        s_slabs.append(_fill_parts(s_parts, s, dev))

    # --- r-clique table: the broadcast side of the exchange --------------
    # r rows are globally unique (DAG orientation), so the lexsorted union
    # of the shard parts is the eager path's table
    r_rows = _fill_parts(all_r_parts, r, dev)
    r_table = r_rows[lexsort_rows(r_rows)] if r_rows.shape[0] else r_rows
    del r_rows
    n_r = int(r_table.shape[0])

    # --- slab bounds + per-shard blocked join into the global inc --------
    slab_bounds = [0]
    for slab in s_slabs:
        slab_bounds.append(slab_bounds[-1] + int(slab.shape[0]))
    n_s = slab_bounds[-1]
    q_block = join_block_rows(budget, r, s)
    inc = torch.empty((n_s, C), dtype=INT, device=dev)
    join_bytes = 0
    for k in range(plan.n_shards):
        join_bytes = max(join_bytes, join_into(
            inc, slab_bounds[k], s_slabs[k], r_table, r, s, q_block))
        s_slabs[k] = None  # release the slab's vertex tuples as we go

    # --- two-pass count-then-fill exchange for the mem-CSR ---------------
    mem_offsets, mem_sids, deg0, exchange_bytes = assemble_mem_csr(
        inc, slab_bounds, n_r, q_block)
    exchange_bytes += max(plan.n_shards - 1, 0) * \
        r_table.numel() * r_table.element_size()

    stats: Dict[str, Any] = {
        "build": "sharded",
        "n_shards": int(plan.n_shards),
        "chunk_size": int(plan.chunk_size),
        "n_chunks": int(plan.n_chunks),
        "chunks_per_shard": [int(c) for c in plan.chunks_per_shard()],
        "shard_work": [float(w) for w in plan.shard_work()],
        "skew": float(plan.skew()),
        "exchange_bytes": int(exchange_bytes),
        "peak_intermediate_bytes": max(expand_peak, join_bytes),
        "memory_budget_bytes": memory_budget_bytes,
        "eager_estimate_bytes": int(estimate_eager_build_bytes(dg, s)),
        "fastpath": False,
    }
    return NucleusProblem(
        g=g, r=r, s=s, r_cliques=r_table.contiguous(), inc_rid=inc,
        mem_offsets=mem_offsets, mem_sids=mem_sids, deg0=deg0,
        orientation=orientation, build_stats=stats)
