"""The eager build's memory estimate (counterpart of the single-device part
of ``repro.distbuild.planner``).

The sharded build's chunk -> shard planner is ROADMAP Queue 1.9.
"""
from __future__ import annotations

import numpy as np

from ..graph.container import Digraph


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
