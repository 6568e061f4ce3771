"""The r1s2 (k-core) fast lane: vertex-degree peel, no incidence table.

Counterpart of ``repro.core.kcore``.  For (r, s) = (1, 2) the nucleus
decomposition degenerates to the classic k-core: r-cliques are vertices,
s-cliques are edges, and the s-clique degree is the vertex degree.  The
lane uses two degeneracies:

  * **Peel**: the per-round decrement is an adjacency reduction,
    ``delta[v] = #{u in N(v) : u peeled this round}`` over the vertex CSR
    ``(vids, nbrs)``, whose ``vids`` ascend by construction.  So it is a
    sorted-segment sum: ``kernels.segment_sum.segment_sum`` of
    ``a[nbrs]`` by ``vids``, the hand-written kernel on CUDA tensors and
    its plain twin on CPU tensors (``use_kernel=False`` takes the plain
    twin on the card too).  Decrements against already peeled vertices are
    masked, as the generic engine's edge-death accounting does, so core,
    order and rounds are bit-identical to the generic engine.
  * **Hierarchy**: with C = 2 every edge emits exactly one link over the
    whole peel, so the link multiset is the edge list itself; since
    ``engine.link_fixpoint`` depends only on that multiset (DESIGN.md §5),
    ONE fixpoint over the edge list after the peel replaces the per-round
    fixpoints of the generic engine.  On the card this is the lane's gain:
    the per-round host-driven fixpoint is the main path's largest cost.

The lane reuses ``run_peel_engine`` through its ``fused_round`` hook (same
schedule, same trace semantics) and is declared as the ``"kcore"`` fast
lane of the dense backend.  ``peel._run`` routes (1, 2) dense peels here
unless ``use_kernel=True`` pins the generic megakernel engine.

``kcore_local_converge`` is the streaming update's local iteration at
(1, 2): ``engine.local_converge`` over the adjacency instead of incidence
slots.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..graph.container import INT
from ..kernels.peel_round import PEELED, peel_key
from ..kernels.segment_sum import segment_sum, segment_sum_plain
from .engine import _plan_cache, _sweep_to_fixpoint, h_index_segments, \
    kernel_by_default, link_fixpoint, run_peel_engine
from .incidence import NucleusProblem
from .schedule import PeelSchedule


def kcore_local_converge(owner: torch.Tensor, nbrs: torch.Tensor,
                         vals0: torch.Tensor, frozen: torch.Tensor,
                         max_sweeps: int):
    """Restartable-from-state local k-core iteration (the r1s2 degeneracy
    of ``engine.local_converge``): with C = 2 the per-s-clique "min of the
    other members" is the neighbor's value, so one Jacobi sweep is an
    adjacency gather and an h-index, with no incidence-slot indirection.

    owner, nbrs: (E,) pairs: vertex ``owner[k]`` has neighbor ``nbrs[k]``,
    both in the subproblem's vertex space (the reference pads them to an
    (m, d) matrix); vals0, frozen and max_sweeps as in
    ``engine.local_converge``.  Returns (vals, sweeps) with sweeps a
    Python int.
    """
    m = int(vals0.shape[0])
    nbrs = nbrs.long()

    def theta(vals):
        return h_index_segments(vals[nbrs], owner, m)

    return _sweep_to_fixpoint(theta, vals0, frozen, int(max_sweeps))


def takes_kcore_lane(r: int, s: int, use_kernel: Optional[bool]) -> bool:
    """The routing rule of a dense peel: (r, s) = (1, 2) runs this lane
    unless ``use_kernel=True`` pins the generic engine on the peel-round
    megakernel (``peel._run`` follows it; the planner records it)."""
    return (r, s) == (1, 2) and use_kernel is not True


def kcore_plan(problem: NucleusProblem):
    """Vertex-adjacency CSR slots: (vids, nbrs), both (2m,) int32, vids
    ascending.

    Slot k says: vertex ``vids[k]`` has neighbor ``nbrs[k]``.  Built once
    per problem (memoized on it); the per-round decrement is then the
    segment sum of ``a[nbrs]`` by ``vids``.
    """
    cache = _plan_cache(problem)
    if "kcore" not in cache:
        e = problem.g.edges.to(problem.device)
        src = torch.cat([e[:, 0], e[:, 1]])
        dst = torch.cat([e[:, 1], e[:, 0]])
        order = torch.argsort(src, stable=True)
        cache["kcore"] = (src[order].contiguous(), dst[order].contiguous())
    return cache["kcore"]


def _kcore_engine(vids, nbrs, edges, deg0, *, schedule: PeelSchedule,
                  max_rounds: int, hierarchy: bool, use_kernel: bool):
    n = int(deg0.shape[0])
    decrement = segment_sum if use_kernel else segment_sum_plain
    has_edges = int(vids.shape[0]) > 0

    def fused_round(deg, key, core, order, level, rnd):
        peeled = key == PEELED
        a = (~peeled) & (deg <= level)
        newp = peeled | a
        core = torch.where(a, torch.full_like(core, level), core)
        order = torch.where(a, torch.full_like(order, rnd), order)
        if has_edges:
            # delta[v] = # newly peeled neighbors: one n-long cast, then an
            # int32 gather by the int32 plan
            hit = torch.index_select(a.to(INT), 0, nbrs)
            delta = decrement(hit[:, None], vids, n)[:, 0]
            # decrements against frozen (peeled) vertices are masked,
            # matching the generic engine's edge-death accounting
            deg = torch.where(newp, deg, deg - delta)
        return deg, peel_key(deg, newp), core, order

    dummy_inc = torch.zeros((0, 2), dtype=INT, device=deg0.device)
    core, order, rounds = run_peel_engine(
        dummy_inc, deg0, schedule, max_rounds=max_rounds,
        fused_round=fused_round)
    if not hierarchy:
        return core, order, rounds
    # ONE fixpoint over the whole edge-list link multiset (module
    # docstring): the per-round fused engine's (parent, L), by the
    # confluence of link_fixpoint, at a single invocation's cost
    parent = torch.arange(n, dtype=INT, device=deg0.device)
    L = torch.full((n,), -1, dtype=INT, device=deg0.device)
    if int(edges.shape[0]):
        parent, L = link_fixpoint(parent, L, core, edges[:, 0], edges[:, 1],
                                  max_gens=3 * n + 4)
    return core, order, rounds, parent, L


def kcore_coreness(problem: NucleusProblem, schedule: PeelSchedule, *,
                   max_rounds: Optional[int] = None,
                   hierarchy: bool = False,
                   use_kernel: Optional[bool] = None):
    """Drop-in for ``dense_coreness`` on an (r, s) = (1, 2) problem, on the
    problem's device.

    Same return contract: (core_raw, order_round, rounds[, parent, L]),
    bit-identical to the generic dense engine.  ``use_kernel=None``
    resolves as in ``dense_coreness`` (``engine.kernel_by_default``);
    False takes the segment sum's plain twin.
    """
    assert (problem.r, problem.s) == (1, 2), \
        f"kcore lane needs (r, s) = (1, 2), got {(problem.r, problem.s)}"
    dev = problem.device
    n = problem.n_r
    if max_rounds is None:
        max_rounds = n + 2
    if use_kernel is None:
        use_kernel = kernel_by_default(dev)
    if n == 0:
        empty = torch.zeros((0,), dtype=INT, device=dev)
        out = (empty, empty, 0)
        return out + (empty, empty) if hierarchy else out
    vids, nbrs = kcore_plan(problem)
    edges = problem.g.edges.to(dev).reshape(-1, 2)
    return _kcore_engine(vids, nbrs, edges, problem.deg0,
                         schedule=schedule, max_rounds=max_rounds,
                         hierarchy=hierarchy, use_kernel=use_kernel)
