"""Parallel peeling: exact (ARB-NUCLEUS analog) and approximate (Alg. 2).

Counterpart of ``repro.core.peel``.  Two backends, one schedule
(``core.schedule.PeelSchedule``):

  * ``dense``: the peel engine (``engine.dense_coreness``): every round is
    a fixed-shape pass over the whole incidence structure, on the round
    kernels when they are on; with ``hierarchy=True`` the LINK fixpoint
    rides in the same loop.
  * ``gather``: each round touches only the s-cliques incident to the
    peeled set (CSR gather + unique + ``index_add_``), the work-efficient
    formulation matching the paper's bounds.  Shapes are data-dependent
    per round, so this backend stays an eager host loop with the
    reference's syncs (an ``int(...)`` per round); it runs no kernel.  Its
    hierarchy comes from the host trace replay (``interleaved``).

Both record the peel trace (``order_round`` + raw peel values).

**Routing of (r, s) = (1, 2).**  A dense (1, 2) peel runs the k-core lane
(``core.kcore``: vertex peel, the segment-sum kernel as its decrement, one
edge-list link fixpoint) unless the caller passes ``use_kernel=True``,
which pins the generic engine on the peel-round megakernel.  The
reference takes the lane unless it wants the Pallas megakernel; its
default on the CPU is the lane, so the two route alike there.
``fast_lane=True/False`` forces the route (the tests compare lanes).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from ..graph.container import INT
from .engine import BIG, dense_coreness, make_schedule
from .incidence import NucleusProblem
from .kcore import kcore_coreness, takes_kcore_lane
from .schedule import PeelSchedule

BACKENDS = ("dense", "gather")


@dataclasses.dataclass
class PeelResult:
    core: torch.Tensor          # (n_r,) int32 — exact or estimated cores
    rounds: int                 # number of peel rounds
    order_round: torch.Tensor   # (n_r,) round at which each clique peeled
    # (n_r,) raw bucket value assigned at peel time (pre-clipping), what the
    # LINK state saw; == core for exact peeling (None -> core)
    peel_value: Optional[torch.Tensor] = None
    uf_parent: Optional[torch.Tensor] = None  # (n_r,) resolved ANH-EL union-
    uf_L: Optional[torch.Tensor] = None       # find + nearest-lower-core table
    # (hierarchy=True only) — the join forest of the LINK fixpoint.

    def __post_init__(self):
        if self.peel_value is None:
            self.peel_value = self.core

    @property
    def has_hierarchy(self) -> bool:
        return self.uf_parent is not None


def _gather_incident_sids(problem: NucleusProblem,
                          a_ids: torch.Tensor) -> torch.Tensor:
    """All s-clique ids incident to the peeled set (with duplicates)."""
    off = problem.mem_offsets
    dev = off.device
    starts_of = off[a_ids.long()]
    counts = off[a_ids.long() + 1] - starts_of
    total = int(counts.sum())
    if total == 0:
        return torch.zeros((0,), dtype=INT, device=dev)
    starts = torch.cumsum(counts, 0) - counts
    rep = torch.repeat_interleave(
        torch.arange(a_ids.shape[0], device=dev), counts.long(),
        output_size=total)
    pos = torch.arange(total, device=dev) - starts[rep]
    return problem.mem_sids[(starts_of[rep] + pos).long()]


def _peel_loop(problem: NucleusProblem,
               schedule: PeelSchedule) -> PeelResult:
    """Work-efficient gather backend: eager host loop, data-dependent
    shapes.

    The bucket sequence comes from the same ``PeelSchedule`` the dense
    engine uses (level >= dmin every round, so each iteration peels at
    least the minimum-degree clique and the loop ends).  An empty
    incident set or an empty set of newly dead s-cliques touches nothing.
    """
    n_r = problem.n_r
    dev = problem.device
    deg = problem.deg0.clone()
    core = torch.full((n_r,), -1, dtype=INT, device=dev)
    order_round = torch.full((n_r,), -1, dtype=INT, device=dev)
    peeled = torch.zeros((n_r,), dtype=torch.bool, device=dev)
    s_alive = torch.ones((problem.n_s,), dtype=torch.bool, device=dev)
    sched = schedule.init_carry()
    rounds = 0
    n_left = n_r
    while n_left > 0:
        live_deg = torch.where(peeled, torch.full_like(deg, BIG), deg)
        sched, level = schedule.next_level(sched, int(live_deg.min()))
        a_mask = (~peeled) & (deg <= level)
        core = torch.where(a_mask, torch.full_like(core, level), core)
        order_round = torch.where(a_mask, torch.full_like(order_round,
                                                          rounds),
                                  order_round)
        peeled = peeled | a_mask
        a_ids = torch.nonzero(a_mask).squeeze(1)
        n_left -= int(a_ids.shape[0])
        sids = _gather_incident_sids(problem, a_ids)
        if int(sids.shape[0]):
            sids_u = torch.unique(sids).long()
            newly = sids_u[s_alive[sids_u]]
            if int(newly.shape[0]):
                s_alive[newly] = False
                members = problem.inc_rid[newly].reshape(-1).long()
                # index_add_ stands in for the reference's .at[].add
                deg.index_add_(0, members,
                               torch.full_like(members, -1, dtype=INT))
        rounds += 1
    return PeelResult(core=core, rounds=rounds, order_round=order_round)


def _run(problem: NucleusProblem, schedule: PeelSchedule, *,
         backend: str, device: DeviceLike, use_kernel: Optional[bool],
         hierarchy: bool, fast_lane: Optional[bool]) -> PeelResult:
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}; expected one of {BACKENDS}")
    problem = problem.to(resolve_device(device))
    if backend == "dense":
        if fast_lane is None:
            fast_lane = takes_kcore_lane(problem.r, problem.s, use_kernel)
        if fast_lane:
            out = kcore_coreness(problem, schedule, hierarchy=hierarchy,
                                 use_kernel=use_kernel)
        else:
            out = dense_coreness(problem, schedule, device=problem.device,
                                 use_kernel=use_kernel, hierarchy=hierarchy)
        if hierarchy:
            core, order, rounds, parent, L = out
            return PeelResult(core=core, rounds=int(rounds),
                              order_round=order, uf_parent=parent, uf_L=L)
        core, order, rounds = out
        return PeelResult(core=core, rounds=int(rounds), order_round=order)
    res = _peel_loop(problem, schedule)
    if hierarchy:
        # eager backend: the forest comes from the host trace replay (the
        # same forest, DESIGN.md §4); imported here to avoid the
        # peel <-> interleaved cycle
        from .interleaved import forest_from_trace
        parent, L, _ = forest_from_trace(problem, res)
        dev = problem.device
        res = dataclasses.replace(
            res, uf_parent=torch.as_tensor(parent, dtype=INT, device=dev),
            uf_L=torch.as_tensor(L, dtype=INT, device=dev))
    return res


def exact_coreness(problem: NucleusProblem, *, backend: str = "dense",
                   device: DeviceLike = None,
                   use_kernel: Optional[bool] = None,
                   hierarchy: bool = False,
                   fast_lane: Optional[bool] = None) -> PeelResult:
    """Exact core numbers; hierarchy=True also returns the ANH-EL join
    forest (from the same loop on the dense backend).  ``fast_lane``
    forces the r1s2 k-core lane on or off (None: the routing rule of the
    module docstring)."""
    return _run(problem, make_schedule(problem, "exact"), backend=backend,
                device=device, use_kernel=use_kernel, hierarchy=hierarchy,
                fast_lane=fast_lane)


def approx_coreness(problem: NucleusProblem, delta: float = 0.1, *,
                    backend: str = "dense", device: DeviceLike = None,
                    use_kernel: Optional[bool] = None,
                    hierarchy: bool = False,
                    fast_lane: Optional[bool] = None) -> PeelResult:
    """(C(s,r)+eps)-approximate core numbers.

    The assigned value is clipped to the clique's original s-clique-degree
    (paper section 6); ``peel_value`` keeps the unclipped bucket values,
    which drove LINK equality during the peel.
    """
    res = _run(problem, make_schedule(problem, "approx", delta),
               backend=backend, device=device, use_kernel=use_kernel,
               hierarchy=hierarchy, fast_lane=fast_lane)
    deg0 = problem.deg0.to(res.core.device)
    return dataclasses.replace(res, core=torch.minimum(res.core, deg0),
                               peel_value=res.core)
