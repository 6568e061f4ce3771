"""Parallel peeling: exact (ARB-NUCLEUS analog) and approximate (Alg. 2).

Counterpart of ``repro.core.peel``, dense backend only: both entry points
run ``engine.dense_coreness``.  The gather backend and the r1s2 k-core
fast lane are not ported in this slice (ROADMAP Queue 1.5); (1, 2)
problems run the general engine, which gives the same core numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import DeviceLike
from .engine import dense_coreness, make_schedule
from .incidence import NucleusProblem
from .schedule import PeelSchedule


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
    # (hierarchy=True only) — the join forest of the fused LINK fixpoint.

    def __post_init__(self):
        if self.peel_value is None:
            self.peel_value = self.core


def _run(problem: NucleusProblem, schedule: PeelSchedule, *,
         device: DeviceLike, use_kernel: Optional[bool],
         hierarchy: bool) -> PeelResult:
    out = dense_coreness(problem, schedule, device=device,
                         use_kernel=use_kernel, hierarchy=hierarchy)
    if hierarchy:
        core, order, rounds, parent, L = out
        return PeelResult(core=core, rounds=rounds, order_round=order,
                          uf_parent=parent, uf_L=L)
    core, order, rounds = out
    return PeelResult(core=core, rounds=rounds, order_round=order)


def exact_coreness(problem: NucleusProblem, *, device: DeviceLike = None,
                   use_kernel: Optional[bool] = None,
                   hierarchy: bool = False) -> PeelResult:
    """Exact core numbers; hierarchy=True also returns the ANH-EL join
    forest from the same peel."""
    return _run(problem, make_schedule(problem, "exact"), device=device,
                use_kernel=use_kernel, hierarchy=hierarchy)


def approx_coreness(problem: NucleusProblem, delta: float = 0.1, *,
                    device: DeviceLike = None,
                    use_kernel: Optional[bool] = None,
                    hierarchy: bool = False) -> PeelResult:
    """(C(s,r)+eps)-approximate core numbers.

    The assigned value is clipped to the clique's original s-clique-degree
    (paper section 6); ``peel_value`` keeps the unclipped bucket values,
    which drove LINK equality during the peel.
    """
    res = _run(problem, make_schedule(problem, "approx", delta),
               device=device, use_kernel=use_kernel, hierarchy=hierarchy)
    deg0 = problem.deg0.to(res.core.device)
    return dataclasses.replace(res, core=torch.minimum(res.core, deg0),
                               peel_value=res.core)
