"""The sharded (r, s) nucleus decomposition over a device mesh
(counterpart of ``repro.core.distributed``).

The reference partitions the s-clique axis across devices under
``shard_map`` and replicates the r-clique state; each shard runs the
shared peel engine with its ``reduce_delta`` hook bound to a ``psum`` of
the (n_r,) decrement and its ``gather_links`` hook to an all-gather of the
round's links.  The port keeps that design with one process driving a
``launch.mesh.Mesh`` (a tuple of torch devices):

  * **Slabs.**  The s-clique axis is cut into contiguous slabs of
    ``ceil(n_s / k)`` rows (the reference's ``pad_incidence`` bounds, with
    no ghost rows: torch needs no equal shapes); slab ``i`` lives on
    ``mesh[i]``.
  * **Plans.**  Slab ``i``'s decrement plan is the global rid-sorted
    segment-sum plan (``engine._scatter_plan``) filtered to its s-clique
    range, which keeps the rids ascending; memoized per problem and mesh.
  * **Decrement.**  Each round's per-slab decrement is one launch of the
    segment-sum kernel (``kernels/segment_sum.py``) on that plan.  The
    peel-round megakernel does not fit: it writes the post-round degree
    from one slab's edges alone.
  * **State and reduce.**  The replicated ``(deg, key, core, order)``
    state is kept once per *distinct* device, each running the engine over
    its slabs.  Slabs sharing a device sum their decrements there;
    distinct cards then reduce with ``torch.cuda.nccl.all_reduce`` (one
    engine thread per card, meeting at a barrier per collective).
  * **Links.**  Each replica generates its slabs' links; they are gathered
    in device order onto ``mesh[0]``, where ``link_fixpoint`` folds them
    once.  With one distinct device the round's links are the dense
    engine's, in its order; in every case their multiset is, so ``core``,
    ``rounds``, ``uf_parent`` and ``uf_L`` are bit-identical to
    ``dense_coreness(..., hierarchy=True)``.

``compress=True`` halves the reduction's bytes and stays exact, where the
reference's int16 error-feedback scheme is not (ROADMAP preamble).  Each
slab sends ``min(delta + resid, cap)`` as float16 with ``cap = 2048 //
k``, so every partial sum is an integer of at most 2,048, which float16
holds exactly; one more element of the payload counts the slabs that kept
a residual.  While any did, the engine runs drain steps (``engine.
run_peel_engine``) before it takes the next minimum, so every minimum is
taken over fully landed degrees and the arrays equal the uncompressed
run's.  The rule is the same on every mesh, so the CPU runs the card's
arithmetic.
"""
from __future__ import annotations

import threading
from contextlib import nullcontext
from math import comb
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..graph.container import INT
from ..kernels.segment_sum import segment_sum
from ..launch.mesh import Mesh
from .engine import _plan_cache, _scatter_plan, run_peel_engine
from .incidence import NucleusProblem
from .schedule import PeelSchedule

# float16 holds every integer up to 2**11 exactly: the bound on a
# compressed reduction's partial sums
COMPRESS_SUM = 1 << 11


def slab_bounds(n_s: int, n_slabs: int) -> List[int]:
    """Row bounds of the ``n_slabs`` contiguous slabs of ``ceil(n_s /
    n_slabs)`` rows (trailing slabs may be short or empty)."""
    rows = -(-int(n_s) // int(n_slabs))
    return [min(i * rows, int(n_s)) for i in range(int(n_slabs) + 1)]


class _Part:
    """What one distinct device of the mesh holds: its slabs' incidence
    rows stacked in slab order, each slab's decrement plan over that
    stack, and ``deg0``."""

    def __init__(self, device: torch.device, slabs: List[int]):
        self.device = device
        self.slabs = slabs
        self.inc: Optional[torch.Tensor] = None
        self.plans: List = []
        self.deg0: Optional[torch.Tensor] = None


def _partition(problem: NucleusProblem, mesh: Mesh) -> List[_Part]:
    """The mesh's parts in ``mesh.distinct()`` order, memoized on the
    problem per mesh."""
    cache = _plan_cache(problem)
    key = ("sharded", mesh)
    if key in cache:
        return cache[key]
    bounds = slab_bounds(problem.n_s, len(mesh))
    rids, sids = _scatter_plan(problem)
    parts = []
    for dev in mesh.distinct():
        part = _Part(dev, [i for i, d in enumerate(mesh) if d == dev])
        rows = [(bounds[i], bounds[i + 1]) for i in part.slabs]
        # nucleuslint: disable=NL102 (host ints, additive taint)
        if len(rows) == 1 or all(a[1] == b[0] for a, b in zip(rows, rows[1:])):
            inc = problem.inc_rid[rows[0][0]:rows[-1][1]]
        else:
            inc = torch.cat([problem.inc_rid[lo:hi] for lo, hi in rows])
        part.inc = inc.to(dev).contiguous()
        at = 0
        for lo, hi in rows:
            keep = (sids >= lo) & (sids < hi)
            part.plans.append((rids[keep].to(dev).contiguous(),
                               (sids[keep] - (lo - at)).to(dev).contiguous()))
            at += hi - lo
        part.deg0 = problem.deg0.to(dev)
        parts.append(part)
    cache[key] = parts
    return parts


class _Collective:
    """The mesh's collectives across its distinct devices.

    One device: the identity (slabs already summed on it).  Several: each
    device's engine thread deposits its tensor and waits at a barrier,
    whose action runs ``torch.cuda.nccl.all_reduce`` over all of them in
    place; links are deposited the same way and concatenated on the first
    device.  A failed NCCL call is not caught: it breaks the barrier and
    is re-raised by ``sharded_decomposition``."""

    def __init__(self, devices):
        self.devices = devices
        self.n = len(devices)
        self._slots: List[Any] = [None] * self.n
        self._links: List[Any] = [None] * self.n
        if self.n > 1:
            self._reduce_bar = threading.Barrier(self.n, action=self._sum)
            self._link_bar = threading.Barrier(self.n)

    def _sum(self) -> None:
        torch.cuda.nccl.all_reduce(self._slots)

    def all_reduce(self, t: torch.Tensor, i: int) -> torch.Tensor:
        if self.n == 1:
            return t
        self._slots[i] = t.contiguous()
        self._reduce_bar.wait()
        return self._slots[i]

    def gather_links(self, la: torch.Tensor, lb: torch.Tensor, i: int):
        if self.n == 1:
            return la, lb
        self._links[i] = (la, lb)
        self._link_bar.wait()
        if i > 0:
            return la[:0], lb[:0]
        dev = self.devices[0]
        return (torch.cat([x.to(dev) for x, _ in self._links]),
                torch.cat([y.to(dev) for _, y in self._links]))

    def abort(self) -> None:
        if self.n > 1:
            self._reduce_bar.abort()
            self._link_bar.abort()


def _run_part(i: int, part: _Part, coll: _Collective, n_r: int,
              schedule: PeelSchedule, cap_rounds: int, hierarchy: bool,
              cap: Optional[int], stats: Dict[str, Any]):
    """One distinct device's engine: its slabs' segment-sum decrements,
    reduced across the mesh (float16 with a residual when ``cap`` is
    set)."""
    dev = part.device

    def scatter(dead_now):
        dead = dead_now.to(INT)
        return torch.stack([
            segment_sum(torch.index_select(dead, 0, sids)[:, None], rids,
                        n_r)[:, 0]
            for rids, sids in part.plans])

    if cap is None:
        def reduce_delta(partials, resid):
            return coll.all_reduce(partials.sum(dim=0, dtype=INT), i), resid
        resid0 = None
    else:
        def reduce_delta(partials, resid):
            res = resid[0]
            if partials is None:
                if i == 0:
                    stats["drain_steps"] += 1
                total = res
            else:
                total = partials + res
            sent = torch.clamp(total, max=cap)
            res = total - sent
            kept = (res > 0).any(dim=1).sum(dtype=INT)
            payload = torch.cat([sent.sum(dim=0, dtype=INT), kept[None]])
            payload = coll.all_reduce(payload.to(torch.float16), i)
            return payload[:-1].to(INT), (res, payload[-1].to(INT))
        resid0 = (torch.zeros((len(part.slabs), n_r), dtype=INT, device=dev),
                  torch.zeros((), dtype=INT, device=dev))

    with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
        return run_peel_engine(
            part.inc, part.deg0, schedule, max_rounds=cap_rounds,
            scatter=scatter, hierarchy=hierarchy, reduce_delta=reduce_delta,
            resid0=resid0,
            gather_links=lambda la, lb: coll.gather_links(la, lb, i))


def sharded_decomposition(problem: NucleusProblem, mesh: Mesh,
                          kind: str = "exact", delta: float = 0.1,
                          max_rounds: Optional[int] = None,
                          compress: bool = False, hierarchy: bool = False,
                          stats: Optional[Dict[str, Any]] = None):
    """Run the sharded decomposition of ``problem`` over ``mesh``.

    Returns (core, rounds); with hierarchy=True, (core, rounds, parent, L,
    peel_value): the fused join forest, identical to the single-device
    fused forest, and the raw (unclipped) peel values it was built over.
    At approx, ``core`` is clipped to ``deg0`` (the paper's practical
    tightening) and ``peel_value`` keeps the raw value.  Arrays are host
    numpy, ``rounds`` a Python int.  ``stats``, when given, is filled with
    the run's ``slabs``, ``devices``, ``collective`` (``"nccl"`` or
    ``"local"``) and ``drain_steps``.
    """
    mesh = mesh if isinstance(mesh, Mesh) else Mesh(mesh)
    k = len(mesh)
    cap = None
    if compress:
        cap = COMPRESS_SUM // k
        if cap < 1:
            raise ValueError(f"compress=True sums float16 partials of at "
                             f"most {COMPRESS_SUM}, which needs at most "
                             f"{COMPRESS_SUM} slabs; the mesh has {k}")
    schedule = PeelSchedule(kind=kind, s_choose_r=comb(problem.s, problem.r),
                            delta=delta, n=problem.g.n)
    cap_rounds = max_rounds if max_rounds is not None else problem.n_r + 2
    parts = _partition(problem, mesh)
    coll = _Collective(mesh.distinct())
    run = {"slabs": k, "devices": coll.n,
           "collective": "nccl" if coll.n > 1 else "local",
           "drain_steps": 0}
    args = (coll, problem.n_r, schedule, cap_rounds, hierarchy, cap, run)
    if coll.n == 1:
        out = _run_part(0, parts[0], *args)
    else:
        out = _run_threads(parts, coll, args)
    if stats is not None:
        stats.update(run)
    raw = out[0].cpu().numpy()
    core = raw
    if kind == "approx":  # practical tightening (paper §6)
        core = np.minimum(raw, problem.deg0.cpu().numpy())
    if hierarchy:
        return core, int(out[2]), out[3].cpu().numpy(), \
            out[4].cpu().numpy(), raw
    return core, int(out[2])


def _run_threads(parts: List[_Part], coll: _Collective, args):
    """One engine thread per distinct device; the first device's result.
    The first exception of any thread breaks the barriers and is
    re-raised here."""
    results: List[Any] = [None] * len(parts)
    errors: List[BaseException] = []

    def work(i):
        try:
            results[i] = _run_part(i, parts[i], *args)
        except BaseException as e:  # re-raised below, never swallowed
            errors.append(e)
            coll.abort()

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(parts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        real = [e for e in errors
                if not isinstance(e, threading.BrokenBarrierError)]
        raise (real or errors)[0]
    return results[0]
