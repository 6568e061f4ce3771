"""The peel engine: one peel-round body, driven round by round.

Counterpart of ``repro.core.engine``.  ``peel_round`` is the one
implementation of a peel round and ``run_peel_engine`` drives it to the
fixpoint, recording the peel trace (``order_round`` and the raw bucket
value ``core`` of every r-clique).  With ``hierarchy=True`` the ANH-EL link
state (same-core union-find ``parent``, nearest-lower-core table ``L``,
per-s-clique ``last_peeled``) rides along: each round emits its
chain-reduced links (``round_links``) and converges them
(``link_fixpoint``), so one call returns coreness and the join forest.

The reference runs the whole peel as one ``lax.while_loop``.  This port
drives it from the host: one ``.item()`` sync per round (the minimum live
degree, which also ends the loop) and one per ``link_fixpoint`` generation
and per union-find sweep.  Removing those syncs (CUDA graphs or an
on-device done flag) is ROADMAP Queue 1.8.

Round bodies, as in the reference's ``_dense_engine``:

  * kernel, plan <= MEGAKERNEL_PLAN_BUDGET_BYTES: the peel-round megakernel
    (``kernels.peel_round.fused_peel_round``) replaces the whole select +
    dead-s-clique gather + decrement chain, one launch per round;
  * kernel, plan over budget: the plain select and gather, then the
    sorted-segment-sum kernel (``kernels.segment_sum``) as the decrement;
  * no kernel: plain torch throughout (``scatter_decrement``).

On CPU tensors the kernel wrappers run their plain versions, so all three
bodies also run on the CPU; they give identical results.

The link worklists are compacted: only valid links are materialized, where
the reference carries fixed-size arrays with a validity mask.  The result
is the same, because ``link_fixpoint``'s result depends only on the link
multiset, not on slot order (DESIGN.md section 5).
"""
from __future__ import annotations

from math import comb
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph.container import INT
from ..graph.unionfind import uf_union_edges
from ..kernels.peel_round import PEELED, fused_peel_round, peel_key
from ..kernels.segment_sum import segment_sum
from .incidence import NucleusProblem
from .schedule import PeelSchedule

BIG = int(np.iinfo(np.int32).max)

# Plan-memory ceiling for the round megakernel: the per-edge member matrix
# is E * C int32 with E = n_s * C.  Past it the segment-sum path (plan =
# 2 * E int32) takes over.  Same constant and rule as the reference, so the
# same problems take the same kernel.
MEGAKERNEL_PLAN_BUDGET_BYTES = 1 << 29


def make_schedule(problem: NucleusProblem, kind: str,
                  delta: float = 0.1) -> PeelSchedule:
    return PeelSchedule(kind=kind, s_choose_r=comb(problem.s, problem.r),
                        delta=delta, n=problem.g.n)


def scatter_decrement(inc_rid: torch.Tensor, dead_now: torch.Tensor,
                      n_r: int) -> torch.Tensor:
    """delta[r] = # of s-cliques dying this round that contain r.

    The plain formulation (``index_add_``).  Rows with negative ids never
    contribute.
    """
    members = torch.clamp(inc_rid, 0, n_r - 1).reshape(-1).long()
    valid = ((inc_rid >= 0) & dead_now[:, None]).reshape(-1).to(INT)
    delta = torch.zeros((n_r,), dtype=INT, device=inc_rid.device)
    return delta.index_add_(0, members, valid)


# ---------------------------------------------------------------------------
# ANH-EL link state: per-round link generation + the batched LINK fixpoint.
# ---------------------------------------------------------------------------

def round_links(inc_rid: torch.Tensor, a_mask: torch.Tensor,
                last_peeled: torch.Tensor):
    """Chain-reduced ANH-EL links of one peel round.

    Per s-clique row with members peeled this round (A ∩ S): those members
    are moved to the front by a stable sort and linked consecutively, and
    the chain head also hooks to the s-clique's previously peeled
    representative.  Returns ``(la, lb, last_peeled)`` holding only the
    valid links (the reference's ``(la, lb, lvalid)`` restricted to
    ``lvalid``); ``last_peeled`` is updated in place and returned.
    """
    n_r = a_mask.shape[0]
    am = (inc_rid >= 0) & a_mask[torch.clamp(inc_rid, 0, n_r - 1).long()]
    rows = torch.nonzero(am.any(dim=1)).squeeze(1)
    if rows.numel() == 0:
        empty = torch.zeros((0,), dtype=INT, device=inc_rid.device)
        return empty, empty, last_peeled
    mem, am = inc_rid[rows], am[rows]
    order = torch.argsort((~am).to(torch.uint8), dim=1, stable=True)
    mem_s = torch.gather(mem, 1, order)
    am_s = torch.gather(am, 1, order)
    chain = am_s[:, 1:]
    # every selected row has an A-member, so its head is one
    head = mem_s[:, 0]
    prev = last_peeled[rows]
    has_prev = prev >= 0
    la = torch.cat([mem_s[:, :-1][chain], prev[has_prev]])
    lb = torch.cat([mem_s[:, 1:][chain], head[has_prev]])
    last_peeled[rows] = head
    return la, lb, last_peeled


def _union_roots(parent: torch.Tensor, ra: torch.Tensor, rb: torch.Tensor):
    """``uf_union_edges(parent, ra, rb)`` for links between ROOTS of a fully
    resolved forest, touching only the roots involved.

    The merged sets' new root is their minimum root, as min-hooking gives,
    so the result is the same forest.  Connectivity runs on the k involved
    roots only; the forest is then relabelled with one gather.  Returns the
    new parent and the roots absorbed (no longer roots).
    """
    nodes, inv = torch.unique(torch.cat([ra, rb]), return_inverse=True)
    n_links = int(ra.shape[0])
    # nodes ascend, so a component's minimum local index is its minimum root
    fresh = torch.arange(nodes.shape[0], dtype=INT, device=parent.device)
    local = uf_union_edges(fresh, inv[:n_links], inv[n_links:])
    new_root = nodes[local.long()]
    absorbed = new_root != nodes
    remap = torch.arange(parent.shape[0], dtype=INT, device=parent.device)
    remap[nodes[absorbed].long()] = new_root[absorbed]
    return remap[parent.long()], nodes[absorbed]


def link_fixpoint(parent: torch.Tensor, L: torch.Tensor, core: torch.Tensor,
                  la: torch.Tensor, lb: torch.Tensor, *, max_gens: int):
    """Batched LINK-EFFICIENT fixpoint over one round's links.

    Each generation (a few host syncs: worklist compactions)

      1. resolves + orients every link so core[a] <= core[b];
      2. unions same-core links with min-hooking, keeping ``parent`` fully
         resolved;
      3. roots absorbed by the union hand their L off as a fresh link;
      4. lower-core links compete for L[target] by (max core, min id); every
         losing candidate re-links against the winner, and the ousted
         previous L re-links from one winning link.

    Min-hooking and the (max core, min id) rule are confluent, so the final
    (parent, L) depends only on the link multiset: it equals the
    reference's ``link_fixpoint`` and its host replay.  Work per generation
    is over the links and the roots they touch, plus one relabelling pass
    over the forest when a union happened: the reference's fixed-shape
    passes over every r-clique are restricted to where they can change
    anything (only roots carry an L, and only targets can take a new one).
    ``max_gens`` is a safety cap that a terminating fixpoint never reaches.
    ``L`` is updated in place (the engine owns it) and returned.
    """
    wa, wb = la, lb
    gen = 0
    while gen < max_gens and wa.numel() > 0:
        # resolve (parent is fully resolved: one gather) and orient
        a, b = parent[wa.long()], parent[wb.long()]
        swap = core[a.long()] > core[b.long()]
        a, b = torch.where(swap, b, a), torch.where(swap, a, b)
        keep = a != b
        a, b = a[keep], b[keep]
        eq = core[a.long()] == core[b.long()]
        hand_a = hand_b = a[:0]
        # -- same-core union; absorbed roots hand their L to the new root
        if bool(eq.any()):
            parent, absorbed = _union_roots(parent, a[eq], b[eq])
            lost = absorbed[L[absorbed.long()] >= 0].long()
            hand_a, hand_b = L[lost], parent[lost]
            L[lost] = -1
        # -- lower-core links install into L[target] by (max core, min id)
        lt = ~eq
        cv, tgt = parent[a[lt].long()], parent[b[lt].long()]
        if cv.numel() == 0:
            wa, wb = hand_a, hand_b
            gen += 1
            continue
        targets, tloc = torch.unique(tgt, return_inverse=True)
        n_t = int(targets.shape[0])
        L_t = L[targets.long()]
        has_t = L_t >= 0
        core_Lt = core[torch.clamp(L_t, min=0).long()]
        core_cv = core[cv.long()]
        best_core = torch.full((n_t,), -1, dtype=INT, device=cv.device)
        best_core = best_core.scatter_reduce(0, tloc, core_cv, "amax",
                                             include_self=True)
        best_core = torch.where(has_t, torch.maximum(best_core, core_Lt),
                                best_core)
        is_best = core_cv == best_core[tloc]
        old_best = has_t & (core_Lt == best_core)
        best_id = torch.full((n_t,), BIG, dtype=INT, device=cv.device)
        best_id = best_id.scatter_reduce(0, tloc[is_best], cv[is_best],
                                         "amin", include_self=True)
        best_id = torch.where(old_best, torch.minimum(best_id, L_t), best_id)
        # -- successors: losing candidates re-link against their winner;
        # one winning link per target (the lowest index) re-links the
        # ousted previous L
        w_t = best_id[tloc]
        is_win = cv == w_t
        K = int(cv.shape[0])
        idx = torch.arange(K, device=cv.device)
        rep = torch.full((n_t,), K, dtype=torch.int64, device=cv.device)
        rep = rep.scatter_reduce(0, tloc[is_win], idx[is_win], "amin",
                                 include_self=True)
        host = is_win & (idx == rep[tloc])
        succ_a = torch.where(host, L_t[tloc], cv)
        succ_v = (succ_a >= 0) & (succ_a != w_t)
        L[targets.long()] = best_id  # every target has a candidate link
        wa = torch.cat([succ_a[succ_v], hand_a])
        wb = torch.cat([w_t[succ_v], hand_b])
        gen += 1
    return parent, L


# ---------------------------------------------------------------------------
# Restartable local convergence (DESIGN.md §10): the h-operator Jacobi sweep
# the streaming update runs over an affected subproblem.  It starts from a
# caller-provided value state and iterates DOWNWARD to the largest fixpoint
# below it: the exact core values whenever the seed dominates them pointwise
# and the frozen boundary carries its true values.
# ---------------------------------------------------------------------------

def h_index_segments(vals: torch.Tensor, owner: torch.Tensor,
                     n_seg: int) -> torch.Tensor:
    """Per-segment h-index: for each s in [0, n_seg), the largest h with
    >= h of the ``vals[owner == s]`` >= h (0 for an empty segment).

    Negative entries never count.  One sort by (owner, value descending),
    then the k-th value of its segment counts toward h = k."""
    dev = vals.device
    if vals.numel() == 0:
        return torch.zeros((n_seg,), dtype=INT, device=dev)
    own = owner.long()
    key = (own << 32) | (BIG - vals.long())
    order = torch.argsort(key)
    own_s = own[order]
    start = torch.zeros((n_seg + 1,), dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(torch.bincount(own, minlength=n_seg), 0)
    rank = torch.arange(1, own.numel() + 1, device=dev) - start[own_s]
    h = torch.where(vals.long()[order] >= rank, rank, 0)
    out = torch.zeros((n_seg,), dtype=torch.int64, device=dev)
    return out.scatter_reduce_(0, own_s, h, "amax").to(INT)


def h_index_rows(vals: torch.Tensor) -> torch.Tensor:
    """Row-wise h-index of an (m, d) matrix: the largest h with >= h
    entries >= h.  Negative entries are padding and never count."""
    m, d = int(vals.shape[0]), int(vals.shape[1])
    rows = torch.arange(m, device=vals.device).repeat_interleave(d)
    return h_index_segments(vals.reshape(-1), rows, m)


def _sweep_to_fixpoint(theta: Callable, vals0: torch.Tensor,
                       frozen: torch.Tensor, max_sweeps: int):
    """f <- min(f, theta(f)) on the non-frozen entries until a sweep changes
    nothing or ``max_sweeps`` sweeps ran (one host sync per sweep)."""
    vals, sweeps = vals0, 0
    while sweeps < max_sweeps:
        new = torch.where(frozen, vals, torch.minimum(vals, theta(vals)))
        sweeps += 1
        done = bool(torch.equal(new, vals))
        vals = new
        if done:
            break
    return vals, sweeps


def local_converge(inc_sub: torch.Tensor, owner: torch.Tensor,
                   slots: torch.Tensor, vals0: torch.Tensor,
                   frozen: torch.Tensor, max_sweeps: int):
    """Restartable-from-state h-operator iteration over a subproblem.

    One Jacobi sweep computes, for every r-clique i of the subproblem,
    Theta(f)[i] = h-index over { min_{j in S, j != i} f[j] : S an incident
    s-clique }, then applies f <- min(f, Theta(f)) on the non-frozen
    entries; the loop runs until a sweep changes nothing.  Theta is
    monotone, so the iteration converges to the largest fixpoint below the
    seed (Tarski).

    inc_sub:      (rows, C) member indices into the subproblem's r-clique
                  space (-1 entries never count).
    owner, slots: (E,) pairs: r-clique ``owner[k]`` owns the incidence
                  slot ``slots[k]`` of ``inc_sub.reshape(-1)``.  The
                  reference pads these lists to an (m, d) matrix, a jit
                  shape class; at power-law degrees that matrix is m·dmax
                  cells, so the port takes the pairs as they are.
    vals0:        (m,) int32 seed values; frozen entries are boundary state.
    max_sweeps:   safety cap (each productive sweep lowers the integer
                  total by >= 1, so sum(seed) + 2 always suffices).

    Plain torch on the tensors' device (the reference's ``jnp`` sweep; no
    kernel backs it).  Returns (vals, sweeps) with sweeps a Python int.
    """
    m = int(vals0.shape[0])
    C = int(inc_sub.shape[1])
    colv = torch.arange(C, dtype=torch.int64, device=inc_sub.device)[None, :]
    valid = inc_sub >= 0
    members = torch.clamp(inc_sub, 0, max(m - 1, 0)).long()
    slots = slots.long()

    def theta(vals):
        va = torch.where(valid, vals[members], BIG)
        m1 = va.amin(dim=1)
        at_min = colv == torch.argmin(va, dim=1)[:, None]
        m2 = torch.where(at_min, BIG, va).amin(dim=1)
        # min over the OTHER members: the argmin column sees the
        # second-smallest, every other column sees the row minimum
        excl = torch.where(at_min, m2[:, None], m1[:, None])
        rv = torch.where(valid, excl, -1).reshape(-1)
        return h_index_segments(rv[slots], owner, m)

    return _sweep_to_fixpoint(theta, vals0, frozen, int(max_sweeps))


# ---------------------------------------------------------------------------
# The round body and its driver
# ---------------------------------------------------------------------------

def peel_round(inc_rid, deg, key, s_alive, core, order_round, level: int,
               rounds: int, *, scatter: Optional[Callable] = None,
               fused_round: Optional[Callable] = None,
               reduce: Optional[Callable] = None):
    """THE peel-round body, at a level the schedule already chose.

    inc_rid: (n_s, C) member r-clique ids (-1 = ghost padding);
    deg/key/core/order_round: (n_r,) int32, key = ``peel_key(deg, peeled)``
    (PEELED where peeled, else deg); s_alive (n_s,) bool.  Returns (deg,
    key, s_alive, core, order_round, a_mask), where a_mask (bool) is the
    round's peeled set.

    scatter(dead_now) -> (n_r,) delta replaces the decrement (the
    segment-sum kernel path).  fused_round(deg, key, core, order, level,
    rounds) -> (deg, key, core, order) replaces the whole select + gather
    + decrement chain (the megakernel); s_alive then passes through
    untouched, because the megakernel derives liveness from ``key``.
    reduce(delta) -> delta turns the local decrement (any leading shape
    over the r-clique axis) into the global (n_r,) one before it lands:
    the sharded engine's collective.
    """
    n_r = deg.shape[0]
    if fused_round is not None:
        deg, key_new, core, order_round = fused_round(
            deg, key, core, order_round, level, rounds)
        # a live key is its deg, which a round never raises
        return (deg, key_new, s_alive, core, order_round, key_new > key)
    peeled = key == PEELED
    a_mask = (~peeled) & (deg <= level)
    core = torch.where(a_mask, torch.full_like(core, level), core)
    order_round = torch.where(a_mask, torch.full_like(order_round, rounds),
                              order_round)
    peeled = peeled | a_mask
    member_peeled = peeled[torch.clamp(inc_rid, 0, n_r - 1).long()] | \
        (inc_rid < 0)
    dead_now = member_peeled.any(dim=1) & s_alive
    s_alive = s_alive & ~dead_now
    if scatter is None:
        delta = scatter_decrement(inc_rid, dead_now, n_r)
    else:
        delta = scatter(dead_now)
    if reduce is not None:
        # a peeled clique's decrement never lands, so it is not sent
        delta = reduce(torch.where(peeled, 0, delta))
    # peeled cliques keep deg frozen (their core is already assigned)
    deg = torch.where(peeled, deg, deg - delta)
    return deg, peel_key(deg, peeled), s_alive, core, order_round, a_mask


def run_peel_engine(inc_rid: torch.Tensor, deg0: torch.Tensor,
                    schedule: PeelSchedule, *, max_rounds: int,
                    scatter: Optional[Callable] = None,
                    fused_round: Optional[Callable] = None,
                    hierarchy: bool = False,
                    peeled0: Optional[torch.Tensor] = None,
                    reduce_delta: Optional[Callable] = None,
                    resid0=None,
                    gather_links: Optional[Callable] = None):
    """Drive ``peel_round`` to the fixpoint.

    Returns (core, order_round, rounds) — raw bucket values, the peel
    trace, and the round count (a Python int) — plus (parent, L), the
    resolved same-core join forest, when ``hierarchy=True``.  Every round
    peels at least one clique (level >= the minimum live degree), so the
    loop ends within n_r rounds; max_rounds is a safety cap.

    peeled0 marks r-cliques as peeled before round 0: they never enter a
    bucket, never set the minimum, emit no links and keep core/order -1.

    The sharded engine's two hooks, as the reference's (both None on the
    dense path, which they leave unchanged):

      * ``reduce_delta(delta, resid) -> (delta, resid)`` turns the round's
        local decrement into the global one, after the decrement and
        before it lands; ``resid`` is its carry, starting at ``resid0``.
        A carry that is not None is ``(residual, pending)``: ``pending``
        is a 0-dim int32 tensor, nonzero while a residual waits to be
        sent.  The engine reads it in the round's one sync, with the
        minimum key, and while it is set runs *drain steps*,
        ``reduce_delta(None, resid)``: each lands more of the residual,
        peels nothing, keeps the level and is not counted in ``rounds``.
        So a minimum is only taken over fully landed degrees.
      * ``gather_links(la, lb) -> (la, lb)`` turns the round's local links
        into the ones this replica folds, before ``link_fixpoint``; it is
        called every round of a hierarchy run, also with no local rows.
    """
    dev = deg0.device
    n_r = int(deg0.shape[0])
    n_s = int(inc_rid.shape[0])
    core = torch.full((n_r,), -1, dtype=INT, device=dev)
    order = torch.full((n_r,), -1, dtype=INT, device=dev)
    if n_r == 0:
        if hierarchy:
            empty = torch.zeros((0,), dtype=INT, device=dev)
            return core, order, 0, empty, empty
        return core, order, 0
    key = deg0 if peeled0 is None else peel_key(deg0, peeled0.to(dev))
    s_alive = torch.ones((n_s,), dtype=torch.bool, device=dev)
    if hierarchy:
        parent = torch.arange(n_r, dtype=INT, device=dev)
        L = torch.full((n_r,), -1, dtype=INT, device=dev)
        last = torch.full((n_s,), -1, dtype=INT, device=dev)
    # every generation consumes a union (<= n_r - 1 in all), a handoff
    # (<= 1 per node) or a relink whose target core strictly drops, so
    # 3 * n_r generations always suffice; the cap is never binding
    max_gens = 3 * n_r + 4
    deg = deg0
    sched = schedule.init_carry()
    rounds = 0
    reduce = None
    resid = resid0
    if reduce_delta is not None:
        if fused_round is not None:
            raise ValueError("reduce_delta needs the round's decrement; the "
                             "fused round body computes deg itself")

        def reduce(delta):
            nonlocal resid
            delta, resid = reduce_delta(delta, resid)
            return delta
    while rounds < max_rounds:
        # the round's one host sync: the minimum key, which is the minimum
        # live degree, and PEELED exactly when every r-clique is peeled
        # (with a residual carry, the pending flag rides the same sync)
        if resid is None:
            # nucleuslint: disable=NL101 (the round's one sync, ends the loop)
            dmin = int(key.min())
        else:
            # nucleuslint: disable=NL101 (the same sync, with the carry)
            dmin, pending = torch.stack([key.min(), resid[1]]).tolist()
            if pending and dmin != PEELED:
                peeled = key == PEELED
                deg = torch.where(peeled, deg, deg - reduce(None))
                key = peel_key(deg, peeled)
                continue
        if dmin == PEELED:
            break
        sched, level = schedule.next_level(sched, dmin)
        deg, key, s_alive, core, order, a_mask = peel_round(
            inc_rid, deg, key, s_alive, core, order, level, rounds,
            scatter=scatter, fused_round=fused_round, reduce=reduce)
        if hierarchy and (n_s > 0 or gather_links is not None):
            if n_s > 0:
                la, lb, last = round_links(inc_rid, a_mask, last)
            else:
                la = lb = torch.zeros((0,), dtype=INT, device=dev)
            if gather_links is not None:
                la, lb = gather_links(la, lb)
            if la.numel():
                parent, L = link_fixpoint(parent, L, core, la, lb,
                                          max_gens=max_gens)
        rounds += 1
    if hierarchy:
        return core, order, rounds, parent, L
    return core, order, rounds


# ---------------------------------------------------------------------------
# Single-device dense entry: kernel plans + the round-body choice
# ---------------------------------------------------------------------------

def kernel_by_default(dev: torch.device) -> bool:
    """What ``use_kernel=None`` resolves to on `dev`.

    The planner profile's measured verdict when an entry covers the device
    (``planner_profile.kernel_default``), else the static rule: the
    hand-written kernels on CUDA, plain torch on the CPU."""
    from .planner_profile import kernel_default
    v = kernel_default(dev.type, dev.type)
    return dev.type == "cuda" if v is None else v


def _plan_cache(problem: NucleusProblem) -> dict:
    cache = getattr(problem, "_plans", None)
    if cache is None:
        cache = {}
        problem._plans = cache
    return cache


def _plan_rids(problem: NucleusProblem) -> torch.Tensor:
    """The r-clique of every CSR edge, ascending (the reference's ids)."""
    counts = (problem.mem_offsets[1:] - problem.mem_offsets[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(problem.n_r, dtype=INT, device=problem.device), counts,
        output_size=int(problem.mem_sids.shape[0]))


def _plan_arrays(problem: NucleusProblem):
    """(rids, members) of the rid-sorted CSR edge plan, on the problem's
    device: edge k belongs to r-clique ``rids[k]`` and its s-clique's full
    member row is ``members[k]``."""
    members = problem.inc_rid[problem.mem_sids.long()].contiguous()
    return _plan_rids(problem), members


def _round_plan(problem: NucleusProblem):
    """Megakernel plan ``(offsets, members)``, memoized on the problem.

    The CSR offsets give each r-clique its edge range directly, so unlike
    the reference's ``(ids, members)`` plan it needs no padding and no
    per-block chunk windows.
    """
    cache = _plan_cache(problem)
    if "round" not in cache:
        _, members = _plan_arrays(problem)
        cache["round"] = (problem.mem_offsets.contiguous(), members)
    return cache["round"]


def _scatter_plan(problem: NucleusProblem):
    """Segment-sum plan ``(rids, sids)``: edge k is (rids[k], sids[k]) with
    rids ascending, so a round's decrement is the segment sum of
    ``dead_now[sids]`` by ``rids``.  Memoized on the problem."""
    cache = _plan_cache(problem)
    if "scatter" not in cache:
        cache["scatter"] = (_plan_rids(problem),
                            problem.mem_sids.contiguous())
    return cache["scatter"]


def dense_coreness(problem: NucleusProblem, schedule: PeelSchedule, *,
                   device: DeviceLike = None,
                   use_kernel: Optional[bool] = None,
                   hierarchy: bool = False,
                   peeled0: Optional[torch.Tensor] = None,
                   fused_kernel: Optional[bool] = None):
    """(core_raw, order_round, rounds[, parent, L]) for the whole peel.

    ``device=None`` means the card (raising without one; pass
    ``device="cpu"`` for the CPU).  ``use_kernel=None`` means the kernel
    round bodies on CUDA and the plain body on the CPU; ``use_kernel=True``
    on the CPU runs the kernel bodies' plain versions (the resolution is
    ``kernel_by_default``).  With the kernels on,
    the megakernel is the round body while its plan (4 * n_s * C(s,r)^2
    bytes) fits MEGAKERNEL_PLAN_BUDGET_BYTES, else the segment-sum
    decrement; ``fused_kernel=True/False`` forces the choice.  Raw bucket
    values are returned (approx clipping is the caller's job).
    """
    dev = resolve_device(device)
    problem = problem.to(dev)
    if use_kernel is None:
        use_kernel = kernel_by_default(dev)
    n_r = problem.n_r
    scatter = None
    fused_round = None
    if use_kernel and problem.n_s > 0:
        if fused_kernel is None:
            plan_bytes = 4 * problem.n_s * problem.n_sub ** 2
            fused_kernel = plan_bytes <= MEGAKERNEL_PLAN_BUDGET_BYTES
        if fused_kernel:
            offsets, members = _round_plan(problem)

            def fused_round(deg, key, core, order, level, rnd):
                return fused_peel_round(offsets, members, deg, key, core,
                                        order, level, rnd)
        else:
            plan_rids, plan_sids = _scatter_plan(problem)

            def scatter(dead_now):
                # one n_s-long cast, then an int32 gather by the int32 plan:
                # no E-long int64 index or bool pass per round
                data = torch.index_select(dead_now.to(INT), 0, plan_sids)
                return segment_sum(data[:, None], plan_rids, n_r)[:, 0]
    return run_peel_engine(problem.inc_rid, problem.deg0, schedule,
                           max_rounds=n_r + 2, scatter=scatter,
                           fused_round=fused_round, hierarchy=hierarchy,
                           peeled0=peeled0)
