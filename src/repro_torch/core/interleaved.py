"""Interleaved hierarchy construction — ANH-EL (paper Alg. 3 + Alg. 5).

Counterpart of ``repro.core.interleaved``.  LINK-EFFICIENT maintains,
while peeling, a same-core union-find ``parent`` and per component root
the nearest enclosing lower core ``L``.  Two routes build that state:

  * **fused**: the peel engine's own ``engine.round_links`` +
    ``engine.link_fixpoint`` on the device; ``link_state_from_forest``
    adapts the returned forest;
  * **replay**: ``replay_trace`` rebuilds every round's peeled set from
    the recorded trace (``order_round``, ``peel_value``) and runs the
    batched fixpoint ``LinkState.process_links`` on the host, round by
    round.  This is host numpy code copied from the reference (the oracle
    path; it also gives the gather backend its forest), and it counts the
    links and unions it processed (``stats_links``/``stats_unions``).

Both give the same forest (the fixpoint depends only on the link multiset,
DESIGN.md §5).  ``construct_tree_efficient`` (Alg. 5, lines 28-36) turns
either into a ``HierarchyTree``.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from .hierarchy import HierarchyTree
from .incidence import NucleusProblem
from .peel import PeelResult, approx_coreness, exact_coreness


def _resolve(parent: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Vectorized find: chase parent pointers to roots."""
    x = x.copy()
    while True:
        p = parent[x]
        if (p == x).all():
            return x
        x = p


@dataclasses.dataclass
class LinkState:
    """The two arrays of LINK-EFFICIENT: uf parents + nearest-core table L."""

    parent: np.ndarray  # (n_r,) int64 — same-core union-find
    L: np.ndarray       # (n_r,) int64 — nearest lower core per root, -1 empty
    core: np.ndarray    # (n_r,) int64 — final core numbers of peeled cliques
    stats_links: int = 0
    stats_unions: int = 0

    @classmethod
    def create(cls, n_r: int) -> "LinkState":
        return cls(parent=np.arange(n_r, dtype=np.int64),
                   L=np.full(n_r, -1, np.int64),
                   core=np.zeros(n_r, np.int64))

    # -- batched LINK-EFFICIENT -------------------------------------------
    def process_links(self, a: np.ndarray, b: np.ndarray,
                      max_gens: int = 10_000) -> None:
        """Fixpoint over the link worklist; (a, b) need no core ordering."""
        core, parent, L = self.core, self.parent, self.L
        gens = 0
        while a.shape[0]:
            gens += 1
            if gens > max_gens:  # pragma: no cover - termination guard
                raise RuntimeError("LINK fixpoint did not converge")
            self.stats_links += int(a.shape[0])
            a = _resolve(parent, a)
            b = _resolve(parent, b)
            # orient: core[a] <= core[b]
            swap = core[a] > core[b]
            a2 = np.where(swap, b, a)
            b2 = np.where(swap, a, b)
            a, b = a2, b2
            keep = a != b
            a, b = a[keep], b[keep]
            if a.shape[0] == 0:
                return
            eq = core[a] == core[b]
            next_a: list[np.ndarray] = []
            next_b: list[np.ndarray] = []
            if eq.any():
                ea, eb = a[eq], b[eq]
                # batched union by min-root hooking to a fixpoint
                old_roots = np.unique(np.concatenate([ea, eb]))
                while True:
                    ra, rb = _resolve(parent, ea), _resolve(parent, eb)
                    m = np.minimum(ra, rb)
                    if (ra == rb).all():
                        break
                    np.minimum.at(parent, ra, m)
                    np.minimum.at(parent, rb, m)
                self.stats_unions += int(ea.shape[0])
                new_roots = _resolve(parent, old_roots)
                changed = new_roots != old_roots
                # losers hand their L to the new root via a fresh link pair
                losers = old_roots[changed]
                lvals = L[losers]
                has = lvals >= 0
                next_a.append(lvals[has])
                next_b.append(new_roots[changed][has])
                L[losers] = -1
            lt = ~eq
            if lt.any():
                la, lb = a[lt], b[lt]
                lb = _resolve(parent, lb)  # roots may have moved in eq step
                la = _resolve(parent, la)
                # candidates for L[lb]: the incoming la's plus the current L
                tgt = np.unique(lb)
                cur = L[tgt]
                curhas = cur >= 0
                cand_t = np.concatenate([lb, tgt[curhas]])
                cand_v = np.concatenate([la, cur[curhas]])
                # winner per target = argmax core (ties -> min id)
                o = np.lexsort((cand_v, -core[cand_v], cand_t))
                ct, cv = cand_t[o], cand_v[o]
                first = np.concatenate([[True], ct[1:] != ct[:-1]])
                winners = cv[first]
                L[ct[first]] = winners
                # every non-winner candidate links against its target's winner
                lose = ~first
                if lose.any():
                    lt_t, lt_v = ct[lose], cv[lose]
                    slot = np.searchsorted(ct[first], lt_t)
                    wv = winners[slot]
                    k2 = lt_v != wv  # drop exact duplicates of the winner
                    next_a.append(lt_v[k2])
                    next_b.append(wv[k2])
            a = np.concatenate(next_a) if next_a else np.zeros(0, np.int64)
            b = np.concatenate(next_b) if next_b else np.zeros(0, np.int64)


def _round_links(problem: NucleusProblem, a_ids: np.ndarray,
                 last_peeled: np.ndarray, mem_off: np.ndarray,
                 mem_sid: np.ndarray, inc: np.ndarray, peeled: np.ndarray):
    """Chain-reduced link pairs for one peel round.

    Per incident s-clique S: connect A ∩ S as a chain and hook its head to the
    most recently peeled member of S (which has the max core among previously
    peeled members — peel values are monotone over rounds).
    """
    if a_ids.shape[0] == 0:
        return (np.zeros(0, np.int64),) * 2, last_peeled
    # all s-cliques incident to the peeled set (deduped)
    counts = mem_off[a_ids + 1] - mem_off[a_ids]
    sids = np.concatenate([mem_sid[mem_off[i]:mem_off[i + 1]] for i in a_ids]) \
        if counts.sum() else np.zeros(0, np.int64)
    sids = np.unique(sids)
    if sids.shape[0] == 0:
        return (np.zeros(0, np.int64),) * 2, last_peeled
    members = inc[sids]                      # (S, C)
    in_a = np.zeros(peeled.shape[0], bool)
    in_a[a_ids] = True
    am = in_a[members]                       # (S, C) members in this round's A
    # chain within A∩S: sort each row so A-members are leading, link consecutive
    order = np.argsort(~am, axis=1, kind="stable")
    mem_sorted = np.take_along_axis(members, order, axis=1)
    am_sorted = np.take_along_axis(am, order, axis=1)
    cnt = am_sorted.sum(axis=1)
    u_chain = mem_sorted[:, :-1][am_sorted[:, 1:]]
    v_chain = mem_sorted[:, 1:][am_sorted[:, 1:]]
    # head of each chain hooks to the previous representative of S (if any)
    head = mem_sorted[:, 0]
    prev = last_peeled[sids]
    hhas = (prev >= 0) & (cnt > 0)
    u_head, v_head = prev[hhas], head[hhas]
    # update last-peeled representative
    upd = cnt > 0
    last_peeled[sids[upd]] = head[upd]
    a = np.concatenate([u_chain.astype(np.int64), u_head.astype(np.int64)])
    b = np.concatenate([v_chain.astype(np.int64), v_head.astype(np.int64)])
    return (a, b), last_peeled


def link_state_from_forest(peel_value, uf_parent, uf_L) -> LinkState:
    """Adapt the engine's join forest (parent resolved, L) plus the raw
    peel values to the ``LinkState`` the tree post-pass consumes."""
    return LinkState(parent=np.asarray(uf_parent).astype(np.int64),
                     L=np.asarray(uf_L).astype(np.int64),
                     core=np.asarray(peel_value).astype(np.int64))


def construct_tree_efficient(problem, state: LinkState) -> HierarchyTree:
    """CONSTRUCT-TREE-EFFICIENT (Alg. 5, Lines 28–36), fully batched.

    ``problem`` is anything with an ``n_r`` attribute.
    """
    n_r = problem.n_r
    parent_uf = _resolve(state.parent, np.arange(n_r, dtype=np.int64))
    core = state.core
    cap = 2 * max(n_r, 1)
    parent = np.full(cap, -1, np.int64)
    level = np.zeros(cap, np.int64)
    level[:n_r] = core
    next_id = n_r
    # one internal node per multi-member uf component
    roots, counts = np.unique(parent_uf, return_counts=True)
    multi = counts >= 2
    node_of = np.arange(n_r, dtype=np.int64)  # root -> representing tree node
    n_new = int(multi.sum())
    ids = next_id + np.arange(n_new)
    node_of[roots[multi]] = ids
    level[ids] = core[roots[multi]]
    # leaves of multi components point at their component node
    comp_node = node_of[parent_uf]
    is_multi_leaf = comp_node != np.arange(n_r)
    parent[:n_r][is_multi_leaf] = comp_node[is_multi_leaf]
    next_id += n_new
    # hook each component to its nearest enclosing core via L
    lvals = state.L[roots]
    has = lvals >= 0
    tgt_roots = _resolve(state.parent, lvals[has])
    parent[node_of[roots[has]]] = node_of[tgt_roots]
    return HierarchyTree(n_leaves=n_r, parent=parent[:next_id].copy(),
                         level=level[:next_id].copy())


@dataclasses.dataclass
class InterleavedResult:
    core: torch.Tensor
    tree: HierarchyTree
    rounds: int
    state: LinkState


def _host64(t) -> np.ndarray:
    """A host int64 copy of a tensor or array."""
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    return np.asarray(t).astype(np.int64)


def replay_trace(problem: NucleusProblem, res: PeelResult) -> LinkState:
    """Run LINK-EFFICIENT over the recorded peel trace.

    The trace (order_round, peel_value) determines every round's peeled set
    A_t = {i : order_round[i] == t} and the bucket value each clique was
    assigned.  One stable argsort groups cliques by round, then the replay
    feeds ``_round_links``/``process_links`` round by round, on the host.
    """
    n_r, n_s = problem.n_r, problem.n_s
    state = LinkState.create(n_r)
    mem_off = _host64(problem.mem_offsets)
    mem_sid = _host64(problem.mem_sids)
    inc = _host64(problem.inc_rid)
    last_peeled = np.full(n_s, -1, np.int64)
    peeled_np = np.zeros(n_r, bool)
    order = _host64(res.order_round)
    value = _host64(res.peel_value)
    ids = np.nonzero(order >= 0)[0]
    ids = ids[np.argsort(order[ids], kind="stable")].astype(np.int64)
    bounds = np.searchsorted(order[ids], np.arange(int(res.rounds) + 1))
    for t in range(int(res.rounds)):
        a_ids = ids[bounds[t]:bounds[t + 1]]
        if a_ids.shape[0] == 0:
            continue
        state.core[a_ids] = value[a_ids]
        peeled_np[a_ids] = True
        (a, b), last_peeled = _round_links(
            problem, a_ids, last_peeled, mem_off, mem_sid, inc, peeled_np)
        state.process_links(a, b)
    return state


def forest_from_trace(problem: NucleusProblem, res: PeelResult):
    """The join forest from the recorded peel trace: ``replay_trace``,
    then each r-clique's resolved root.  Returns ``(uf_parent, uf_L,
    (links, unions))`` with the forest as host int64 arrays, the same
    forest the fused path records in its loop."""
    state = replay_trace(problem, res)
    parent = _resolve(state.parent, np.arange(problem.n_r, dtype=np.int64))
    return parent, state.L.copy(), (state.stats_links, state.stats_unions)


def build_hierarchy_interleaved(problem: NucleusProblem, mode: str = "exact",
                                delta: float = 0.1, backend: str = "dense",
                                link: str = "replay", *,
                                device=None) -> InterleavedResult:
    """ANH-EL: one peel pass (trace recorded), the LINK state, one tree
    post-pass.

    link="replay" rebuilds uf/L on the host from the recorded trace (the
    oracle path); link="fused" runs the LINK fixpoint inside the dense
    engine's loop.  Both give identical forests; with backend="gather" the
    fused request falls back to the replay (there is no engine loop to
    fuse into)."""
    peel = (exact_coreness if mode == "exact"
            else partial(approx_coreness, delta=delta))
    if link == "fused" and backend == "dense":
        # the forest (like the replay) is built over the unclipped bucket
        # values; res.core carries the clipped estimates
        res: PeelResult = peel(problem, backend=backend, hierarchy=True,
                               device=device)
        state = link_state_from_forest(res.peel_value.cpu().numpy(),
                                       res.uf_parent.cpu().numpy(),
                                       res.uf_L.cpu().numpy())
    else:
        res = peel(problem, backend=backend, device=device)
        state = replay_trace(problem, res)
    tree = construct_tree_efficient(problem, state)
    return InterleavedResult(core=res.core, tree=tree, rounds=res.rounds,
                             state=state)
