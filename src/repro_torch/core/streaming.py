"""Incremental nucleus maintenance: ``Decomposition.update(GraphDelta)``.

Counterpart of ``repro.core.streaming``.  The decomposition is maintained
under edge inserts and deletes by *local* work (DESIGN.md §10):

  1. **Problem surgery.**  The canonical tables are edited directly: for
     (2, 3) the r-clique table IS the lexsorted edge list, so an edge
     toggle is one ``searchsorted`` row insert/delete plus a vectorized
     rid remap of the incidence rows; new triangles come from the common
     neighborhood of the toggled edge, dead ones straight off the edge's
     mem-CSR row.
  2. **Affected region.**  Only r-cliques connected to the touched
     s-cliques through a path of s-cliques whose old-core bottleneck
     reaches their own old core can change.  The region comes from a
     vectorized max-min label propagation seeded at the touched s-cliques.
  3. **Local convergence.**  Values converge downward from an upper-bound
     seed by the h-operator Jacobi sweep (``engine.local_converge``; at
     (1, 2) ``kcore.kcore_local_converge``) over the extracted subproblem.
     The reference pads it to pow2 shape classes (one executable each);
     the port reports the same classes to the bucket hook but passes the
     per-r-clique lists unpadded, as (owner, value) pairs.
  4. **Forest patch.**  The join forest is a pure function of (core
     values, link multiset), so an insert that creates no s-clique and
     moves no value is a rid relabeling of the resolved forest, and every
     other op re-presents the canonical chain multiset (members of each
     s-clique sorted by core, consecutive pairs linked) in ONE
     ``engine.link_fixpoint`` call.  The reference runs that call after
     each such op; the port runs it once, over the state after the last
     op, which gives the same forest (``update_decomposition``).  Its
     ``uf_L`` can break a tie apart from the fused peel's (the chain
     multiset is not the peel's link stream); ``uf_parent``, the tree and
     every cut are the fused peel's.

Where the work runs.  The surgery, the rise screen and the converge's
subproblem extraction are host numpy, as in the reference, on host mirrors
of the problem's tables (``_HostTables``) that are read off the device once
per problem and carried from op to op.  The mem-CSR is edited in place of
the reference's full re-sort (``_mem_csr``): a new s-clique has the largest
sid, so it appends at the end of its members' rows, and a delete drops
entries and renumbers the later sids; the result is the same (rid, then sid
ascending) grouping.  The region propagation, the local converge and the
forest's link fixpoint run on the problem's device.  There the incidence
rows, the mem-CSR sids and the core values live as ``_DeviceTables``,
patched op by op from the edit's own rows and positions (``_OpEdit``), so
per op only the edit, the seeds, the subproblem and the candidate ids cross
between host and device.  The edited problem is packed from the device
tables at the end of ``update``; only its edge list goes over.

What this costs.  Each op still edits the host mirrors in full (a
``searchsorted`` row insert or delete and a rid shift of every incidence
row), as the reference does, so an op costs time linear in the problem.

``decompose()`` stays the parity oracle: core, peel values, ``uf_parent``,
the tree and the cuts of every update equal a fresh decompose of the
edited graph's, and every array equals the reference's ``update``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..graph.container import INT, Graph
from .engine import BIG, link_fixpoint, local_converge
from .incidence import NucleusProblem
from .kcore import kcore_local_converge

# (r, s) pairs with a problem-surgery implementation: the r-clique table
# must be a cheap function of the edge list (r=1: the vertices; r=2: the
# edge list itself)
SUPPORTED_RS = ((1, 2), (2, 3))

# pow2 pad floors of the local stages (the reference's shape classes; the
# bucket hook reports them so a Session counts warm and cold stages alike)
SUB_FLOOR = 64
DEG_FLOOR = 8

Hook = Optional[Callable[[Tuple], None]]


def _pow2(n: int, floor: int) -> int:
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# The delta type
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """An edge-set change: ``delete`` rows are removed first, then
    ``insert`` rows are added, each applied ONE EDGE AT A TIME (the
    single-edge rise/fall bounds that seed the affected region are
    per-edge facts).

    Rows are (u, v) vertex pairs in either order; self-loops are
    rejected, as are inserts of present edges and deletes of absent ones.
    The vertex set is fixed: deltas change edges, not ``n``.
    """

    insert: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int64))
    delete: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int64))

    def __post_init__(self):
        for name in ("insert", "delete"):
            e = np.asarray(getattr(self, name), np.int64).reshape(-1, 2)
            if e.size and (e[:, 0] == e[:, 1]).any():
                raise ValueError(f"GraphDelta.{name} contains a self-loop")
            lo = np.minimum(e[:, 0], e[:, 1])
            hi = np.maximum(e[:, 0], e[:, 1])
            object.__setattr__(self, name, np.stack([lo, hi], axis=1))

    @property
    def n_ops(self) -> int:
        return int(self.insert.shape[0]) + int(self.delete.shape[0])

    def ops(self) -> Iterator[Tuple[str, int, int]]:
        for u, v in self.delete:
            yield ("delete", int(u), int(v))
        for u, v in self.insert:
            yield ("insert", int(u), int(v))


# ---------------------------------------------------------------------------
# Host mirrors of the problem tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _HostTables:
    """The problem's tables as int64 numpy: what the surgery edits."""

    n: int
    r: int
    s: int
    edges: np.ndarray      # (m, 2) canonical edge list
    r_table: np.ndarray    # (n_r, r); for (2, 3) the edge list itself
    inc: np.ndarray        # (n_s, C)
    off: np.ndarray        # (n_r + 1,) mem-CSR offsets
    msids: np.ndarray      # (n_s * C,) mem-CSR s-clique ids
    deg0: np.ndarray       # (n_r,)

    @property
    def n_r(self) -> int:
        return int(self.r_table.shape[0])

    @property
    def n_s(self) -> int:
        return int(self.inc.shape[0])


def _host_tables(problem: NucleusProblem) -> _HostTables:
    """The problem's host mirror, read off its device once and memoized on
    it (an updated problem carries the mirror it was packed from)."""
    cached = getattr(problem, "_host_tables", None)
    if cached is not None:
        return cached

    def h(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy().astype(np.int64)
    edges = h(problem.g.edges).reshape(-1, 2)
    tables = _HostTables(
        n=int(problem.g.n), r=problem.r, s=problem.s, edges=edges,
        r_table=h(problem.r_cliques).reshape(-1, problem.r),
        inc=h(problem.inc_rid).reshape(-1, problem.n_sub),
        off=h(problem.mem_offsets), msids=h(problem.mem_sids),
        deg0=h(problem.deg0))
    problem._host_tables = tables
    return tables


@dataclasses.dataclass
class _DeviceTables:
    """The tables the device stages read, on the problem's device (int64):
    the incidence rows, the mem-CSR sids and the current core values, in
    the current rid space.  ``deg0`` and the mem-CSR offsets follow from
    the rows (an r-clique's degree is its count in them)."""

    inc: torch.Tensor      # (n_s, C)
    msids: torch.Tensor    # (n_s * C,)
    core: torch.Tensor     # (n_r,)

    @classmethod
    def of(cls, problem: NucleusProblem, core: np.ndarray) -> "_DeviceTables":
        return cls(inc=problem.inc_rid.long(), msids=problem.mem_sids.long(),
                   core=torch.from_numpy(core.copy()).to(problem.device))

    def degrees(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(deg0, mem-CSR offsets)."""
        deg0 = torch.bincount(self.inc.reshape(-1),
                              minlength=int(self.core.shape[0]))
        off = torch.zeros((deg0.shape[0] + 1,), dtype=torch.int64,
                          device=deg0.device)
        torch.cumsum(deg0, 0, out=off[1:])
        return deg0, off

    def patch(self, edit: "_OpEdit", op: str) -> None:
        """Apply one op's edit, as the host surgery applied it."""
        dev = self.inc.device

        def d(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)
        inc, msids, core = self.inc, self.msids, self.core
        if edit.dead.size:
            keep = torch.ones((inc.shape[0],), dtype=torch.bool, device=dev)
            keep[d(edit.dead)] = False
            inc = inc[keep]
            keep = torch.ones((msids.shape[0],), dtype=torch.bool,
                              device=dev)
            keep[d(edit.drop_at)] = False
            msids = msids[keep]
            msids = msids - torch.searchsorted(d(edit.dead), msids)
        if edit.shift_at is not None:
            pos = edit.shift_at
            if op == "insert":
                inc = inc + (inc >= pos).long()
                core = torch.cat([core[:pos], torch.full(
                    (1,), BIG, dtype=core.dtype, device=dev), core[pos:]])
            else:
                inc = inc - (inc > pos).long()
                core = torch.cat([core[:pos], core[pos + 1:]])
        if edit.new_sids.size:
            inc = torch.cat([inc, d(edit.new_rows)])
        if edit.ins_at.size:
            msids = _insert(msids, d(edit.ins_at), d(edit.ins_vals))
        self.inc, self.msids, self.core = inc, msids, core


def _insert(x: torch.Tensor, at: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    """``np.insert(x, at, vals)`` on the device: ``vals[j]`` goes before
    ``x[at[j]]``, equal positions in the order given."""
    k = int(at.shape[0])
    order = torch.argsort(at, stable=True)
    dest = torch.empty_like(at)
    dest[order] = at[order] + torch.arange(k, device=x.device)
    out = torch.empty((x.shape[0] + k,), dtype=x.dtype, device=x.device)
    rest = torch.ones((out.shape[0],), dtype=torch.bool, device=x.device)
    rest[dest] = False
    out[rest] = x
    out[dest] = vals
    return out


def _pack_problem(old: NucleusProblem, t: _HostTables, dt: _DeviceTables
                  ) -> NucleusProblem:
    """The edited tables as a ``NucleusProblem`` on the device: the
    incidence and mem-CSR from the device tables, the edge list (and for
    (1, 2) the vertex table) from the host mirror."""
    device = dt.inc.device

    def d(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    edges = d(t.edges.reshape(-1, 2))
    r_cliques = edges if t.r_table is t.edges else \
        d(t.r_table.reshape(-1, t.r))
    deg0, off = dt.degrees()
    new = NucleusProblem(
        g=Graph(n=t.n, edges=edges), r=t.r, s=t.s, r_cliques=r_cliques,
        inc_rid=dt.inc.to(INT).reshape(-1, old.n_sub), mem_offsets=off.to(INT),
        mem_sids=dt.msids.to(INT), deg0=deg0.to(INT),
        orientation=old.orientation, build_stats={"build": "streaming"})
    new._host_tables = t
    return new


# ---------------------------------------------------------------------------
# Canonical table surgery
# ---------------------------------------------------------------------------

def _edge_keys(edges: np.ndarray) -> np.ndarray:
    e = np.asarray(edges, np.int64)
    return (e[:, 0] << 32) | e[:, 1]


def _apply_edge(t: _HostTables, u: int, v: int,
                op: str) -> Tuple[np.ndarray, int]:
    """Toggle one canonical edge; returns (new edge list, touched row)."""
    if not (0 <= u < v < t.n):
        raise ValueError(f"edge ({u}, {v}) out of range for n={t.n}")
    e = t.edges
    keys = _edge_keys(e)
    pos = int(np.searchsorted(keys, (u << 32) | v))
    present = pos < keys.shape[0] and keys[pos] == ((u << 32) | v)
    if op == "insert":
        if present:
            raise ValueError(f"insert of present edge ({u}, {v})")
        new = np.insert(e, pos, (u, v), axis=0)
    else:
        if not present:
            raise ValueError(f"delete of absent edge ({u}, {v})")
        new = np.delete(e, pos, axis=0)
    return new, pos


def _offsets(deg0: np.ndarray) -> np.ndarray:
    off = np.zeros((deg0.shape[0] + 1,), np.int64)
    np.cumsum(deg0, out=off[1:])
    return off


def _csr_drop(t: _HostTables, dead: np.ndarray, drop_rid: Optional[int]):
    """Mem-CSR and deg0 with the s-cliques ``dead`` (ascending) removed, and
    the r-clique ``drop_rid``, which only they contained: each dead sid
    leaves the rows of its members, and the surviving sids shift down past
    the removed ones, so rows stay sid-ascending.  Also returns the
    removed mem-CSR slots."""
    members = t.inc[dead]                                # (k, C)
    deg0 = t.deg0.copy()
    np.subtract.at(deg0, members.reshape(-1), 1)
    # the entry of dead sid s in the row of member x
    at = [t.off[x] + int(np.searchsorted(t.msids[t.off[x]:t.off[x + 1]],
                                         sid))
          for sid, row in zip(dead.tolist(), members.tolist()) for x in row]
    at = np.asarray(at, np.int64)
    msids = np.delete(t.msids, at)
    msids -= np.searchsorted(dead, msids)   # removed sids below each sid
    if drop_rid is not None:
        deg0 = np.delete(deg0, drop_rid)
    return _offsets(deg0), msids, deg0, at


@dataclasses.dataclass
class _OpEdit:
    """Everything one edge toggle did to the problem tables."""

    tables: _HostTables
    rid_map: Optional[np.ndarray]   # old rid -> new rid; None = identity
    new_rids: np.ndarray            # new-space ids of created r-cliques
    new_sids: np.ndarray            # new-space ids of created s-cliques
    seed_best: np.ndarray           # (n_r_new,) initial bottleneck labels
    # the edit in rows and positions (what ``_DeviceTables.patch`` replays)
    dead: np.ndarray                # removed sids, ascending (old space)
    drop_at: np.ndarray             # removed mem-CSR slots
    new_rows: np.ndarray            # (k, C) appended incidence rows
    ins_at: np.ndarray              # mem-CSR insertions (``np.insert``)
    ins_vals: np.ndarray
    shift_at: Optional[int]         # the inserted / deleted rid (2, 3)


def _edit_12(t: _HostTables, e_new: np.ndarray, u: int, v: int, op: str,
             core_old: np.ndarray) -> _OpEdit:
    """(1, 2): r-cliques are the vertices (rid space fixed), s-cliques the
    edges: one incidence row toggles.  The builder's s-row order is not
    the lexsorted edge order, so rows are located by content; new rows
    append (every output is rid-indexed and the forest is confluent over
    the link multiset)."""
    inc_old = t.inc
    seed_best = np.full((t.n_r,), -1, np.int64)
    none = np.zeros((0,), np.int64)
    if op == "insert":
        sid = t.n_s
        new_rows = np.array([[u, v]], np.int64)
        inc = np.concatenate([inc_old, new_rows])
        new_sids = np.array([sid], np.int64)
        # the new sid is the largest: it ends rows u and v (u < v)
        ins_at = np.array([t.off[u + 1], t.off[v + 1]], np.int64)
        ins_vals = np.array([sid, sid], np.int64)
        msids = np.insert(t.msids, ins_at, ins_vals)
        deg0 = t.deg0.copy()
        deg0[[u, v]] += 1
        off = _offsets(deg0)
        dead = drop_at = none
    else:
        row = int(np.flatnonzero((inc_old[:, 0] == u)
                                 & (inc_old[:, 1] == v))[0])
        # seeds: the dead edge's surviving endpoints, at the dead
        # s-clique's bottleneck under the OLD core values
        seed_best[inc_old[row]] = core_old[inc_old[row]].min()
        dead = np.array([row], np.int64)
        off, msids, deg0, drop_at = _csr_drop(t, dead, None)
        inc = np.delete(inc_old, row, axis=0)
        new_sids = ins_at = ins_vals = none
        new_rows = np.zeros((0, 2), np.int64)
    new = _HostTables(n=t.n, r=t.r, s=t.s, edges=e_new, r_table=t.r_table,
                      inc=inc, off=off, msids=msids, deg0=deg0)
    return _OpEdit(tables=new, rid_map=None, new_rids=none,
                   new_sids=new_sids, seed_best=seed_best, dead=dead,
                   drop_at=drop_at, new_rows=new_rows, ins_at=ins_at,
                   ins_vals=ins_vals, shift_at=None)


def _neighbors(e: np.ndarray, x: int) -> np.ndarray:
    return np.concatenate([e[e[:, 0] == x, 1], e[e[:, 1] == x, 0]])


def _edit_23(t: _HostTables, e_new: np.ndarray, pos: int, op: str,
             u: int, v: int, core_old: np.ndarray) -> _OpEdit:
    """(2, 3): the r-clique table IS the lexsorted edge list; one row
    shifts the rid space by one, and triangles toggle with the edge."""
    inc_old = t.inc
    n_r_old = t.n_r
    if op == "insert":
        rid_map = np.arange(n_r_old, dtype=np.int64)
        rid_map[pos:] += 1
        inc = inc_old + (inc_old >= pos)                 # rid_map[inc_old]
        # every new triangle contains the new edge: enumerate the common
        # neighborhood of its endpoints in the NEW graph
        ws = np.intersect1d(_neighbors(e_new, u), _neighbors(e_new, v))
        rids = np.zeros((0, 3), np.int64)
        if ws.size:
            tris = np.sort(np.stack(
                [np.full(ws.shape, u), np.full(ws.shape, v), ws],
                axis=1), axis=1)
            pairs = np.stack([tris[:, [0, 1]], tris[:, [0, 2]],
                              tris[:, [1, 2]]], axis=1)      # (t, 3, 2)
            rids = np.searchsorted(_edge_keys(e_new), _edge_keys(
                pairs.reshape(-1, 2))).reshape(-1, 3)
            inc = np.concatenate([inc, rids], axis=0)
        new_sids = np.arange(t.n_s, inc.shape[0], dtype=np.int64)
        new_rids = np.array([pos], np.int64)
        # the fresh rid is unconditionally a candidate; its (new) incident
        # s-cliques seed their other members via the new-sid fold
        seed_best = np.full((n_r_old + 1,), -1, np.int64)
        seed_best[pos] = BIG
        # mem-CSR: an empty row at pos, then each new sid (the largest)
        # appended to its members' rows; an insertion point is the end of
        # the member's old row (old rid x for x < pos, x - 1 past it)
        flat = rids.reshape(-1)
        sid_of = np.repeat(new_sids, 3)
        deg0 = np.insert(t.deg0, pos, 0)
        np.add.at(deg0, flat, 1)
        order = np.lexsort((sid_of, flat))
        x, sv = flat[order], sid_of[order]
        at = np.where(x < pos, t.off[np.minimum(x + 1, n_r_old)], t.off[x])
        msids = np.insert(t.msids, at, sv)
        off = _offsets(deg0)
        dead = drop_at = np.zeros((0,), np.int64)
        new_rows, ins_at, ins_vals = rids, at, sv
    else:
        dead = t.msids[t.off[pos]:t.off[pos + 1]]
        rid_map = np.arange(n_r_old, dtype=np.int64)
        rid_map[pos] = -1
        rid_map[pos + 1:] -= 1
        seed_best = np.full((n_r_old - 1,), -1, np.int64)
        if dead.size:
            dead_rows = inc_old[dead]                    # old rid space
            # bottleneck of a dead triangle = min OLD core over ALL its
            # members (the deleted edge included)
            w = core_old[dead_rows].min(axis=1)          # (t,)
            live = rid_map[dead_rows]                    # (t, 3); -1 = e0
            np.maximum.at(seed_best, np.clip(live, 0, None).reshape(-1),
                          np.where(live >= 0, w[:, None], -1).reshape(-1))
        keep = np.ones((inc_old.shape[0],), bool)
        keep[dead] = False
        inc = inc_old[keep]
        inc -= inc > pos                                 # rid_map (no pos)
        off, msids, deg0, drop_at = _csr_drop(t, dead, pos)
        new_rids = new_sids = ins_at = ins_vals = np.zeros((0,), np.int64)
        new_rows = np.zeros((0, 3), np.int64)
    new = _HostTables(n=t.n, r=t.r, s=t.s, edges=e_new, r_table=e_new,
                      inc=inc, off=off, msids=msids, deg0=deg0)
    return _OpEdit(tables=new, rid_map=rid_map, new_rids=new_rids,
                   new_sids=new_sids, seed_best=seed_best,
                   dead=np.asarray(dead, np.int64), drop_at=drop_at,
                   new_rows=new_rows, ins_at=ins_at, ins_vals=ins_vals,
                   shift_at=pos)


# ---------------------------------------------------------------------------
# Affected region: vectorized max-min (bottleneck) label propagation
# ---------------------------------------------------------------------------

def _csr_slots(off: np.ndarray, rids: np.ndarray) -> np.ndarray:
    """The mem-CSR slots of the rows ``rids``, row after row."""
    cnt = off[rids + 1] - off[rids]
    total = int(cnt.sum())
    return np.arange(total, dtype=np.int64) + np.repeat(
        off[rids] - (np.cumsum(cnt) - cnt), cnt)


def _region(dt: _DeviceTables, best0: np.ndarray) -> np.ndarray:
    """The candidates for change: the r-cliques whose largest bottleneck
    label reachable from the seeds reaches their own ``core_u``.

    A label b entering s-clique S leaves as min(b, min over S's members of
    ``core_u``).  Labels only grow; each step is a vectorized scatter-max
    over the frontier's incidence, as in the reference, but on the
    device tables: the labels reach every r-clique connected to a seed
    (the candidates are filtered afterwards), so at (1, 2) on a
    10^6-vertex graph each op sweeps ~2·10^7 incidences 7–8 times.  The
    seeds go over and the candidate ids come back; the frontier's size is
    the one sync per step.
    """
    device = dt.inc.device
    core = dt.core
    seeds = np.flatnonzero(best0 >= 0)
    best = torch.full(core.shape, -1, dtype=torch.int64, device=device)
    best[torch.from_numpy(seeds).to(device)] = \
        torch.from_numpy(best0[seeds]).to(device)
    inc, msids = dt.inc, dt.msids
    _, off = dt.degrees()
    C = inc.shape[1]
    frontier = torch.nonzero(best >= 0).squeeze(1)
    while frontier.numel():
        cnt = off[frontier + 1] - off[frontier]
        total = int(cnt.sum())
        if total == 0:
            break
        idx = torch.arange(total, device=device) + torch.repeat_interleave(
            off[frontier] - (torch.cumsum(cnt, 0) - cnt), cnt,
            output_size=total)
        mem = inc[msids[idx]]                            # (k, C)
        w = torch.repeat_interleave(best[frontier], cnt, output_size=total)
        for c in range(C):
            w = torch.minimum(w, core[mem[:, c]])
        flat = mem.reshape(-1)
        before = best[flat]
        best.scatter_reduce_(0, flat, w[:, None].expand(-1, C).reshape(-1),
                             "amax")
        frontier = torch.unique(flat[best[flat] > before])
    return torch.nonzero((best >= 0) & (best >= core)).squeeze(1).cpu() \
        .numpy()


def _prune_rise(inc: np.ndarray, off: np.ndarray, msids: np.ndarray,
                core_u: np.ndarray, cand: np.ndarray, f0: np.ndarray,
                protect: np.ndarray):
    """Shrink the candidate set before the converge (INSERT ops only).

    A single insert only RAISES cores and ``f0`` bounds every final value
    from above; a candidate whose support count under these bounds cannot
    reach ``core_u + 1`` keeps its old core.  Freezing it lowers the bound
    its neighbors see, so the screen iterates to a fixpoint.  Pure
    screening: whatever it cannot disprove goes to the converge unchanged.
    ``protect`` marks rids that must stay candidates (fresh rids, whose
    ``core_u`` is the BIG sentinel).
    """
    if not cand.any() or not inc.size:
        return cand, f0
    if inc.shape[1] == 2:
        return _prune_rise_pairs(inc, off, msids, core_u, cand, f0, protect)
    cand = cand.copy()
    f0 = f0.copy()
    n_r = core_u.shape[0]
    thr = core_u + 1                       # the level a riser must reach
    # only rows touching a live candidate can change a verdict (read off
    # the candidates' mem-CSR rows), and the set shrinks monotonically as
    # rids freeze
    live = np.unique(msids[_csr_slots(off, np.flatnonzero(cand))])
    for _ in range(64):
        sub = inc[live]
        row_vals = f0[sub]                               # (rows, C)
        part = np.partition(row_vals, 1, axis=1)         # C >= 2 (r < s)
        m1, m2 = part[:, 0], part[:, 1]
        is_min = row_vals == m1[:, None]
        unique_min = is_min.sum(axis=1) == 1
        # min over the OTHER members, per member slot
        others = np.where(is_min & unique_min[:, None],
                          m2[:, None], m1[:, None])
        support = others >= thr[sub]
        cnt = np.zeros((n_r,), np.int64)
        np.add.at(cnt, sub[support], 1)
        newly = cand & ~protect & (cnt < thr)
        if not newly.any():
            break
        cand[newly] = False
        f0[newly] = core_u[newly]
        live = live[cand[sub].any(axis=1)]
    return cand, f0


def _delete_keeps_cores(core_u: np.ndarray, perturbed: np.ndarray,
                        inc: np.ndarray, off: np.ndarray,
                        msids: np.ndarray) -> bool:
    """Exact early-out for DELETE ops: do the old cores survive as-is?

    The cores are the greatest assignment c with c <= theta(c); only the
    members of the removed s-cliques changed incidence, so if every
    perturbed rid still counts >= c(x) incident s-cliques whose other
    members all sit at >= c(x), the old assignment is still the greatest
    fixpoint and the converge is skipped.
    """
    for x in perturbed:
        k = int(core_u[x])
        if k <= 0:
            continue
        sids = msids[off[x]:off[x + 1]]
        if sids.size < k:
            return False
        rows = inc[sids]                                 # (d, C)
        others = np.where(rows == x, BIG, core_u[rows]).min(axis=1)
        if int((others >= k).sum()) < k:
            return False
    return True


def _prune_rise_pairs(inc: np.ndarray, off: np.ndarray, msids: np.ndarray,
                      core_u: np.ndarray, cand: np.ndarray, f0: np.ndarray,
                      protect: np.ndarray):
    """The C == 2 (r1s2) case of the rise screen as a worklist: freezes
    propagate through the incidence CSR (the problem's mem-CSR, where the
    reference re-sorts both endpoint columns per call: the rows a frozen
    rid touches are then deduplicated, so their order is immaterial), and
    a row is revisited only when one of its members drops."""
    cand = cand.copy()
    f0 = f0.copy()
    n_r = core_u.shape[0]
    thr = core_u + 1
    a = inc[:, 0].astype(np.int64)
    b = inc[:, 1].astype(np.int64)
    sup_a = f0[b] >= thr[a]                # row's support for member a
    sup_b = f0[a] >= thr[b]
    cnt = np.zeros((n_r,), np.int64)
    np.add.at(cnt, a[sup_a], 1)
    np.add.at(cnt, b[sup_b], 1)
    # rows incident to each rid: the mem-CSR
    rows_s, starts = msids, off
    kill = np.flatnonzero(cand & ~protect & (cnt < thr))
    while kill.size:
        cand[kill] = False
        f0[kill] = core_u[kill]
        deg = starts[kill + 1] - starts[kill]
        idx = np.repeat(starts[kill], deg) \
            + np.arange(int(deg.sum())) - np.repeat(np.cumsum(deg) - deg, deg)
        tr = np.unique(rows_s[idx])
        new_sa = f0[b[tr]] >= thr[a[tr]]
        new_sb = f0[a[tr]] >= thr[b[tr]]
        drop_a = a[tr][sup_a[tr] & ~new_sa]
        drop_b = b[tr][sup_b[tr] & ~new_sb]
        np.subtract.at(cnt, drop_a, 1)
        np.subtract.at(cnt, drop_b, 1)
        sup_a[tr] = new_sa
        sup_b[tr] = new_sb
        hit = np.unique(np.concatenate([drop_a, drop_b]))
        hit = hit[cand[hit] & ~protect[hit]]
        kill = hit[cnt[hit] < thr[hit]]
    return cand, f0


# ---------------------------------------------------------------------------
# Local convergence over the extracted subproblem (on the device)
# ---------------------------------------------------------------------------

def _converge(t: _HostTables, f0: np.ndarray, cand: np.ndarray, hook: Hook,
              device: torch.device) -> Tuple[np.ndarray, int]:
    """Run the local iteration on ``device``; returns (values, sweeps).

    ``f0`` must dominate the true new core values pointwise on the
    candidate set and carry the exact values elsewhere (frozen ring).
    """
    n_r = f0.shape[0]
    cand_idx = np.flatnonzero(cand)
    if cand_idx.size == 0:
        return f0, 0
    inc, off, msids = t.inc, t.off, t.msids
    idx = _csr_slots(off, cand_idx)
    if idx.size == 0:
        # isolated candidates: the h-operator over no s-cliques is 0
        out = f0.copy()
        out[cand_idx] = 0
        return out, 0
    sids = np.unique(msids[idx])
    sub_r = np.unique(np.concatenate([cand_idx, inc[sids].reshape(-1)]))
    inv = np.full((n_r,), -1, np.int64)
    inv[sub_r] = np.arange(sub_r.size)
    inc_sub = inv[inc[sids]]                         # (k, C), all >= 0
    k, C = inc_sub.shape
    m = sub_r.size
    vals = f0[sub_r].astype(np.int32)
    frozen = ~cand[sub_r]
    # every sweep but the last strictly lowers some candidate and values
    # are bounded below by 0: the seed sum caps the loop
    cap = int(vals[~frozen].sum()) + 2
    # the hook sees the reference's pow2 shape class; the tensors are not
    # padded (the per-r-clique lists go in as (owner, value) pairs)
    m_pad = _pow2(m, SUB_FLOOR)

    def d(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if (t.r, t.s) == (1, 2):
        # C = 2 rows ARE edges: direct adjacency
        src = np.concatenate([inc_sub[:, 0], inc_sub[:, 1]])
        dst = np.concatenate([inc_sub[:, 1], inc_sub[:, 0]])
        d_pad = _pow2(int(np.bincount(src, minlength=1).max()), DEG_FLOOR)
        if hook is not None:
            hook(("stream-converge", 1, 2, m_pad, d_pad))
        out, sweeps = kcore_local_converge(
            d(src), d(dst), d(vals), d(frozen), cap)
    else:
        flat = inc_sub.reshape(-1)
        d_pad = _pow2(int(np.bincount(flat, minlength=1).max()), DEG_FLOOR)
        if hook is not None:
            hook(("stream-converge", t.r, t.s, _pow2(k, SUB_FLOOR), m_pad,
                  d_pad))
        out, sweeps = local_converge(
            d(inc_sub), d(flat), d(np.arange(flat.size)), d(vals),
            d(frozen), cap)
    f = f0.copy()
    f[sub_r[~frozen]] = out.cpu().numpy()[~frozen]
    return f, int(sweeps)


# ---------------------------------------------------------------------------
# Forest patch: confluent link fixpoint over canonical chains
# ---------------------------------------------------------------------------

def _chains(inc: torch.Tensor, core: torch.Tensor):
    """Canonical per-s-clique chains: members sorted by core (ascending,
    stable), consecutive pairs linked.  The chain multiset over ALL
    s-cliques with the final core values resolves to exactly the fused
    engine's (parent, L), by the confluence of ``link_fixpoint``."""
    if inc.numel() == 0:
        z = torch.zeros((0,), dtype=INT, device=inc.device)
        return z, z
    order = torch.argsort(core[inc.long()], dim=1, stable=True)
    mem = torch.gather(inc, 1, order)
    return mem[:, :-1].reshape(-1), mem[:, 1:].reshape(-1)


def _run_fixpoint(parent0: torch.Tensor, L0: torch.Tensor,
                  core: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
                  hook: Hook) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``link_fixpoint`` over the links.  The hook sees the reference's
    padded shape class; the port's fixpoint takes the compacted link list
    as it is, so nothing is padded."""
    n_r = int(parent0.shape[0])
    if la.numel() == 0:
        return parent0, L0
    if hook is not None:
        hook(("stream-link", _pow2(n_r, SUB_FLOOR),
              _pow2(int(la.numel()), SUB_FLOOR)))
    return link_fixpoint(parent0, L0, core, la, lb, max_gens=3 * n_r + 4)


# ---------------------------------------------------------------------------
# The per-op driver + public entry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class UpdateStats:
    """Telemetry of one ``update()`` call (summed over its ops)."""

    ops: int = 0
    candidates: int = 0           # r-cliques seeded as possible changers
    changed: int = 0              # r-cliques whose core actually moved
    sweeps: int = 0               # Jacobi sweeps run
    incremental_relinks: int = 0  # forest kept: pure rid relabeling
    full_relinks: int = 0         # forest re-resolved from full multiset


def _remap_forest(parent: np.ndarray, L: np.ndarray,
                  edit: _OpEdit) -> Tuple[np.ndarray, np.ndarray]:
    """Carry the resolved forest into the new rid space (insert only:
    positions shift by one; the fresh rid starts as its own root)."""
    if edit.rid_map is None:
        return parent, L
    p = edit.rid_map[parent]
    Lr = np.where(L >= 0, edit.rid_map[np.clip(L, 0, None)], -1)
    for rid in edit.new_rids:
        p = np.insert(p, rid, rid)
        Lr = np.insert(Lr, rid, -1)
    return p, Lr


def _apply_op(t: _HostTables, dt: _DeviceTables, core: np.ndarray, op: str,
              u: int, v: int, stats: UpdateStats, hook: Hook):
    """One edge toggle: the edited tables (``dt`` is patched in place),
    the new core values, the edit and whether the op only relabels the
    forest (see the driver)."""
    e_new, pos = _apply_edge(t, u, v, op)
    core_old = core.astype(np.int64)
    if (t.r, t.s) == (1, 2):
        edit = _edit_12(t, e_new, u, v, op, core_old)
        core_u = core_old                         # rid space unchanged
    else:
        edit = _edit_23(t, e_new, pos, op, u, v, core_old)
        # old values carried into the NEW rid space; BIG marks the fresh
        # rid so min(core_u + 1, deg0) seeds it at its degree bound
        core_u = (np.insert(core_old, pos, BIG) if op == "insert"
                  else np.delete(core_old, pos))
    dt.patch(edit, op)
    new_t = edit.tables
    n_r = new_t.n_r
    deg0, inc, off, msids = new_t.deg0, new_t.inc, new_t.off, new_t.msids
    # fold inserted s-cliques into the seeds: each new s-clique S pushes
    # its bottleneck w(S) (under the carried upper labels) to its members
    best0 = edit.seed_best
    is_new = np.zeros((n_r,), bool)
    is_new[edit.new_rids] = True
    if op == "delete" and _delete_keeps_cores(
            core_u, np.flatnonzero(best0 >= 0), inc, off, msids):
        # feasibility held at every perturbed rid: skip region/converge
        f = core_u.astype(np.int64)
    else:
        if edit.new_sids.size:
            new_rows = inc[edit.new_sids]
            swt = core_u[new_rows].min(axis=1)
            np.maximum.at(best0, new_rows.reshape(-1),
                          np.broadcast_to(swt[:, None],
                                          new_rows.shape).reshape(-1))
        cand = np.zeros((n_r,), bool)
        cand[_region(dt, best0)] = True
        bump = 1 if op == "insert" else 0
        f0 = np.where(cand, np.minimum(core_u + bump, deg0), core_u)
        if op == "insert":
            cand, f0 = _prune_rise(inc, off, msids, core_u, cand, f0,
                                   is_new)
        # counted AFTER the rise screen: what the converge pays
        stats.candidates += int(cand.sum())
        if cand.any():
            f, sweeps = _converge(new_t, f0.astype(np.int64), cand, hook,
                                  dt.inc.device)
            stats.sweeps += sweeps
        else:
            # the screen disproved every rise: f0 is core_u everywhere
            f = f0.astype(np.int64)
    moved = np.flatnonzero(f != core_u)
    if moved.size:
        dt.core[torch.from_numpy(moved).to(dt.core.device)] = \
            torch.from_numpy(f[moved]).to(dt.core.device)
    changed_existing = (f != core_u) & ~is_new
    stats.changed += int(changed_existing.sum()) + int(is_new.sum())
    # an insert that creates no s-clique and moves no value leaves the link
    # multiset and cores untouched: the resolved forest just relabels into
    # the new rid space; every other op changes the chain multiset
    relabel_only = op == "insert" and not changed_existing.any() \
        and edit.new_sids.size == 0
    return new_t, f.astype(np.int64), edit, relabel_only


def _chain_forest(inc: torch.Tensor, core: torch.Tensor, hook: Hook
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The forest of the canonical chain multiset over the incidence rows
    ``inc`` with values ``core``: one ``link_fixpoint`` on their device."""
    n_r = int(core.shape[0])
    device = core.device
    core_d = core.to(INT)
    la, lb = _chains(inc.to(INT), core_d)
    p, L = _run_fixpoint(torch.arange(n_r, dtype=INT, device=device),
                         torch.full((n_r,), -1, dtype=INT, device=device),
                         core_d, la, lb, hook)
    return p.cpu().numpy().astype(np.int64), L.cpu().numpy().astype(np.int64)


def update_decomposition(dec, delta: GraphDelta, *,
                         bucket_hook: Hook = None):
    """Apply ``delta`` to a live ``Decomposition``; returns
    ``(new_decomposition, UpdateStats)``.

    Requirements (actionable errors otherwise): ``method='exact'``,
    ``hierarchy`` in {'fused', 'none'}, (r, s) in ``SUPPORTED_RS``, and
    the ``NucleusProblem`` still attached.  ``order_round``/``rounds`` are
    global-peel trace artifacts a local update cannot reproduce; the
    returned artifact carries ``order_round=None`` and ``rounds=-1``.
    The work runs on the attached problem's device.
    """
    from .api import Decomposition

    config = dec.config
    if config.method != "exact":
        raise ValueError(
            "update() maintains exact decompositions only (approximate "
            "peel values are trace artifacts, not a local fixpoint); "
            "re-run decompose() for approx artifacts")
    if (config.r, config.s) not in SUPPORTED_RS:
        raise ValueError(
            f"update() supports (r, s) in {SUPPORTED_RS}; got "
            f"({config.r}, {config.s}) — run a full decompose() instead")
    if config.hierarchy not in ("fused", "none"):
        raise ValueError(
            "update() patches the fused join forest (or none); "
            f"hierarchy={config.hierarchy!r} artifacts must re-decompose")
    if dec.problem is None:
        raise ValueError(
            "update() needs the NucleusProblem attached; a deserialized "
            "Decomposition has no incidence structure to maintain — "
            "re-decompose the edited graph instead")
    problem = dec.problem
    tables = _host_tables(problem)
    core = np.asarray(dec.core, np.int64).copy()
    dt = _DeviceTables.of(problem, core)
    parent = L = None
    if config.hierarchy == "fused":
        parent = np.asarray(dec.uf_parent, np.int64).copy()
        L = np.asarray(dec.uf_L, np.int64).copy()
    stats = UpdateStats()
    # The forest after an op is the chain forest of its state, or (an op
    # that only relabels) the previous forest relabeled by a monotone rid
    # map, which is the chain forest of the new state when the previous
    # one was.  So one chain fixpoint over the final state gives what the
    # reference's fixpoint per op gives; until an op needs it, the
    # decompose-time forest is relabeled as the reference does.
    stale = False
    for op, u, v in delta.ops():
        stats.ops += 1
        tables, core, edit, relabel_only = _apply_op(
            tables, dt, core, op, u, v, stats, bucket_hook)
        if parent is None:
            continue
        if relabel_only:
            stats.incremental_relinks += 1
            if not stale:
                parent, L = _remap_forest(parent, L, edit)
        else:
            stats.full_relinks += 1
            stale = True
    if parent is not None and stale:
        parent, L = _chain_forest(dt.inc, dt.core, bucket_hook)
    new_problem = _pack_problem(problem, tables, dt)
    core32 = core.astype(np.int32)
    out = Decomposition(
        config, problem=new_problem, core=core32, rounds=-1,
        order_round=None, peel_value=core32,
        uf_parent=None if parent is None else parent.astype(np.int32),
        uf_L=None if L is None else L.astype(np.int32),
        plan=dec.plan,
        # live-artifact identity: the successor keeps the published name
        # and advances one edit generation
        name=dec.name, version=dec.version + 1)
    out.update_stats = stats
    return out, stats
