"""The (r, s) incidence structure, eager build (counterpart of
``repro.core.incidence``).

Materialized once per problem, on one device:

  r_cliques   (n_r, r)  lexicographically sorted unique rows; id = row index
  inc_rid     (n_s, C)  the C = C(s, r) member r-clique ids of each s-clique
  mem CSR               r-clique id -> incident s-clique ids
  deg0        (n_r,)    initial s-clique-degree of each r-clique

Three builders produce bit-identical output, as in the reference:

  * ``build="eager"``   — one level-synchronous expansion over all source
    vertices, one sort-join, one CSR sort.
  * ``build="chunked"`` — the memory-bounded pipeline: the level-1 frontier
    is cut into source-vertex chunks sized from ``memory_budget_bytes``,
    each expanded on the problem's device, and the arrays are assembled by
    a blocked sort-join and a two-pass count-then-fill CSR.  For (2,3)
    with ``5·n²·4 <= budget`` it takes the dense fast path instead: the
    count pass is the tricount kernel ``(D @ Dᵀ) ⊙ D`` on the oriented 0/1
    adjacency (``kernels/csrc/tricount.cu`` on the card), and the fill
    extracts triangles from dense membership rows ``D[u] * D[v]``.
  * ``build="sharded"`` — the chunks are planned onto shards, each shard
    expands its own seed range and joins its rows into its slab of the
    incidence table, and the membership CSR comes from a count-then-fill
    exchange (``repro_torch.distbuild``).

``NucleusProblem.build_stats`` carries the reference's keys.  ``build``,
``chunk_size``, ``n_chunks``, ``memory_budget_bytes`` and ``fastpath``
equal the reference's for the same graph and budget;
``peak_intermediate_bytes`` is the port's own account of the device bytes
its builder holds, which differs from the reference's host-numpy meter.
"""
from __future__ import annotations

import dataclasses
import hashlib
from math import comb
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, same_device
from ..distbuild.exchange import assemble_mem_csr
from ..graph.cliques import (expand_levels_metered, iter_clique_chunks,
                             lexsort_rows, sort_join, subset_columns)
from ..graph.container import (Digraph, Graph, INT, _build_digraph,
                               csr_from_pairs, orient, orient_arcs)
from ..graph.orientation import approx_degeneracy_rank, degree_rank
from ..kernels import tricount

BUILDS = ("eager", "chunked", "sharded")
# the arrays that define a built problem, in fingerprint order
INCIDENCE_FIELDS = ("r_cliques", "inc_rid", "mem_offsets", "mem_sids",
                    "deg0")
# default memory budget for build="chunked" when the caller names neither a
# budget nor a chunk size: the dense (2,3) fast path fits up to n ~ 3.6k
DEFAULT_BUILD_BUDGET = 256 << 20
# elements of one dense membership block of the (2,3) fast path's fill;
# keeps each torch.nonzero call well under its int32 element limit
_FILL_ELEMS = 1 << 30

# candidate orientations tried by pick_rank, in tie-break priority order
ORIENTATIONS = (("degree", degree_rank),
                ("approx_degeneracy", approx_degeneracy_rank))


@dataclasses.dataclass
class NucleusProblem:
    g: Graph
    r: int
    s: int
    r_cliques: torch.Tensor      # (n_r, r) int32, lexsorted rows
    inc_rid: torch.Tensor        # (n_s, C) int32
    mem_offsets: torch.Tensor    # (n_r + 1,) int32
    mem_sids: torch.Tensor       # (n_s * C,) int32
    deg0: torch.Tensor           # (n_r,) int32
    # which orientation produced the DAG the cliques were listed from
    # ("degree" | "approx_degeneracy")
    orientation: str = "degree"
    # builder telemetry with the reference's keys: {"build", "chunk_size",
    # "n_chunks", "peak_intermediate_bytes", "memory_budget_bytes",
    # "fastpath"}; NOT part of the bit-identity contract
    build_stats: Optional[Dict[str, Any]] = None

    @property
    def n_r(self) -> int:
        return int(self.r_cliques.shape[0])

    @property
    def n_s(self) -> int:
        return int(self.inc_rid.shape[0])

    @property
    def n_sub(self) -> int:
        return comb(self.s, self.r)

    @property
    def device(self) -> torch.device:
        return self.inc_rid.device

    def to(self, device: torch.device) -> "NucleusProblem":
        """This problem on `device` (self when it is already there)."""
        if same_device(self.device, device):
            return self
        return NucleusProblem(
            g=self.g.to(device), r=self.r, s=self.s,
            r_cliques=self.r_cliques.to(device),
            inc_rid=self.inc_rid.to(device),
            mem_offsets=self.mem_offsets.to(device),
            mem_sids=self.mem_sids.to(device), deg0=self.deg0.to(device),
            orientation=self.orientation, build_stats=self.build_stats)


def problem_digest(problem: NucleusProblem) -> str:
    """SHA-256 build fingerprint over the five incidence arrays and the
    orientation, computed as ``benchmarks/build_child.py`` computes the
    reference's (so it matches ``tests/golden/build/*.json``)."""
    h = hashlib.sha256()
    for f in INCIDENCE_FIELDS:
        a = np.ascontiguousarray(getattr(problem, f).cpu().numpy())
        h.update(f.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    h.update(problem.orientation.encode())
    return h.hexdigest()


def pick_rank(g: Graph) -> Tuple[Digraph, str]:
    """Pick the orientation with the smaller max out-degree.

    Ties go to the first candidate in ORIENTATIONS order, as in the
    reference.  Only the winner's padded adjacency is materialized: the
    max out-degree of each candidate is read from its arc counts.
    """
    best = None
    for name, fn in ORIENTATIONS:
        src, dst = orient_arcs(g, fn(g))
        dmax = max(int(torch.bincount(src.long(), minlength=g.n).max())
                   if src.numel() else 1, 1)
        if best is None or dmax < best[0]:
            best = (dmax, name, src, dst)
    _, name, src, dst = best
    return _build_digraph(g.n, src, dst), name


def _resolve_digraph(g: Graph, rank: Optional[torch.Tensor]
                     ) -> Tuple[Digraph, str]:
    """The caller's orientation (``"caller"``), else ``pick_rank``'s."""
    if rank is None:
        return pick_rank(g)
    return orient(g, torch.as_tensor(rank, device=g.device)), "caller"


def build_problem(g: Graph, r: int, s: int,
                  rank: Optional[torch.Tensor] = None, *,
                  build: str = "eager",
                  memory_budget_bytes: Optional[int] = None,
                  chunk_size: Optional[int] = None,
                  fastpath: Optional[bool] = None,
                  shards: Optional[int] = None,
                  device: DeviceLike = None) -> NucleusProblem:
    """Build the (r, s) incidence structure on `device` (None: the card).

    build="eager" is the one-burst builder; build="chunked" bounds the
    intermediate memory by ``memory_budget_bytes`` (None: 256 MiB) or an
    explicit ``chunk_size`` in source vertices (which pins the sparse
    seed-chunked path); build="sharded" plans the chunks onto ``shards``
    workers (None: the length of ``launch.mesh.make_host_mesh``) and
    assembles their slabs directly (``repro_torch.distbuild``).
    ``fastpath`` forces the dense (2,3) count pass on or off (None: on
    when (r, s) == (2, 3), no chunk size is given and ``5·n²·4 <=
    budget``; chunked builder only).  Every builder gives bit-identical
    arrays.  ``rank`` is the caller's orientation key (``orientation ==
    "caller"``); None picks one (``pick_rank``)."""
    if not 1 <= r < s:
        raise ValueError(f"need 1 <= r < s, got (r, s) = ({r}, {s})")
    if build not in BUILDS:
        raise ValueError(f"build={build!r}; expected one of {BUILDS}")
    if shards is not None and build != "sharded":
        raise ValueError(
            f"shards={shards} is the sharded builder's worker count; set "
            f"build='sharded' or drop it (got build={build!r})")
    g = g.to(resolve_device(device))
    if build == "sharded":
        if fastpath:
            raise ValueError(
                "fastpath=True is the chunked builder's dense (2,3) count "
                "pass; it does not apply to build='sharded'")
        from ..distbuild import build_problem_sharded
        return build_problem_sharded(
            g, r, s, rank, n_shards=shards,
            memory_budget_bytes=memory_budget_bytes, chunk_size=chunk_size)
    dg, orientation = _resolve_digraph(g, rank)
    if build == "eager":
        return _build_eager(g, r, s, dg, orientation)
    return _build_chunked(g, r, s, dg, orientation,
                          memory_budget_bytes=memory_budget_bytes,
                          chunk_size=chunk_size, fastpath=fastpath)


def _build_eager(g: Graph, r: int, s: int, dg: Digraph,
                 orientation: str) -> NucleusProblem:
    dev = g.device
    levels, expand_peak = expand_levels_metered(
        dg, torch.arange(g.n, dtype=INT, device=dev), [r, s])
    r_rows = levels[r]
    s_rows = levels[s]
    del levels
    # r-clique table: rows are already unique; sort lexicographically for ids
    r_table = r_rows[lexsort_rows(r_rows)] if r_rows.shape[0] else r_rows
    n_r = int(r_table.shape[0])
    n_s = int(s_rows.shape[0])
    C = comb(s, r)
    join_bytes = 0
    if n_s:
        queries = torch.cat([s_rows[:, list(cols)]
                             for cols in subset_columns(s, r)], dim=0)
        join_bytes = 3 * queries.numel() * 4  # queries + combined + order
        ids = sort_join(r_table, queries)  # (C * n_s,), grouped by combo
        del queries
        inc_rid = ids.reshape(C, n_s).t().contiguous().to(INT)  # (n_s, C)
    else:
        inc_rid = torch.zeros((0, C), dtype=INT, device=dev)
    flat_rid = inc_rid.reshape(-1)
    flat_sid = torch.repeat_interleave(
        torch.arange(n_s, dtype=INT, device=dev), C, output_size=n_s * C)
    mem_offsets, mem_sids = csr_from_pairs(flat_rid, flat_sid, n_r)
    deg0 = (mem_offsets[1:] - mem_offsets[:-1]).to(INT)
    stats = {"build": "eager", "chunk_size": g.n, "n_chunks": 1,
             "peak_intermediate_bytes": max(int(expand_peak), join_bytes),
             "memory_budget_bytes": None, "fastpath": False}
    return NucleusProblem(g=g, r=r, s=s, r_cliques=r_table.contiguous(),
                          inc_rid=inc_rid, mem_offsets=mem_offsets,
                          mem_sids=mem_sids.contiguous(), deg0=deg0,
                          orientation=orientation, build_stats=stats)


# ---------------------------------------------------------------------------
# Chunked builder (memory-bounded, two-pass count-then-fill)
# ---------------------------------------------------------------------------

def _derive_chunk_size(dg: Digraph, s: int, budget: int) -> int:
    """memory budget (bytes) -> source vertices per chunk.

    The reference's rule, literally and in float64 on the host, so the
    chunk size equals the reference's for the same graph and budget: the
    deepest level holds ~outdeg_avg * dmax^(s-2) partial rows per seed,
    each carrying its (s,) tuple and a (dmax,)-wide candidate set at
    ~28 B per element; clamped to [1, n].
    """
    dmax = max(dg.dmax, 1)
    n = max(dg.n, 1)
    outdeg = dg.outdeg.cpu().numpy()
    avg_out = max(float(outdeg.mean()), 1.0) if outdeg.size else 1.0
    rows_per_seed = avg_out * float(dmax) ** max(s - 2, 0)
    bytes_per_seed = 28.0 * (s + dmax) * rows_per_seed
    return int(np.clip(budget / max(bytes_per_seed, 1.0), 1, n))


def _fill_parts(parts: List[torch.Tensor], width: int,
                device: torch.device) -> torch.Tensor:
    """Count-then-fill assembly: allocate the exact total once and copy each
    chunk in, releasing it as it goes."""
    total = sum(int(p.shape[0]) for p in parts)
    out = torch.empty((total, width), dtype=INT, device=device)
    at = 0
    for i, p in enumerate(parts):
        out[at:at + p.shape[0]] = p
        at += int(p.shape[0])
        parts[i] = None  # release as we go
    return out


def _assemble(g: Graph, r: int, s: int, r_rows: torch.Tensor,
              s_rows: torch.Tensor, orientation: str, budget: int,
              stats: Dict[str, Any]) -> NucleusProblem:
    """Incidence assembly from the clique rows, on their device.

    The sort-join and the CSR fill run in blocks of ``budget``-sized
    queries; every step is a per-row function of the eager path's, so the
    output is bit-identical to it.
    """
    dev = g.device
    C = comb(s, r)
    n_s = int(s_rows.shape[0])
    r_table = r_rows[lexsort_rows(r_rows)] if r_rows.shape[0] else \
        r_rows.reshape(0, r)
    n_r = int(r_table.shape[0])

    q_block = join_block_rows(budget, r, s)
    inc = torch.empty((n_s, C), dtype=INT, device=dev)
    join_bytes = join_into(inc, 0, s_rows, r_table, r, s, q_block)
    # two-pass mem-CSR over one slab: counts (= deg0) first, then a cursor
    # fill that reproduces the stable argsort grouping of csr_from_pairs
    mem_offsets, mem_sids, deg0, _ = assemble_mem_csr(inc, [0, n_s], n_r,
                                                      q_block)
    stats["peak_intermediate_bytes"] = max(
        stats.get("peak_intermediate_bytes", 0), join_bytes)
    return NucleusProblem(
        g=g, r=r, s=s, r_cliques=r_table.contiguous(), inc_rid=inc,
        mem_offsets=mem_offsets, mem_sids=mem_sids, deg0=deg0,
        orientation=orientation, build_stats=stats)


def join_block_rows(budget: int, r: int, s: int) -> int:
    """Query rows per block of the blocked sort-join, as the reference
    sizes them from the budget."""
    return max(1, int(budget // max(8 * 4 * comb(s, r) * max(r, 1), 1)))


def join_into(inc: torch.Tensor, base: int, s_rows: torch.Tensor,
              r_table: torch.Tensor, r: int, s: int, q_block: int) -> int:
    """Blocked sort-join of the s-clique rows into ``inc[base:base +
    len(s_rows)]``; returns the largest block's transient bytes.  Ids are
    a per-query-row function of (table, row), so block and slab
    boundaries cannot change them."""
    C = comb(s, r)
    join_bytes = 0
    for b0 in range(0, int(s_rows.shape[0]), q_block):
        blk = s_rows[b0:b0 + q_block]
        qs = torch.cat([blk[:, list(cols)] for cols in subset_columns(s, r)],
                       dim=0)
        join_bytes = max(join_bytes, 3 * qs.numel() * 4)
        inc[base + b0:base + b0 + blk.shape[0]] = \
            sort_join(r_table, qs).reshape(C, -1).t()
        del qs
    return join_bytes


def _fastpath_ok(r: int, s: int, dg: Digraph, budget: int) -> bool:
    """The reference's rule, literally: the dense (2,3) count stage holds
    ~4 (n, n) f32 blocks plus one edge block of membership rows, and all
    must fit the budget."""
    return (r, s) == (2, 3) and 5 * dg.n * dg.n * 4 <= budget


def _build_chunked(g: Graph, r: int, s: int, dg: Digraph, orientation: str,
                   memory_budget_bytes: Optional[int],
                   chunk_size: Optional[int],
                   fastpath: Optional[bool]) -> NucleusProblem:
    budget = memory_budget_bytes if memory_budget_bytes is not None \
        else DEFAULT_BUILD_BUDGET
    if fastpath and (r, s) != (2, 3):
        raise ValueError(
            f"fastpath=True is the dense (2,3) count pass; it does not "
            f"apply to (r, s) = ({r}, {s})")
    # an explicit chunk_size pins the sparse seed-chunked path
    use_fast = (_fastpath_ok(r, s, dg, budget) and chunk_size is None) \
        if fastpath is None else bool(fastpath)
    if use_fast:
        return _build_chunked_23_dense(g, dg, orientation, budget)

    chunk = chunk_size if chunk_size is not None \
        else _derive_chunk_size(dg, s, budget)
    r_parts: List[torch.Tensor] = []
    s_parts: List[torch.Tensor] = []
    peak = 0
    n_chunks = 0
    for _start, levels, chunk_peak in iter_clique_chunks(dg, [r, s], chunk):
        n_chunks += 1
        peak = max(peak, int(chunk_peak))
        r_parts.append(levels[r])
        s_parts.append(levels[s])
    r_rows = _fill_parts(r_parts, r, g.device)
    s_rows = _fill_parts(s_parts, s, g.device)
    stats = {"build": "chunked", "chunk_size": chunk, "n_chunks": n_chunks,
             "peak_intermediate_bytes": peak,
             "memory_budget_bytes": memory_budget_bytes, "fastpath": False}
    return _assemble(g, r, s, r_rows, s_rows, orientation, budget, stats)


def dense_dag(dg: Digraph):
    """(src, dst, D): the DAG's arcs in CSR order as int64 tensors and its
    (n, n) float32 0/1 adjacency, D[u, v] = 1 iff u→v, on its device: the
    operand of the (2,3) fast path's count pass."""
    n = dg.n
    dst = dg.neighbors.long()
    src = torch.repeat_interleave(torch.arange(n, device=dst.device),
                                  dg.outdeg.long(),
                                  output_size=int(dst.shape[0]))
    dense = torch.zeros((n, n), dtype=torch.float32, device=dst.device)
    if dst.numel():
        dense[src, dst] = 1.0
    return src, dst, dense


def _build_chunked_23_dense(g: Graph, dg: Digraph, orientation: str,
                            budget: int) -> NucleusProblem:
    """(2,3) fast path: the tricount count pass + a dense-row fill.

    Pass 1 (count) runs ``tricount_oriented`` on the oriented 0/1
    adjacency, so every edge's triangle count, and so every allocation
    size, comes off the kernel without a candidate array.  Pass 2 (fill)
    walks DAG edges in CSR order in budget-sized blocks (each cut further
    to ``_FILL_ELEMS`` elements); a block's common out-neighbors are the
    nonzeros of ``D[u] * D[v]``, and ``torch.nonzero`` emits them
    row-major (edge order, then w ascending), the sparse builder's
    expansion order, so the output is bit-identical.
    """
    dev = g.device
    n = dg.n
    src, nbrs, dense = dense_dag(dg)
    n_e = int(nbrs.shape[0])
    # unlike the reference there is no fallback: a CUDA tensor reaches the
    # kernel or the call raises
    counts_nn = tricount.tricount_oriented(dense)
    ext = counts_nn[src, nbrs].to(torch.int64)
    del counts_nn
    n_s = int(ext.sum())

    # r-cliques = DAG edges in CSR (expansion) order, rows ascending
    r_rows = torch.sort(torch.stack([src, nbrs], dim=1), dim=1).values.to(
        INT)

    # fill pass: membership rows for a block of edges at a time
    e_block = max(1, int(budget // max(3 * 4 * n, 1)))
    sub = max(1, min(e_block, _FILL_ELEMS // max(n, 1)))
    s_rows = torch.empty((n_s, 3), dtype=INT, device=dev)
    at = 0
    n_blocks = 0
    for e0 in range(0, n_e, e_block):
        e1 = min(e0 + e_block, n_e)
        for f0 in range(e0, e1, sub):
            u, v = src[f0:min(f0 + sub, e1)], nbrs[f0:min(f0 + sub, e1)]
            eidx, w = torch.nonzero(dense[u] * dense[v], as_tuple=True)
            tri = torch.sort(torch.stack([u[eidx], v[eidx], w], dim=1),
                             dim=1).values.to(INT)
            # nucleuslint: disable=NL102 (host ints, additive taint)
            if at + tri.shape[0] > n_s:
                raise RuntimeError(f"the tricount count pass found {n_s} "
                                   f"triangles but the fill finds more")
            s_rows[at:at + tri.shape[0]] = tri
            at += int(tri.shape[0])
        n_blocks += 1
    if at != n_s:  # kernel counts must agree with the fill
        raise RuntimeError(f"the tricount count pass found {n_s} triangles "
                           f"but the fill found {at}")

    # count stage: dense + counts + the kernel's row bitsets (n words of
    # ceil(n / 32) uint32); fill stage: dense + one sub-block's two gathered
    # rows and their product
    bitsets = 4 * n * (-(-n // 32))
    peak = max(8 * n * n + bitsets, 4 * n * n + 12 * sub * n)
    stats = {"build": "chunked", "chunk_size": e_block, "n_chunks": n_blocks,
             "peak_intermediate_bytes": int(peak),
             "memory_budget_bytes": budget, "fastpath": True}
    return _assemble(g, 2, 3, r_rows, s_rows, orientation, budget, stats)


def problem_from_reference(arrays: Mapping[str, Any], r: int, s: int,
                           orientation: str,
                           device: DeviceLike = None) -> NucleusProblem:
    """The port's problem from a reference problem's arrays (as numpy).

    ``arrays`` holds ``edges``, ``n``, ``r_cliques``, ``inc_rid``,
    ``mem_offsets``, ``mem_sids`` and ``deg0``.  The arrays are carried
    across unchanged, so both packages can be fed the identical incidence
    whatever their builders do.
    """
    dev = resolve_device(device)

    def t(name: str) -> torch.Tensor:
        return torch.tensor(np.asarray(arrays[name], dtype=np.int32),
                            device=dev)
    g = Graph(n=int(arrays["n"]), edges=t("edges").reshape(-1, 2))
    C = comb(s, r)
    return NucleusProblem(g=g, r=r, s=s, r_cliques=t("r_cliques").reshape(
        -1, r), inc_rid=t("inc_rid").reshape(-1, C),
        mem_offsets=t("mem_offsets"), mem_sids=t("mem_sids"),
        deg0=t("deg0"), orientation=orientation)

