"""The (r, s) incidence structure, eager build (counterpart of
``repro.core.incidence``).

Materialized once per problem, on one device:

  r_cliques   (n_r, r)  lexicographically sorted unique rows; id = row index
  inc_rid     (n_s, C)  the C = C(s, r) member r-clique ids of each s-clique
  mem CSR               r-clique id -> incident s-clique ids
  deg0        (n_r,)    initial s-clique-degree of each r-clique

Only ``build="eager"`` is ported in this slice; the chunked and sharded
builders are ROADMAP Queue 1.10 and 1.13.
"""
from __future__ import annotations

import dataclasses
from math import comb
from typing import Any, Mapping, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, same_device
from ..graph.cliques import expand_levels, lexsort_rows, sort_join, \
    subset_columns
from ..graph.container import (Digraph, Graph, INT, _build_digraph,
                               csr_from_pairs, orient_arcs)
from ..graph.orientation import approx_degeneracy_rank, degree_rank

BUILDS = ("eager",)

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
            orientation=self.orientation)


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


def build_problem(g: Graph, r: int, s: int, *, build: str = "eager",
                  device: DeviceLike = None) -> NucleusProblem:
    """Build the (r, s) incidence structure on `device` (None: the card).

    The orientation is ``pick_rank``'s (the reference's caller-supplied
    ``rank`` is not ported in this slice)."""
    if not 1 <= r < s:
        raise ValueError(f"need 1 <= r < s, got (r, s) = ({r}, {s})")
    if build not in BUILDS:
        raise ValueError(f"build={build!r} is not ported yet; the port "
                         f"builds {BUILDS}")
    g = g.to(resolve_device(device))
    dg, orientation = pick_rank(g)
    return _build_eager(g, r, s, dg, orientation)


def _build_eager(g: Graph, r: int, s: int, dg: Digraph,
                 orientation: str) -> NucleusProblem:
    dev = g.device
    levels = expand_levels(dg, torch.arange(g.n, dtype=INT, device=dev),
                           [r, s])
    r_rows = levels[r]
    s_rows = levels[s]
    del levels
    # r-clique table: rows are already unique; sort lexicographically for ids
    r_table = r_rows[lexsort_rows(r_rows)] if r_rows.shape[0] else r_rows
    n_r = int(r_table.shape[0])
    n_s = int(s_rows.shape[0])
    C = comb(s, r)
    if n_s:
        queries = torch.cat([s_rows[:, list(cols)]
                             for cols in subset_columns(s, r)], dim=0)
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
    return NucleusProblem(g=g, r=r, s=s, r_cliques=r_table.contiguous(),
                          inc_rid=inc_rid, mem_offsets=mem_offsets,
                          mem_sids=mem_sids.contiguous(), deg0=deg0,
                          orientation=orientation)


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

