"""Low out-degree orientations (counterpart of ``repro.graph.orientation``).

  * ``degree_rank``: order by degree — a single pass, the cheapest option.
  * ``approx_degeneracy_rank``: the (2+eps)-approximate degeneracy order by
    batched peeling (each round removes every vertex whose degree is at most
    (1+eps) * the surviving subgraph's average degree; O(log n) rounds).
"""
from __future__ import annotations

import torch

from .container import Graph, INT


def degree_rank(g: Graph) -> torch.Tensor:
    # rank = degree; ties by id are broken in orient().
    return g.degrees().to(INT)


def approx_degeneracy_rank(g: Graph, eps: float = 0.5,
                           max_rounds: int = 10_000) -> torch.Tensor:
    """(2+eps)-approximate degeneracy peeling order.

    All vertices removed in the same round share a rank.  The threshold
    ``ceil((1+eps) * 2 * m_live / n_live)`` is evaluated in float32 in the
    reference's operation order: ``2 * m_live`` passes 2**24 on graphs with
    ~10M edges, where a float64 evaluation would round differently.  The
    loop is host-driven: one sync per round for the ``alive.any()`` test.
    """
    n = g.n
    dev = g.device
    u, v = g.edges[:, 0].long(), g.edges[:, 1].long()
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    rank = torch.zeros((n,), dtype=INT, device=dev)
    scale = torch.tensor((1.0 + eps) * 2.0, dtype=torch.float32, device=dev)
    r = 0
    while r < max_rounds and bool(alive.any()):
        e_live = (alive[u] & alive[v]).to(INT)
        deg = torch.zeros((n,), dtype=INT, device=dev)
        deg.index_add_(0, u, e_live)
        deg.index_add_(0, v, e_live)
        n_live = alive.sum(dtype=torch.int32)
        m_live = e_live.sum(dtype=torch.int32)
        thresh = torch.ceil(scale * m_live.to(torch.float32)
                            / torch.clamp(n_live, min=1).to(torch.float32))
        peel = alive & (deg.to(torch.float32) <= thresh)
        rank = torch.where(peel, torch.full_like(rank, r), rank)
        alive = alive & ~peel
        r += 1
    return rank
