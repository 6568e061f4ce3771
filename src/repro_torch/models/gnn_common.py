"""Shared GNN substrate: padded graph batches and segment message passing
(counterpart of ``repro.models.gnn_common``).

Message passing is a gather (``index_select``) and a scatter-add
(``index_add_``) over an edge index, as the reference's is ``jnp.take``
and ``jax.ops.segment_sum``.  The reference runs no Pallas kernel here, so
these are plain torch on both devices; on the card ``index_add_`` adds with
atomics, so its float sums are not bit-reproducible from run to run.
Shapes are padded with masked edges and nodes, as the reference's are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A (possibly batched) graph with static shapes.

    nodes:      (N, F) node features
    edge_src/dst: (E,) int32 — messages flow src -> dst
    node_mask:  (N,) bool — padding nodes are False
    edge_mask:  (E,) bool
    pos:        (N, 3) positions (equivariant models) or None
    graph_id:   (N,) int32 — which graph each node belongs to (pooling)
    n_graphs:   static number of graphs in the batch
    triplet_kj / triplet_ji: (T,) edge ids forming directed triplets
        k->j (in-edge) feeding j->i (out-edge), for angular models
    triplet_mask: (T,) bool
    """

    nodes: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    graph_id: torch.Tensor
    n_graphs: int
    pos: Optional[torch.Tensor] = None
    triplet_kj: Optional[torch.Tensor] = None
    triplet_ji: Optional[torch.Tensor] = None
    triplet_mask: Optional[torch.Tensor] = None

    @property
    def n_nodes(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along axis 0; its backward saves only ``idx``."""
    return torch.index_select(x, 0, idx.long())


class _SegmentSum(torch.autograd.Function):
    """Rows added into their segment (``index_add_`` into zeros); the
    backward is a gather of the output's gradient, so only the ids are
    saved.  torch's own ``index_add`` saves its (E, ...) source for the
    backward as well, which at ogb_products' 61.9 M edges is 15.8 GB a
    layer of gin."""

    @staticmethod
    def forward(ctx, data, ids, num_segments):
        ctx.save_for_backward(ids)
        out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
        return out.index_add_(0, ids, data)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        return torch.index_select(grad, 0, ids), None, None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``data`` added into their segment."""
    return _SegmentSum.apply(data, segment_ids.long(), num_segments)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones((data.shape[0],)), segment_ids,
                      num_segments)
    return tot / torch.clamp(cnt, min=1)[..., None]


def _expand_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def masked_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       mask: torch.Tensor, num_segments: int) -> torch.Tensor:
    data = torch.where(_expand_mask(mask, data), data, 0)
    # masked edges scatter to segment 0 harmlessly (their data is zero)
    return segment_sum(data, torch.where(mask, segment_ids, 0), num_segments)


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """N(0, 1) float32 samples from ``gen`` times ``scale``, in ``dtype``
    on ``device``; on the ``meta`` device an empty tensor, no draw."""
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(device=device, dtype=dtype)


def mlp_init(gen: torch.Generator, sizes: Sequence[int],
             dtype: torch.dtype = torch.float32,
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``w{i}`` (a, b) of N(0, 1/a) and zero ``b{i}`` (b,) per layer, the
    reference's names, shapes and scales (its numbers are ``jax.random``'s,
    these ``gen``'s)."""
    dev = resolve_device(device)
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = normal(gen, (a, b), 1.0 / np.sqrt(a), dtype, dev)
        params[f"b{i}"] = torch.zeros((b,), dtype=dtype, device=dev)
    return params


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              act: Callable[[torch.Tensor], torch.Tensor] = F.silu,
              final_act: Optional[Callable] = None) -> torch.Tensor:
    n = sum(1 for k in params if k.startswith("w"))
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def _as_tensor(a, dtype, dev):
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


def make_batch_from_arrays(nodes, edge_src, edge_dst, *, pos=None,
                           graph_id=None, n_graphs=1, node_mask=None,
                           edge_mask=None, triplets=None,
                           device: DeviceLike = None) -> GraphBatch:
    """A ``GraphBatch`` of numpy arrays or tensors on ``device`` (default:
    the card): ids int32, masks bool (all True when omitted), graph_id 0
    when omitted, features and positions in their own float dtype."""
    dev = resolve_device(device)
    N = nodes.shape[0]
    E = edge_src.shape[0]

    def floats(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        return torch.from_numpy(np.asarray(a)).to(dev)

    t_kj = t_ji = t_m = None
    if triplets is not None:
        kj, ji, m = triplets
        t_kj = _as_tensor(kj, torch.int32, dev)
        t_ji = _as_tensor(ji, torch.int32, dev)
        t_m = _as_tensor(m, torch.bool, dev)
    return GraphBatch(
        nodes=floats(nodes),
        edge_src=_as_tensor(edge_src, torch.int32, dev),
        edge_dst=_as_tensor(edge_dst, torch.int32, dev),
        node_mask=(torch.ones((N,), dtype=torch.bool, device=dev)
                   if node_mask is None
                   else _as_tensor(node_mask, torch.bool, dev)),
        edge_mask=(torch.ones((E,), dtype=torch.bool, device=dev)
                   if edge_mask is None
                   else _as_tensor(edge_mask, torch.bool, dev)),
        graph_id=(torch.zeros((N,), dtype=torch.int32, device=dev)
                  if graph_id is None
                  else _as_tensor(graph_id, torch.int32, dev)),
        n_graphs=n_graphs,
        pos=None if pos is None else floats(pos),
        triplet_kj=t_kj, triplet_ji=t_ji, triplet_mask=t_m)


def build_triplets(edge_src: np.ndarray, edge_dst: np.ndarray,
                   n_nodes: int, cap_per_edge: Optional[int] = None):
    """Directed triplets (k->j, j->i), k != i, for angular message models.

    Returns (triplet_kj, triplet_ji, mask) as numpy, capacity-capped per
    out-edge when ``cap_per_edge`` is given: the reference's arrays, bit for
    bit, without its Python loop over the edges.  Out-edge e = (j -> i)
    takes the in-edges of j in their stable order by dst (edge id order),
    drops the backtracks k == i, and keeps the first ``cap_per_edge``.
    """
    src = np.asarray(edge_src).astype(np.int64)
    dst = np.asarray(edge_dst).astype(np.int64)
    E = src.shape[0]
    order = np.argsort(dst, kind="stable")              # in-edges by dst
    by_dst_off = np.zeros(n_nodes + 1, np.int64)
    np.add.at(by_dst_off, dst + 1, 1)
    by_dst_off = np.cumsum(by_dst_off)
    lo, hi = by_dst_off[src], by_dst_off[src + 1]       # in-edges of j
    cnt = hi - lo
    # every (out-edge, in-edge) candidate pair, out-edges in id order
    ji = np.repeat(np.arange(E, dtype=np.int64), cnt)
    starts = np.cumsum(cnt) - cnt
    kj = order[np.arange(ji.shape[0], dtype=np.int64) - starts[ji] + lo[ji]]
    keep = src[kj] != dst[ji]                           # no backtrack
    kj, ji = kj[keep], ji[keep]
    if cap_per_edge is not None and ji.shape[0]:
        kept = np.bincount(ji, minlength=E)
        rank = np.arange(ji.shape[0]) - (np.cumsum(kept) - kept)[ji]
        first = rank < cap_per_edge
        kj, ji = kj[first], ji[first]
    mask = np.ones(kj.shape[0], bool)
    return kj.astype(np.int32), ji.astype(np.int32), mask


def radial_basis(dist: torch.Tensor, n_rbf: int, cutoff: float
                 ) -> torch.Tensor:
    """Sine/Bessel-style radial basis on [0, cutoff] (DimeNet eq. 6)."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=dist.device)
    d = torch.clamp(dist[..., None], min=1e-9)
    rbf = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d / cutoff) / d
    return rbf * envelope(dist / cutoff)[..., None]


def envelope(x: torch.Tensor, p: int = 6) -> torch.Tensor:
    """Smooth polynomial cutoff envelope (DimeNet eq. 8)."""
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    xe = 1.0 + a * x ** p + b * x ** (p + 1) + c * x ** (p + 2)
    return torch.where(x < 1.0, xe, 0.0)
