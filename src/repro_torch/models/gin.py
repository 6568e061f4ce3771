"""GIN (Graph Isomorphism Network) — sum aggregation + MLP, learnable eps
(counterpart of ``repro.models.gin``).

[arXiv:1810.00826] config gin-tu: n_layers=5, d_hidden=64, aggregator=sum.
Message passing = gather(src) -> segment sum(dst).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..device import DeviceLike, resolve_device, default_generator
from .gnn_common import (GraphBatch, gather, masked_segment_sum, mlp_apply,
                         mlp_init, segment_sum)


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 16
    n_classes: int = 8
    graph_level: bool = True   # graph classification (TU datasets) vs node
    dtype: Any = torch.float32


def init_params(cfg: GINConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's names, shapes and dtypes; ``eps`` is a 0-d float32
    zero per layer."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = default_generator(dev)
    layers = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_in if i == 0 else cfg.d_hidden
        layers.append({
            "mlp": mlp_init(gen, [d_in, cfg.d_hidden, cfg.d_hidden],
                            cfg.dtype, dev),
            "eps": torch.zeros((), dtype=torch.float32, device=dev),
        })
    return {
        "layers": layers,
        "readout": mlp_init(gen, [cfg.d_hidden, cfg.d_hidden,
                                  cfg.n_classes], cfg.dtype, dev),
    }


def forward(params: Dict[str, Any], batch: GraphBatch,
            cfg: GINConfig) -> torch.Tensor:
    """Returns (n_graphs, n_classes) if graph_level else (N, n_classes)."""
    h = batch.nodes.to(cfg.dtype)
    N = h.shape[0]
    for lp in params["layers"]:
        agg = masked_segment_sum(gather(h, batch.edge_src), batch.edge_dst,
                                 batch.edge_mask, N)
        h = mlp_apply(lp["mlp"], (1.0 + lp["eps"]) * h + agg)
        h = torch.where(batch.node_mask[:, None], h, 0)
    if cfg.graph_level:
        pooled = segment_sum(h, batch.graph_id, batch.n_graphs)
        return mlp_apply(params["readout"], pooled)
    return mlp_apply(params["readout"], h)


def loss_fn(params, batch: GraphBatch, labels: torch.Tensor, cfg: GINConfig,
            label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logits = forward(params, batch, cfg).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    nll = logz - gold
    if label_mask is not None:
        return torch.sum(nll * label_mask) / torch.clamp(label_mask.sum(),
                                                         min=1)
    return torch.mean(nll)
