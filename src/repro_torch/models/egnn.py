"""EGNN — E(n)-equivariant GNN [arXiv:2102.09844] (counterpart of
``repro.models.egnn``).

Config egnn: n_layers=4, d_hidden=64.  Messages are built from invariants
(h_i, h_j, ||x_i - x_j||^2); coordinates update along relative vectors, so
the network is exactly E(n)-equivariant (verified by property tests).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device, default_generator
from .gnn_common import (GraphBatch, gather, masked_segment_sum, mlp_apply,
                         mlp_init, segment_sum)


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    n_out: int = 1            # graph-level regression targets (e.g. energy)
    coord_agg_clip: float = 100.0
    dtype: Any = torch.float32


def init_params(cfg: EGNNConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's names, shapes and dtypes."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = default_generator(dev)
    d = cfg.d_hidden
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "phi_e": mlp_init(gen, [2 * d + 1, d, d], cfg.dtype, dev),
            "phi_x": mlp_init(gen, [d, d, 1], cfg.dtype, dev),
            "phi_h": mlp_init(gen, [2 * d, d, d], cfg.dtype, dev),
            "phi_inf": mlp_init(gen, [d, 1], cfg.dtype, dev),
        })
    return {
        "encode": mlp_init(gen, [cfg.d_in, d], cfg.dtype, dev),
        "layers": layers,
        "readout": mlp_init(gen, [d, d, cfg.n_out], cfg.dtype, dev),
    }


def forward(params: Dict[str, Any], batch: GraphBatch, cfg: EGNNConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (graph outputs (n_graphs, n_out), final coords (N, 3))."""
    if batch.pos is None:
        raise ValueError("EGNN requires positions")
    h = mlp_apply(params["encode"], batch.nodes.to(cfg.dtype))
    pos = batch.pos.to(cfg.dtype)
    x = pos
    N = h.shape[0]
    src, dst, em = batch.edge_src, batch.edge_dst, batch.edge_mask
    for lp in params["layers"]:
        rel = gather(x, dst) - gather(x, src)              # (E, 3)
        d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
        feats = torch.cat([gather(h, dst), gather(h, src), d2], dim=-1)
        m = mlp_apply(lp["phi_e"], feats)                  # (E, d)
        # soft edge gating (EGNN eq. 8 attention variant)
        gate = torch.sigmoid(mlp_apply(lp["phi_inf"], m))
        m = m * gate
        # coordinate update: x_i += mean_j (x_i - x_j) * phi_x(m_ij)
        w = mlp_apply(lp["phi_x"], m)
        w = torch.clamp(w, -cfg.coord_agg_clip, cfg.coord_agg_clip)
        upd = masked_segment_sum(rel * w, dst, em, N)
        deg = masked_segment_sum(torch.ones_like(w), dst, em, N)
        x = x + upd / torch.clamp(deg, min=1.0)
        # node update from aggregated messages
        agg = masked_segment_sum(m, dst, em, N)
        h = h + mlp_apply(lp["phi_h"], torch.cat([h, agg], dim=-1))
        h = torch.where(batch.node_mask[:, None], h, 0)
        x = torch.where(batch.node_mask[:, None], x, pos)
    pooled = segment_sum(h, batch.graph_id, batch.n_graphs)
    return mlp_apply(params["readout"], pooled), x


def loss_fn(params, batch: GraphBatch, targets: torch.Tensor,
            cfg: EGNNConfig) -> torch.Tensor:
    out, _ = forward(params, batch, cfg)
    return torch.mean(torch.square(out.float() - targets.float()))
