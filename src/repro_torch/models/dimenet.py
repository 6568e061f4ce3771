"""DimeNet — directional message passing with angular basis
[arXiv:2003.03123] (counterpart of ``repro.models.dimenet``).

Config dimenet: n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
n_radial=6.  Messages live on DIRECTED EDGES; interaction blocks aggregate
over triplets (k->j feeding j->i) with a 2D basis in (distance, angle) and the
bilinear layer of the paper: two gathers and one segment sum per block.

As in the reference, the angular basis is Legendre polynomials
P_l(cos angle) x the sine radial basis instead of spherical Bessel roots,
and triplet lists on large graphs are capacity-capped per edge by the data
pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device, default_generator
from .gnn_common import (GraphBatch, gather, masked_segment_sum, mlp_apply,
                         mlp_init, normal, radial_basis, segment_sum)


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_in: int = 16
    n_out: int = 1
    cutoff: float = 5.0
    dtype: Any = torch.float32


def _legendre(cos_t: torch.Tensor, lmax: int) -> torch.Tensor:
    """P_0..P_{lmax-1}(cos_t), recurrence; returns (..., lmax)."""
    p0 = torch.ones_like(cos_t)
    if lmax == 1:
        return p0[..., None]
    ps = [p0, cos_t]
    for l in range(2, lmax):
        ps.append(((2 * l - 1) * cos_t * ps[-1] - (l - 1) * ps[-2]) / l)
    return torch.stack(ps, dim=-1)


def init_params(cfg: DimeNetConfig,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's names, shapes and dtypes; ``w_bil`` is
    N(0, 1/(d·nb)) of shape (nb, d, d)."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = default_generator(dev)
    d, nb, dt = cfg.d_hidden, cfg.n_bilinear, cfg.dtype
    n_sbf = cfg.n_spherical * cfg.n_radial
    blocks = []
    for _ in range(cfg.n_blocks):
        blocks.append({
            "w_kj": mlp_init(gen, [d, d], dt, dev),
            "w_rbf": mlp_init(gen, [cfg.n_radial, d], dt, dev),
            "w_sbf": mlp_init(gen, [n_sbf, nb], dt, dev),
            "w_bil": normal(gen, (nb, d, d), 1.0 / np.sqrt(d * nb), dt, dev),
            "mlp_ji": mlp_init(gen, [d, d], dt, dev),
            "mlp_out": mlp_init(gen, [d, d, d], dt, dev),
            "out_rbf": mlp_init(gen, [cfg.n_radial, d], dt, dev),
            "out_atom": mlp_init(gen, [d, d, cfg.n_out], dt, dev),
        })
    return {
        "embed_node": mlp_init(gen, [cfg.d_in, d], dt, dev),
        "embed_edge": mlp_init(gen, [2 * d + cfg.n_radial, d, d], dt, dev),
        "out0_rbf": mlp_init(gen, [cfg.n_radial, d], dt, dev),
        "out0_atom": mlp_init(gen, [d, d, cfg.n_out], dt, dev),
        "blocks": blocks,
    }


def bilinear(sbf_p: torch.Tensor, w_bil: torch.Tensor,
             m_kj: torch.Tensor) -> torch.Tensor:
    """``einsum("tb,bde,te->td", sbf_p, w_bil, m_kj)``, contracted in the
    order that makes no (T, d, d) tensor: ``m_kj @ w_bil`` as one
    (T, d) x (d, nb·d) product, then weighted by ``sbf_p`` and summed
    over b."""
    nb, d, _ = w_bil.shape
    w = w_bil.permute(2, 0, 1).reshape(d, nb * d)        # [e, b·d]
    y = (m_kj @ w).view(-1, nb, d)                      # (T, nb, d)
    return (y * sbf_p[:, :, None]).sum(dim=1)


def forward(params: Dict[str, Any], batch: GraphBatch,
            cfg: DimeNetConfig) -> torch.Tensor:
    """Graph-level outputs (n_graphs, n_out) — energies for molecules."""
    if batch.pos is None or batch.triplet_kj is None:
        raise ValueError("DimeNet requires positions and triplets")
    x = batch.pos.to(cfg.dtype)
    src, dst, em = batch.edge_src, batch.edge_dst, batch.edge_mask
    N, E = batch.n_nodes, batch.n_edges
    rel = gather(x, dst) - gather(x, src)
    dist = torch.sqrt(torch.clamp(torch.sum(rel * rel, -1), min=1e-12))
    rbf = radial_basis(dist, cfg.n_radial, cfg.cutoff).to(cfg.dtype)

    # triplet geometry: angle at j between k->j and j->i
    kj, ji, tm = batch.triplet_kj, batch.triplet_ji, batch.triplet_mask
    v_ji = gather(rel, ji)                   # j -> i
    v_jk = -gather(rel, kj)                  # j -> k  (reverse of k->j)
    d_kj = gather(dist, kj)
    cos_t = torch.sum(v_ji * v_jk, -1) / torch.clamp(
        gather(dist, ji) * d_kj, min=1e-9)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    leg = _legendre(cos_t, cfg.n_spherical)                    # (T, n_sph)
    rbf_kj = radial_basis(d_kj, cfg.n_radial, cfg.cutoff)
    sbf = (leg[:, :, None] * rbf_kj[:, None, :]).reshape(
        kj.shape[0], -1).to(cfg.dtype)                         # (T, n_sbf)

    h = mlp_apply(params["embed_node"], batch.nodes.to(cfg.dtype))
    m = mlp_apply(params["embed_edge"], torch.cat(
        [gather(h, src), gather(h, dst), rbf], dim=-1))       # (E, d)
    m = torch.where(em[:, None], m, 0)

    # output block 0 (from the embedding)
    per_atom = mlp_apply(params["out0_atom"], masked_segment_sum(
        m * mlp_apply(params["out0_rbf"], rbf), dst, em, N))
    for bp in params["blocks"]:
        # directional aggregation over triplets with the bilinear layer
        m_kj = gather(mlp_apply(bp["w_kj"], m), kj)
        m_kj = m_kj * gather(mlp_apply(bp["w_rbf"], rbf), kj)
        sbf_p = mlp_apply(bp["w_sbf"], sbf)                    # (T, nb)
        inter = bilinear(sbf_p, bp["w_bil"], m_kj)
        agg = masked_segment_sum(inter, ji, tm, E)             # (E, d)
        m = m + F.silu(mlp_apply(bp["mlp_ji"], m)) + agg
        m = F.silu(mlp_apply(bp["mlp_out"], m))
        m = torch.where(em[:, None], m, 0)
        per_atom = per_atom + mlp_apply(bp["out_atom"], masked_segment_sum(
            m * mlp_apply(bp["out_rbf"], rbf), dst, em, N))
    per_atom = torch.where(batch.node_mask[:, None], per_atom, 0)
    return segment_sum(per_atom, batch.graph_id, batch.n_graphs)


def loss_fn(params, batch: GraphBatch, targets: torch.Tensor,
            cfg: DimeNetConfig) -> torch.Tensor:
    out = forward(params, batch, cfg)
    return torch.mean(torch.square(out.float() - targets.float()))
