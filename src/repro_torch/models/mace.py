"""MACE — higher-order equivariant message passing [arXiv:2206.07697]
(counterpart of ``repro.models.mace``).

Config mace: n_layers=2, d_hidden=128, l_max=2, correlation_order=3, n_rbf=8.

As in the reference, irreps are carried in CARTESIAN form —
  l=0: scalars            (N, C)
  l=1: vectors            (N, C, 3)
  l=2: traceless symmetric rank-2 tensors (N, C, 3, 3)
Clebsch-Gordan tensor products for l <= 2 become exact Cartesian identities
(dot, cross, outer-traceless, matvec, double-contraction), so the model is
exactly E(3)-equivariant (property-tested under random rotations) without
Wigner matrices.  The Atomic Cluster Expansion (correlation order 3) is the
set of degree-<=3 invariant/covariant polynomial contractions of the
aggregated one-particle basis A.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, default_generator
from .gnn_common import (GraphBatch, gather, mlp_apply, mlp_init, normal,
                         radial_basis, segment_sum)


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128        # channels C per irrep
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    d_in: int = 16
    n_out: int = 1
    cutoff: float = 5.0
    dtype: Any = torch.float32

    @property
    def n_paths(self) -> int:
        return 10  # edge-basis paths below


def _sym_traceless(t: torch.Tensor) -> torch.Tensor:
    """Project (.., 3, 3) onto the l=2 irrep: symmetric, trace-free."""
    s = 0.5 * (t + t.transpose(-1, -2))
    tr = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    return s - tr * eye / 3.0


def _mix(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Channel mixing (C_out, C_in) applied on axis 1 of (N, C_in, ...)."""
    return torch.einsum("oc,nc...->no...", w, x)


def init_params(cfg: MACEConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's names, shapes, dtypes and scales: N(0, 1/C) channel
    mixers, N(0, 0.3^2) product-basis weights."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = default_generator(dev)
    C, dt = cfg.d_hidden, cfg.dtype

    def mixer():
        return normal(gen, (C, C), 1.0 / np.sqrt(C), dt, dev)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            # radial MLP: per-path, per-channel weights R(r)
            "radial": mlp_init(gen, [cfg.n_rbf, 64, cfg.n_paths * C], dt,
                               dev),
            # per-path channel mixers for message construction
            "mix_s": mixer(), "mix_v": mixer(), "mix_t": mixer(),
            # ACE product-basis mixing weights (one per contraction path)
            "b0": normal(gen, (8, C), 0.3, dt, dev),
            "b1": normal(gen, (5, C), 0.3, dt, dev),
            "b2": normal(gen, (5, C), 0.3, dt, dev),
            "upd_s": mixer(), "upd_v": mixer(), "upd_t": mixer(),
            "res_s": mixer(), "res_v": mixer(), "res_t": mixer(),
            "gate": mlp_init(gen, [C, 2 * C], dt, dev),
        })
    return {
        "encode": mlp_init(gen, [cfg.d_in, C], dt, dev),
        "layers": layers,
        "readout": mlp_init(gen, [C, C, cfg.n_out], dt, dev),
    }


def _edge_basis(s_j, v_j, t_j, rhat, R):
    """One-particle basis phi: covariant products of neighbor features with
    Y_0(r)=1, Y_1(r)=rhat, Y_2(r)=rhat rhat^T - I/3.  R: (E, n_paths, C)."""
    eye = torch.eye(3, dtype=s_j.dtype, device=s_j.device)
    y2 = rhat[:, None, :] * rhat[:, :, None] - eye / 3.0       # (E, 3, 3)
    y2 = y2[:, None]                                           # (E, 1, 3, 3)
    rh = rhat[:, None]                                         # (E, 1, 3)
    # scalar outputs
    a0 = (R[:, 0] * s_j,                                       # s * Y0
          R[:, 1] * torch.einsum("eck,ek->ec", v_j, rhat),     # v . rhat
          R[:, 2] * torch.einsum("ecij,eij->ec", t_j,
                                 y2[:, 0]))                    # t : Y2
    # vector outputs
    a1 = (R[:, 3, :, None] * (s_j[..., None] * rh),            # s * Y1
          R[:, 4, :, None] * v_j,                              # v * Y0
          R[:, 5, :, None] * torch.linalg.cross(
              v_j, rh.expand(v_j.shape), dim=-1),              # v x rhat
          R[:, 6, :, None] * torch.einsum("ecij,ej->eci", t_j, rhat))
    # tensor outputs
    a2 = (R[:, 7, :, None, None] * (s_j[..., None, None] * y2),
          R[:, 8, :, None, None] * _sym_traceless(
              v_j[..., :, None] * rh[..., None, :]),           # v (x) rhat
          R[:, 9, :, None, None] * t_j)                        # t * Y0
    return sum(a0[1:], a0[0]), sum(a1[1:], a1[0]), sum(a2[1:], a2[0])


def _ace_products(A0, A1, A2, lp):
    """Correlation-order <= 3 contractions of the aggregated basis A."""
    def dot(a, b):
        return torch.einsum("nci,nci->nc", a, b)

    def ddot(a, b):
        return torch.einsum("ncij,ncij->nc", a, b)

    def matvec(t, v):
        return torch.einsum("ncij,ncj->nci", t, v)

    # invariants (order 1, 2, 3)
    b0 = (lp["b0"][0] * A0
          + lp["b0"][1] * A0 * A0
          + lp["b0"][2] * dot(A1, A1)
          + lp["b0"][3] * ddot(A2, A2)
          + lp["b0"][4] * A0 * A0 * A0
          + lp["b0"][5] * A0 * dot(A1, A1)
          + lp["b0"][6] * dot(A1, matvec(A2, A1))
          + lp["b0"][7] * A0 * ddot(A2, A2))
    # covariant l=1 (order <= 3)
    b1 = (lp["b1"][0][:, None] * A1
          + lp["b1"][1][:, None] * (A0[..., None] * A1)
          + lp["b1"][2][:, None] * matvec(A2, A1)
          + lp["b1"][3][:, None] * (A0[..., None] ** 2 * A1)
          + lp["b1"][4][:, None] * (A0[..., None] * matvec(A2, A1)))
    # covariant l=2 (order <= 3)
    outer11 = _sym_traceless(A1[..., :, None] * A1[..., None, :])
    b2 = (lp["b2"][0][:, None, None] * A2
          + lp["b2"][1][:, None, None] * (A0[..., None, None] * A2)
          + lp["b2"][2][:, None, None] * outer11
          + lp["b2"][3][:, None, None] * (A0[..., None, None] ** 2 * A2)
          + lp["b2"][4][:, None, None] * _sym_traceless(
              torch.einsum("ncik,nckj->ncij", A2, A2)))
    return b0, b1, b2


def forward(params: Dict[str, Any], batch: GraphBatch, cfg: MACEConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (graph outputs, final node irreps {s, v, t})."""
    if batch.pos is None:
        raise ValueError("MACE requires positions")
    x = batch.pos.to(cfg.dtype)
    src, dst, em = batch.edge_src, batch.edge_dst, batch.edge_mask
    N, C = batch.n_nodes, cfg.d_hidden
    rel = gather(x, dst) - gather(x, src)
    dist = torch.sqrt(torch.clamp(torch.sum(rel * rel, -1), min=1e-12))
    rhat = rel / dist[:, None]
    rbf = radial_basis(dist, cfg.n_rbf, cfg.cutoff).to(cfg.dtype)

    s = mlp_apply(params["encode"], batch.nodes.to(cfg.dtype))  # (N, C)
    v = s.new_zeros((N, C, 3))
    t = s.new_zeros((N, C, 3, 3))
    nm = batch.node_mask
    energy = 0.0
    for lp in params["layers"]:
        R = mlp_apply(lp["radial"], rbf).reshape(-1, cfg.n_paths, C)
        R = R * em[:, None, None]
        s_j = gather(_mix(lp["mix_s"], s), src)
        v_j = gather(_mix(lp["mix_v"], v), src)
        t_j = gather(_mix(lp["mix_t"], t), src)
        p0, p1, p2 = _edge_basis(s_j, v_j, t_j, rhat, R)
        A0 = segment_sum(p0, dst, N)
        A1 = segment_sum(p1, dst, N)
        A2 = segment_sum(p2, dst, N)
        B0, B1, B2 = _ace_products(A0, A1, A2, lp)
        # gated residual update (gates are invariant functions of B0)
        g = mlp_apply(lp["gate"], B0)
        g1, g2 = torch.chunk(torch.sigmoid(g), 2, dim=-1)
        s = _mix(lp["res_s"], s) + _mix(lp["upd_s"], B0)
        v = _mix(lp["res_v"], v) + g1[..., None] * _mix(lp["upd_v"], B1)
        t = _mix(lp["res_t"], t) + g2[..., None, None] * _mix(lp["upd_t"],
                                                              B2)
        s = torch.where(nm[:, None], s, 0)
        v = torch.where(nm[:, None, None], v, 0)
        t = torch.where(nm[:, None, None, None], t, 0)
        energy = energy + mlp_apply(params["readout"], s)
    pooled = segment_sum(energy, batch.graph_id, batch.n_graphs)
    return pooled, {"s": s, "v": v, "t": t}


def loss_fn(params, batch: GraphBatch, targets: torch.Tensor,
            cfg: MACEConfig) -> torch.Tensor:
    out, _ = forward(params, batch, cfg)
    return torch.mean(torch.square(out.float() - targets.float()))
