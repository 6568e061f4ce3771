"""DIN — Deep Interest Network [arXiv:1706.06978] (counterpart of
``repro.models.din``).

Config din: embed_dim=18, seq_len=100, attn_mlp=80-40, mlp=200-80,
interaction=target-attention.

The hot path is the sparse embedding substrate: ``embedding_bag`` is a
gather (``index_select``) and a scatter-add (``index_add_``), as the
reference's is ``jnp.take`` and ``jax.ops.segment_sum``; no Pallas kernel
runs here, so this is plain torch on both devices.

``score_candidates`` scores one user's history against every candidate
(retrieval_cand: 10^6 candidates).  The reference vmaps the activation
unit over all of them at once; at 1,000,448 candidates x seq 100 x 144
features that is a 57.6 GB float32 tensor before the first hidden layer,
so the port scores ``RETRIEVAL_CHUNK`` candidates at a time.  Each
candidate's arithmetic is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..device import DeviceLike, resolve_device, default_generator
from .gnn_common import gather, mlp_apply, mlp_init, normal, segment_sum

RETRIEVAL_CHUNK = 65_536  # candidates scored at a time (3.8 GB of features)


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    n_items: int = 1_000_000
    n_cates: int = 10_000
    n_user_feats: int = 100_000
    dtype: Any = torch.float32


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------

def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain gather; ids < 0 yield zero rows (padding)."""
    safe = torch.clamp(ids, min=0)
    rows = gather(table, safe.reshape(-1)).reshape(
        tuple(ids.shape) + tuple(table.shape[1:]))
    return torch.where((ids >= 0)[..., None], rows, 0)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor, n_bags: int,
                  mode: str = "sum") -> torch.Tensor:
    """torch-style EmbeddingBag: ragged ids + offsets -> (n_bags, d).

    ids: (L,) flat indices; offsets: (n_bags,) bag starts.  Built from a
    gather and a segment sum, as the reference's is.
    """
    L = ids.shape[0]
    rows = embedding_lookup(table, ids)
    pos = torch.arange(L, dtype=offsets.dtype, device=ids.device)
    bag_id = torch.searchsorted(offsets, pos, right=True) - 1
    out = segment_sum(rows, bag_id, n_bags)
    if mode == "mean":
        cnt = segment_sum((ids >= 0).to(rows.dtype), bag_id, n_bags)
        out = out / torch.clamp(cnt, min=1)[:, None]
    return out


# ---------------------------------------------------------------------------
# DIN model
# ---------------------------------------------------------------------------

def init_params(cfg: DINConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's names, shapes, dtypes and scales: N(0, 0.01^2)
    tables and the two MLPs; ``generator`` (default: seed 0 on the target
    device) draws the samples, not ``jax.random``'s numbers."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = default_generator(dev)
    d = cfg.embed_dim

    def table(n):
        return normal(gen, (n, d), 0.01, cfg.dtype, dev)

    # user vector = 2d (item+cate hist) ; candidate = 2d ; user profile = d
    d_cat = 2 * d + 2 * d + d
    return {
        "item_table": table(cfg.n_items),
        "cate_table": table(cfg.n_cates),
        "user_table": table(cfg.n_user_feats),
        # attention MLP input: [h, c, h - c, h * c] over 2d-dim vectors
        "attn": mlp_init(gen, [8 * d, *cfg.attn_mlp, 1], cfg.dtype, dev),
        "mlp": mlp_init(gen, [d_cat, *cfg.mlp, 1], cfg.dtype, dev),
    }


def _hist_embed(params, hist_items, hist_cates):
    return torch.cat([
        embedding_lookup(params["item_table"], hist_items),
        embedding_lookup(params["cate_table"], hist_cates)], dim=-1)


def _cand_embed(params, cand_item, cand_cate):
    return torch.cat([
        embedding_lookup(params["item_table"], cand_item),
        embedding_lookup(params["cate_table"], cand_cate)], dim=-1)


def target_attention(params, hist: torch.Tensor, cand: torch.Tensor,
                     hist_mask: torch.Tensor) -> torch.Tensor:
    """DIN local activation unit.

    hist: (..., S, 2d); cand: (..., 2d) -> user interest vector (..., 2d).
    Weights are NOT softmax-normalized (paper §4.3 keeps intensity).
    """
    c = cand[..., None, :].expand(hist.shape)
    feats = torch.cat([hist, c, hist - c, hist * c], dim=-1)
    w = mlp_apply(params["attn"], feats, act=torch.sigmoid)[..., 0]
    w = torch.where(hist_mask, w, 0.0)
    return (w[..., None, :] @ hist)[..., 0, :]


def forward(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: DINConfig) -> torch.Tensor:
    """CTR logits (B,). batch: hist_items/hist_cates (B,S), cand_item/
    cand_cate (B,), user_id (B,)."""
    hist = _hist_embed(params, batch["hist_items"], batch["hist_cates"])
    cand = _cand_embed(params, batch["cand_item"], batch["cand_cate"])
    mask = batch["hist_items"] >= 0
    interest = target_attention(params, hist, cand, mask)
    user = embedding_lookup(params["user_table"], batch["user_id"])
    z = torch.cat([interest, cand, user], dim=-1)
    return mlp_apply(params["mlp"], z)[..., 0]


def score_candidates(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                     cfg: DINConfig) -> torch.Tensor:
    """retrieval_cand: one user vs (n_cand,) candidates, ``RETRIEVAL_CHUNK``
    at a time.

    batch: hist_items/hist_cates (S,), user_id (), cand_items/cand_cates
    (n_cand,).  Returns (n_cand,) scores, each equal to ``forward`` of
    that candidate.
    """
    hist = _hist_embed(params, batch["hist_items"], batch["hist_cates"])
    mask = batch["hist_items"] >= 0
    user = embedding_lookup(params["user_table"], batch["user_id"])
    n = batch["cand_items"].shape[0]
    chunk = RETRIEVAL_CHUNK
    out = []
    for lo in range(0, n, chunk):
        cands = _cand_embed(params, batch["cand_items"][lo:lo + chunk],
                            batch["cand_cates"][lo:lo + chunk])
        m = cands.shape[0]
        att = target_attention(params, hist.expand(m, *hist.shape), cands,
                               mask.expand(m, *mask.shape))
        z = torch.cat([att, cands, user.expand(m, user.shape[-1])], dim=-1)
        out.append(mlp_apply(params["mlp"], z)[..., 0])
    if not out:
        return hist.new_zeros((0,))
    return torch.cat(out)


def loss_fn(params, batch: Dict[str, torch.Tensor], labels: torch.Tensor,
            cfg: DINConfig) -> torch.Tensor:
    logits = forward(params, batch, cfg).float()
    y = labels.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
