"""din [recsys]: embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
interaction=target-attn [arXiv:1706.06978; paper].

Embedding tables: 10^6 items / 10^4 categories / 10^5 user features
(the EmbeddingBag substrate in ``repro_torch.models.din``).  The
retrieval cell's 10^6 candidates are padded to a multiple of 512
(``n_candidates_padded``), as the reference pads them; the pad rows are
scored and dropped by the caller.
"""
import torch

from ..models.din import DINConfig
from .base import ArchSpec, register, ShapeCell, meta_spec

SHAPES = (
    ShapeCell("train_batch", "train", {"batch": 65_536}),
    ShapeCell("serve_p99", "serve", {"batch": 512}),
    ShapeCell("serve_bulk", "serve", {"batch": 262_144}),
    ShapeCell("retrieval_cand", "retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
)


def n_candidates_padded(cell: ShapeCell) -> int:
    """The retrieval cell's candidates padded to a multiple of 512
    (1,000,000 -> 1,000,448)."""
    return -(-cell.dims["n_candidates"] // 512) * 512


def make_config() -> DINConfig:
    return DINConfig(name="din", embed_dim=18, seq_len=100,
                     attn_mlp=(80, 40), mlp=(200, 80),
                     n_items=1_000_000, n_cates=10_000, n_user_feats=100_000)


def make_smoke_config() -> DINConfig:
    return DINConfig(name="din-smoke", embed_dim=8, seq_len=12,
                     attn_mlp=(16, 8), mlp=(24, 12),
                     n_items=1_000, n_cates=50, n_user_feats=100)


def input_specs(cfg: DINConfig, cell: ShapeCell):
    """A cell's batch on ``meta``: one user's history and the padded
    candidates for retrieval; else B rows of history, candidate and user,
    with the labels for training."""
    B = cell.dims["batch"]
    S = cfg.seq_len
    if cell.kind == "retrieval":
        NC = n_candidates_padded(cell)
        return {"batch": {
            "hist_items": meta_spec((S,), torch.int32),
            "hist_cates": meta_spec((S,), torch.int32),
            "user_id": meta_spec((), torch.int32),
            "cand_items": meta_spec((NC,), torch.int32),
            "cand_cates": meta_spec((NC,), torch.int32),
        }}
    batch = {
        "hist_items": meta_spec((B, S), torch.int32),
        "hist_cates": meta_spec((B, S), torch.int32),
        "cand_item": meta_spec((B,), torch.int32),
        "cand_cate": meta_spec((B,), torch.int32),
        "user_id": meta_spec((B,), torch.int32),
    }
    if cell.kind == "train":
        batch["label"] = meta_spec((B,), torch.float32)
    return {"batch": batch}


SPEC = register(ArchSpec(
    arch_id="din", family="recsys",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=SHAPES, input_specs=input_specs,
    notes="target-attention CTR; EmbeddingBag = gather + segment sum"))
