"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron [arXiv:2407.14679; hf]."""
import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec, register
from .lm_common import lm_shapes


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="minitron-4b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=9216, vocab=256000,  # 256000 % 256 == 0
        dtype=torch.bfloat16, attn_chunk=1024)


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="minitron-4b-smoke", n_layers=2, d_model=48, n_heads=4,
        n_kv_heads=2, d_ff=144, vocab=512, dtype=torch.float32, attn_chunk=32)


SPEC = register(ArchSpec(
    arch_id="minitron-4b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(),
    notes="width/depth-pruned nemotron; GQA kv=8; head_dim=128"))
