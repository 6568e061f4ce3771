"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352  [hf:stabilityai/stablelm-2-12b; hf]."""
import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec, register, pad_vocab
from .lm_common import lm_shapes


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-12b", n_layers=40, d_model=5120, n_heads=32,
        n_kv_heads=8, d_ff=13824, vocab=pad_vocab(100352),  # 100352 % 256 == 0
        dtype=torch.bfloat16, attn_chunk=1024)


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-12b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=512, dtype=torch.float32, attn_chunk=32)


SPEC = register(ArchSpec(
    arch_id="stablelm-12b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(),
    notes="dense GQA decoder; head_dim=160"))
