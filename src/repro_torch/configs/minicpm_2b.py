"""minicpm-2b [dense]: 40L d_model=2304 36H (GQA kv=36 = MHA) d_ff=5760
vocab=122753 — WSD schedule (llama-like) [arXiv:2404.06395; hf].

vocab padded 122753 -> 122880 (multiple of 256), as in the reference; the
pad rows are never emitted.
"""
import torch

from ..models.transformer import TransformerConfig
from .base import ArchSpec, register, pad_vocab
from .lm_common import lm_input_specs, lm_shapes


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="minicpm-2b", n_layers=40, d_model=2304, n_heads=36,
        n_kv_heads=36, d_ff=5760, vocab=pad_vocab(122753),  # -> 122880
        dtype=torch.bfloat16, attn_chunk=1024)


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="minicpm-2b-smoke", n_layers=2, d_model=72, n_heads=6,
        n_kv_heads=6, d_ff=180, vocab=512, dtype=torch.float32, attn_chunk=32,
        remat=False)


SPEC = register(ArchSpec(
    arch_id="minicpm-2b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(), input_specs=lm_input_specs,
    notes="dense MHA decoder (kv=36); WSD schedule; head_dim=64"))
