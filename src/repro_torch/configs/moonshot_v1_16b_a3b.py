"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 — kimi/moonlight
[hf:moonshotai/Moonlight-16B-A3B; hf].

d_ff=1408 is the PER-EXPERT hidden dim (the "a3b" active-3B pattern); 2
shared experts carry the always-on path, matching the Moonlight block.
"""
import torch

from ..models.transformer import MoEConfig, TransformerConfig
from .base import ArchSpec, register
from .lm_common import lm_input_specs, lm_shapes


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab=163840,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
        dtype=torch.bfloat16, attn_chunk=1024)


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=96, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, n_shared=1),
        dtype=torch.float32, attn_chunk=32, remat=False)


SPEC = register(ArchSpec(
    arch_id="moonshot-v1-16b-a3b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(), input_specs=lm_input_specs,
    notes="MoE 64e top-6 + 2 shared, expert parallel over 'model'"))
