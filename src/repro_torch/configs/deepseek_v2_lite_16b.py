"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408 vocab=102400,
MoE 64e top-6, MLA kv_lora=512, 2 shared experts [arXiv:2405.04434].

64 routed experts, as in the reference (the HF config's 160-expert variant
is not this one).  MLA caches the 512-dim latent + 64 shared-rope dims per
token instead of full K/V: the cache is ~5.7x smaller than GQA kv=16 would
be at the same shape.
"""
import torch

from ..models.transformer import MLAConfig, MoEConfig, TransformerConfig
from .base import ArchSpec, register
from .lm_common import lm_input_specs, lm_shapes


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab=102400,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
        mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64),
        dtype=torch.bfloat16, attn_chunk=1024)


def make_smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=96, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, n_shared=1),
        mla=MLAConfig(kv_lora_rank=16, rope_head_dim=8),
        dtype=torch.float32, attn_chunk=32, remat=False)


SPEC = register(ArchSpec(
    arch_id="deepseek-v2-lite-16b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(), input_specs=lm_input_specs,
    notes="MLA (kv_lora=512, rope_dim=64) + MoE 64e top-6 + 2 shared"))
