"""Step functions of the LM family, serve side (counterpart of
``repro.launch.steps``'s ``lm_prefill_step`` and ``lm_decode_step``).

The train steps, the GNN and the recsys steps are not yet ported.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import transformer as T


def lm_prefill_step(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                    cfg: T.TransformerConfig) -> torch.Tensor:
    """Inference prefill: forward over the full prompt, loss-free.

    Returns ``argmax(logits[:, -1])``, as the reference does, but unembeds
    only the last position: the norm and the unembedding act on each
    position alone, so the result is the same, and at S = 32,768 the full
    logits (8 GB in bf16 at minicpm-2b's vocab) are never made.
    """
    x = T.trunk(params, batch["tokens"], cfg)
    logits = T.head(params, x[:, -1], cfg)
    return torch.argmax(logits, dim=-1)


def lm_decode_step(params: Dict[str, Any], tokens: torch.Tensor, cache: Any,
                   cache_len: int, cfg: T.TransformerConfig):
    """One token for every sequence in the batch against a full KV cache.

    Returns (next tokens (B,), cache, new_len); the cache is updated in
    place (``transformer.decode_step``).
    """
    logits, cache, new_len = T.decode_step(params, tokens, cache, cache_len,
                                           cfg)
    return torch.argmax(logits[:, -1], dim=-1), cache, new_len
