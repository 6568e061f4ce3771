"""Shared shape grid and input specs of the LM-family architectures
(counterpart of ``repro.configs.lm_common``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .base import ShapeCell, meta_spec

FULL_ATTN_SKIP = ("pure full-attention architecture (GQA/MLA softmax "
                  "attention): long_500k requires sub-quadratic attention; "
                  "skipped per the shape-grid rules, see DESIGN.md §5")


def lm_shapes() -> tuple:
    return (
        ShapeCell("train_4k", "train",
                  {"seq_len": 4096, "global_batch": 256}),
        ShapeCell("prefill_32k", "prefill",
                  {"seq_len": 32768, "global_batch": 32}),
        ShapeCell("decode_32k", "decode",
                  {"seq_len": 32768, "global_batch": 128}),
        ShapeCell("long_500k", "decode",
                  {"seq_len": 524288, "global_batch": 1},
                  skip_reason=FULL_ATTN_SKIP),
    )


def lm_input_specs(cfg, cell: ShapeCell) -> Dict[str, Any]:
    """train: {"batch": tokens, labels (B, S) int32}; prefill: {"batch":
    tokens}; decode: {"tokens" (B, 1), "cache" (the stacked cache of
    ``transformer.init_cache``, S slots), "cache_len" () int32}."""
    B = cell.dims["global_batch"]
    S = cell.dims["seq_len"]
    if cell.kind == "train":
        return {"batch": {"tokens": meta_spec((B, S), torch.int32),
                          "labels": meta_spec((B, S), torch.int32)}}
    if cell.kind == "prefill":
        return {"batch": {"tokens": meta_spec((B, S), torch.int32)}}
    if cell.kind == "decode":
        L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        if cfg.mla is not None:
            r, pr = cfg.mla.kv_lora_rank, cfg.mla.rope_head_dim
            cache = (meta_spec((L, B, S, r), cfg.dtype),
                     meta_spec((L, B, S, 1, pr), cfg.dtype))
        else:
            cache = (meta_spec((L, B, S, Hkv, D), cfg.dtype),
                     meta_spec((L, B, S, Hkv, D), cfg.dtype))
        return {"tokens": meta_spec((B, 1), torch.int32),
                "cache": cache,
                "cache_len": meta_spec((), torch.int32)}
    raise ValueError(cell.kind)
