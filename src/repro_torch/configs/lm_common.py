"""Shared shape grid of the LM-family architectures (counterpart of
``repro.configs.lm_common``; its ``lm_input_specs`` belongs to the
reference's dry run and has no counterpart)."""
from __future__ import annotations

from .base import ShapeCell

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
