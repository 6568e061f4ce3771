"""Optimizer of the port (counterpart of ``repro.optim``): AdamW, its
schedules, clipping and PowerSGD compression (``adamw``)."""
from .adamw import (AdamWConfig, AdamWState, init_state, apply_updates,
                    schedule_lr, global_norm, clip_by_global_norm,
                    CompressionState, init_compression, compress_grads,
                    decompress_grads)
