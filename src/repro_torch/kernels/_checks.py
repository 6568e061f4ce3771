"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

from typing import Sequence

import torch

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def kernel_device(tensors: Sequence[torch.Tensor], name: str) -> torch.device:
    """The one device every tensor lies on (raises on a mix)."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    return dev


def need(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def need_int32(x: int, name: str) -> int:
    x = int(x)
    if not INT32_MIN <= x <= INT32_MAX:
        raise ValueError(f"{name}={x} does not fit int32")
    return x
