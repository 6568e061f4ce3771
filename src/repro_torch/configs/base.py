"""Arch registry plumbing: every config module registers an ArchSpec
(counterpart of ``repro.configs.base``).

An ArchSpec knows how to build (a) the FULL published config, (b) a
REDUCED smoke config and (c) ``input_specs(cfg, cell)``: the cell's inputs
(its batch, and a decode cell's cache) as ``meta`` tensors of the
reference's shapes and dtypes, which ``launch.dryrun`` runs the steps on
without allocating.  ``meta_spec`` is the reference's ``sds``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

_REGISTRY: Dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (arch x input-shape) cell."""

    name: str
    kind: str                     # train | prefill | decode | serve | retrieval
    dims: Dict[str, int]
    skip_reason: Optional[str] = None   # e.g. long_500k on full attention


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                   # "lm" | "core" | "gnn" | "recsys"
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: Tuple[ShapeCell, ...]
    input_specs: Callable[[Any, ShapeCell], Dict[str, Any]]
    notes: str = ""

    def shape(self, name: str) -> ShapeCell:
        for c in self.shapes:
            if c.name == name:
                return c
        raise KeyError(f"{self.arch_id}: unknown shape {name}")


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_archs():
    return dict(_REGISTRY)


def meta_spec(shape: Sequence[int],
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on ``meta``: shapes only,
    nothing allocated (the reference's ``sds``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a shardable multiple (noted per config)."""
    return -(-v // multiple) * multiple
