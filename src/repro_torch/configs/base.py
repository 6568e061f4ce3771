"""Arch registry plumbing: every config module registers an ArchSpec
(counterpart of ``repro.configs.base``).

An ArchSpec knows how to build (a) the FULL published config and (b) a
REDUCED smoke config.  The reference's third member, ``input_specs`` (the
``jax.ShapeDtypeStruct`` stand-ins of its dry run), and its helper ``sds``
have no counterpart: the port has no dry run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

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
    family: str                   # "lm" (the only family ported so far)
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: Tuple[ShapeCell, ...]
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


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a shardable multiple (noted per config)."""
    return -(-v // multiple) * multiple
