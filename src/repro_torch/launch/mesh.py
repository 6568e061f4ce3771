"""Device meshes of the sharded nucleus lane (counterpart of
``repro.launch.mesh.make_host_mesh``).

The reference's sharded peel is one controller: ``shard_map`` over a
``jax.sharding.Mesh`` inside one process.  The port keeps that shape: a
``Mesh`` is a plain tuple of torch devices, and ``core.distributed`` puts
slab ``i`` of the s-clique axis on ``mesh[i]``, one process driving them
all.  Devices may repeat: ``Mesh(("cuda:0",) * 4)`` is four slabs on one
card, which shares one copy of the replicated state and reduces on that
card; distinct cards reduce through NCCL.
"""
from __future__ import annotations

from typing import Iterable

import torch

from ..device import DeviceLike, resolve_device


class Mesh(tuple):
    """A hashable, value-compared tuple of ``torch.device``.

    ``cuda`` without an index means the current card.  A mesh is all CPU
    or all CUDA: a mix raises ``ValueError``."""

    def __new__(cls, devices: Iterable[DeviceLike]):
        devs = tuple(_indexed(torch.device(d)) for d in devices)
        if not devs:
            raise ValueError("a Mesh needs at least one device")
        kinds = sorted({d.type for d in devs})
        if len(kinds) > 1:
            raise ValueError(f"a Mesh is all CPU or all CUDA devices, got "
                             f"{kinds}: {[str(d) for d in devs]}")
        return super().__new__(cls, devs)

    def distinct(self) -> tuple:
        """The mesh's devices without repeats, in order of first use."""
        return tuple(dict.fromkeys(self))

    def __repr__(self) -> str:
        return f"Mesh({tuple(str(d) for d in self)!r})"


def _indexed(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None and \
            torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_host_mesh(device: DeviceLike = None) -> Mesh:
    """Every visible card (``device=None`` or any CUDA device), or the
    CPU when the caller passes a CPU device.  Without a card and without
    ``device="cpu"`` this raises, as ``device.resolve_device`` does."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return Mesh(torch.device("cuda", i)
                    for i in range(torch.cuda.device_count()))
    return Mesh((dev,))
