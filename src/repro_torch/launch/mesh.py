"""Device meshes (counterpart of ``repro.launch.mesh``).

Two kinds, both driven by one controller in one process, as the
reference drives a ``jax.sharding.Mesh``:

* ``Mesh``, the sharded nucleus lane's one axis: a plain tuple of torch
  devices; ``core.distributed`` puts slab ``i`` of the s-clique axis on
  ``mesh[i]``.  Devices may repeat: ``Mesh(("cuda:0",) * 4)`` is four
  slabs on one card, which shares one copy of the replicated state and
  reduces on that card; distinct cards reduce through NCCL.
* ``NamedMesh``, the counterpart of ``jax.make_mesh``: named axes
  (``("data", "model")``, ``("pod", "data", "model")``) and one slot per
  coordinate in row-major order, each slot a torch device; slots may
  repeat a device as ``Mesh`` allows, which is how four slots live on
  one card.  ``distributed.sharding`` places tensors over its slots.
  ``AbstractMesh`` is its shape alone (names and sizes, no devices): the
  spec functions take either, so a 16 x 16 production mesh
  (``make_production_mesh``) can be asked about without its chips.

The card machine shows one GPU and NCCL refuses two ranks on one GPU, so
a named mesh is not ``torch.distributed``: its slots are places for
tensors, not processes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Sequence, Tuple, Union

import torch

from .. import device as _device
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
    return Mesh(_host_devices(resolve_device(device)))


def _host_devices(dev: torch.device) -> Tuple[torch.device, ...]:
    """Every visible card for a CUDA ``dev``; for the CPU, as many CPU
    slots as ``launch.platform.setup_platform(cpu_devices=)`` asked for
    (one by default)."""
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,) * _device.cpu_slots()


# ---------------------------------------------------------------------------
# named meshes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices (``jax.sharding.AbstractMesh``)."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        sizes = tuple(int(n) for n in self.axis_sizes)
        names = tuple(self.axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh needs one distinct name per axis, "
                             f"got sizes {sizes} and names {names}")
        if any(n < 1 for n in sizes):
            raise ValueError(f"mesh axis sizes must be >= 1, got {sizes}")
        object.__setattr__(self, "axis_sizes", sizes)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, slot: int) -> Dict[str, int]:
        """The slot's coordinate on each axis (row-major: the last axis
        varies fastest)."""
        out = {}
        for name, n in zip(reversed(self.axis_names),
                           reversed(self.axis_sizes)):
            slot, out[name] = divmod(slot, n)
        return {name: out[name] for name in self.axis_names}


@dataclasses.dataclass(frozen=True)
class NamedMesh(AbstractMesh):
    """A named mesh with a device per slot, slots in row-major order."""
    slots: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        super().__post_init__()
        slots = tuple(_indexed(torch.device(d)) for d in self.slots)
        if len(slots) != self.size:
            raise ValueError(f"a {self.axis_sizes} mesh has {self.size} "
                             f"slots, got {len(slots)} devices")
        if len({d.type for d in slots}) > 1:
            raise ValueError(f"a mesh is all CPU or all CUDA devices, got "
                             f"{[str(d) for d in slots]}")
        object.__setattr__(self, "slots", slots)

    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in order of first use."""
        return tuple(dict.fromkeys(self.slots))

    def __repr__(self) -> str:
        return (f"NamedMesh({self.shape}, "
                f"{[str(d) for d in self.distinct()]})")


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices: Union[None, DeviceLike, Sequence[DeviceLike]] = None
              ) -> NamedMesh:
    """A named mesh (``jax.make_mesh``).  ``devices=None`` takes every
    visible card and raises without one; a device, or a sequence of them,
    is used as given.  Slot ``i`` gets ``devices[i % len(devices)]``, so
    slots that outnumber the devices repeat them in order."""
    if devices is None:
        devs = _host_devices(resolve_device(None))
    elif isinstance(devices, (str, torch.device)):
        devs = (resolve_device(devices),)
    else:
        devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    n = math.prod(int(a) for a in axis_sizes)
    return NamedMesh(tuple(axis_sizes), tuple(axis_names),
                     tuple(devs[i % len(devs)] for i in range(n)))


def make_named_host_mesh(model_parallel: int = 1,
                         device: DeviceLike = None) -> NamedMesh:
    """Whatever this host has (the reference's ``make_host_mesh``): a
    ("data", "model") mesh over every visible card, or the CPU's slots
    when the caller passes a CPU device, ``model_parallel`` of them on
    the model axis."""
    devs = _host_devices(resolve_device(device))
    if len(devs) % model_parallel:
        raise ValueError(f"{len(devs)} devices do not split into "
                         f"model_parallel={model_parallel}")
    return make_mesh((len(devs) // model_parallel, model_parallel),
                     ("data", "model"), devs)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh, shape only: 16 x 16 = 256 chips
    a pod; ``multi_pod`` adds a leading 2-pod axis."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))
