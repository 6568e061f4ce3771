"""The port's device policy: ``device=None`` means the card.

Entry points (``decompose``, ``build_problem``, ``dense_coreness``) resolve
their ``device`` argument here.  A caller who wants the CPU says so with
``device="cpu"``; with no card and no explicit device the call raises
instead of carrying on quietly on the CPU.

A process may ask once, at start, for another default
(``launch.platform.setup_platform``, the counterpart of jax's platform
pick): ``set_platform("cpu")`` makes ``device=None`` the CPU, and
``set_cpu_slots(n)`` gives a CPU host mesh ``n`` slots.  Both are
process-wide, as jax's configuration is.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]

PLATFORMS = ("cpu", "gpu")
_platform: Optional[str] = None   # None: the card
_cpu_slots = 1


def set_platform(platform: Optional[str]) -> None:
    """The default device of ``resolve_device(None)`` for the process:
    ``"cpu"``, ``"gpu"`` (the card) or None (the card)."""
    global _platform
    if platform is not None and platform not in PLATFORMS:
        raise ValueError(f"platform {platform!r}: the port runs on "
                         f"{PLATFORMS}")
    _platform = platform


def set_cpu_slots(n: int) -> None:
    """How many slots a host mesh over the CPU gets (default 1)."""
    global _cpu_slots
    if n < 1:
        raise ValueError(f"cpu slots must be >= 1, got {n}")
    _cpu_slots = int(n)


def cpu_slots() -> int:
    return _cpu_slots


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raising without a card), or the CPU after
    ``set_platform("cpu")``; else as given."""
    if device is None:
        if _platform == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run "
                "the plain-torch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} was requested but no CUDA device is "
            f"available; pass device=\"cpu\" to run on the CPU")
    return dev


def same_device(a: torch.device, b: Optional[torch.device]) -> bool:
    """Device equality that treats ``cuda`` and ``cuda:<current>`` alike."""
    if b is None or a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == \
        (b.index if b.index is not None else cur)


def default_generator(dev: torch.device) -> Optional[torch.Generator]:
    """The models' default draw: a generator seeded 0 on ``dev``; None on
    the ``meta`` device, where ``init_params`` draws nothing and gives the
    parameters' shapes and dtypes alone."""
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(0)
