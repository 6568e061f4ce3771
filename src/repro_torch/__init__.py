"""PyTorch/CUDA port of the parallel (r, s) nucleus decomposition.

The package mirrors ``src/repro/`` module for module (``graph/``,
``kernels/``, ``core/``) and name for name, so each function has an obvious
counterpart in the JAX package.  It imports torch and numpy only.

Device policy (``repro_torch.device``): every entry point takes
``device=None``, which means ``"cuda"``.  Without a card the entry points
raise and name ``device="cpu"``; they never fall back to the CPU silently.
On CUDA tensors the peel round runs the hand-written Hopper kernels in
``repro_torch/kernels/csrc``; on CPU tensors the same wrappers run their
plain-torch versions.
"""
from .device import resolve_device
from .core.api import (ConfigError, Decomposition, Nucleus, NucleusConfig,
                       decompose)
from .core.backends import Plan
from .core.incidence import NucleusProblem, build_problem
from .core.session import Session
from .core.streaming import GraphDelta, UpdateStats

__all__ = ["resolve_device", "ConfigError", "Decomposition", "Nucleus",
           "NucleusConfig", "Plan", "decompose", "NucleusProblem",
           "build_problem", "Session", "GraphDelta", "UpdateStats"]
