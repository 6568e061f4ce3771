"""Process-level device setup for the serving entry point (counterpart of
``repro.launch.platform``).

A long-lived process makes its device decisions once, at start, before
its first tensor: ``launch.serve.main`` calls ``setup_platform`` ahead of
any device use, as the reference's does.  The reference's knobs map onto
the port's device policy (``device.py``):

  platform        — "cpu" makes ``device=None`` the CPU for the process;
                    "gpu" keeps it the card (the default).  The
                    reference's "tpu" has no counterpart.
  cpu_devices     — how many slots a host mesh over the CPU gets
                    (``launch.mesh.make_named_host_mesh`` and
                    ``make_host_mesh`` with a CPU device), clamped to the
                    machine's core count with the reference's warning.

jax's 64-bit switch and XLA's flags have no torch counterpart: asking for
either raises ``ValueError`` naming the knob, so no request is taken and
then ignored.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Iterable, Optional

from .. import device as _device


def setup_platform(platform: Optional[str] = None, *,
                   cpu_devices: Optional[int] = None,
                   enable_x64: Optional[bool] = None,
                   extra_xla_flags: Iterable[str] = ()) -> Dict[str, Any]:
    """Apply the process's device choices, once, before any device use.

    Returns the reference's record of what was applied: every key None
    when nothing was asked.  ``xla_flags`` and ``enable_x64`` stay None,
    since asking for them raises."""
    if enable_x64 is not None:
        raise ValueError("enable_x64: torch has no process-wide 64-bit "
                         "switch; the port's dtypes are set per tensor")
    flags = list(extra_xla_flags)
    if flags:
        raise ValueError(f"extra_xla_flags {flags}: XLA flags have no "
                         f"counterpart in the port")
    if platform is not None and platform not in _device.PLATFORMS:
        raise ValueError(f"platform {platform!r}: the port runs on "
                         f"{_device.PLATFORMS}")
    if cpu_devices is not None and int(cpu_devices) < 1:
        raise ValueError(f"cpu_devices must be >= 1, got {cpu_devices}")
    applied: Dict[str, Any] = {"platform": None, "cpu_devices": None,
                               "enable_x64": None, "xla_flags": None}
    if platform is not None:
        _device.set_platform(platform)
        applied["platform"] = platform
    if cpu_devices is not None:
        n = int(cpu_devices)
        total = os.cpu_count() or 1
        if n > total:
            warnings.warn(
                f"requested {n} host devices but only {total} cores are "
                f"available; using {total}", RuntimeWarning)
            n = total
        _device.set_cpu_slots(n)
        applied["cpu_devices"] = n
    return applied
