"""Measured planner thresholds: the profile file and its loader.

Counterpart of ``repro.core.planner_profile``.  ``resolve_plan``'s decision
constants (``TINY_NR``, the size below which the eager gather loop beats
the dense engine; ``SHARD_MIN_INCIDENCE``, the shard-vs-single-device
crossover) and the ``use_kernel=None`` default can be measured per device
kind and written to ``planner_profile.json`` next to this file:

  * the port's own file holds one entry, measured on an H100 by
    ``python -m repro_torch.tools.calibrate_planner`` and keyed by the
    platform (``"cuda"``) and by the card's name; it has no ``cpu`` entry,
    so on the CPU the static constants below apply and the Plan reasons
    say ``static defaults``;
  * ``resolve_plan`` and ``engine.kernel_by_default`` read the profile
    through the loaders here, and record which entry fired (or that none
    did);
  * a missing file, malformed JSON or an uncovered device kind degrades to
    the static constants, with a warning the first time for a malformed
    file or an unmeasured kernel default.

Lookup is by device kind first, then platform.  The port passes the torch
device type (``"cuda"`` or ``"cpu"``) for both.

Import-light on purpose (json/os only): ``backends`` imports this at
module load.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Optional, Tuple

FORMAT = "repro.planner-profile"
VERSION = 1
PROFILE_PATH = os.path.join(os.path.dirname(__file__),
                            "planner_profile.json")

# the static fallback when no profile entry covers the device
# (backends.py re-exports them as TINY_NR / SHARD_MIN_INCIDENCE)
STATIC_TINY_NR = 64
STATIC_SHARD_MIN_INCIDENCE = 1 << 20

_CACHE: Dict[str, Optional[Dict[str, Any]]] = {}
_WARNED: set = set()


def _warn_once(key: str, message: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(message, stacklevel=3)


def load_profile(path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The parsed profile dict, or None (missing/malformed file — each
    malformed file warns once and then degrades to the static constants).
    Cached per path; ``reset_cache()`` drops the cache (tests)."""
    path = path or PROFILE_PATH
    if path in _CACHE:
        return _CACHE[path]
    prof: Optional[Dict[str, Any]] = None
    if os.path.exists(path):
        try:
            with open(path) as f:
                blob = json.load(f)
            if blob.get("format") != FORMAT or "profiles" not in blob:
                raise ValueError(
                    f"expected format={FORMAT!r} with a 'profiles' map, "
                    f"got keys {sorted(blob)}")
            prof = blob
        except (ValueError, OSError) as e:
            _warn_once(f"malformed:{path}",
                       f"planner profile {path} is unreadable ({e}); "
                       f"falling back to the static planner constants")
    return _CACHE.setdefault(path, prof)


def reset_cache() -> None:
    """Drop the load cache and warn-once state (test isolation)."""
    _CACHE.clear()
    _WARNED.clear()


def profile_entry(device_kind: Optional[str] = None,
                  platform: Optional[str] = None,
                  path: Optional[str] = None
                  ) -> Tuple[Optional[Dict[str, Any]], str]:
    """(entry, source_tag) for this device: the most specific profile
    entry (device kind beats platform), or (None, "static defaults")."""
    prof = load_profile(path)
    if prof is not None:
        profiles = prof["profiles"]
        for key in (device_kind, platform):
            if key and key in profiles:
                return profiles[key], f"planner_profile[{key!r}]"
    return None, "static defaults"


def thresholds(device_kind: Optional[str] = None,
               platform: Optional[str] = None,
               path: Optional[str] = None) -> Dict[str, Any]:
    """The planner's decision thresholds for this device + provenance.

    Returns {"tiny_nr", "shard_min_incidence", "source"}; each threshold
    falls back to its static constant on its own (an entry may have
    measured only one crossover)."""
    entry, source = profile_entry(device_kind, platform, path)
    entry = entry or {}
    return {
        "tiny_nr": int(entry.get("tiny_nr", STATIC_TINY_NR)),
        "shard_min_incidence": int(entry.get("shard_min_incidence",
                                             STATIC_SHARD_MIN_INCIDENCE)),
        "source": source,
    }


def kernel_default(platform: Optional[str] = None,
                   device_kind: Optional[str] = None,
                   path: Optional[str] = None) -> Optional[bool]:
    """The profile's measured ``use_kernel=None`` verdict, or None.

    The reference's ``pallas_default``.  None means no profile entry covers
    this device (or its entry never measured the kernels): the caller falls
    back to its static rule, and this warns once per device."""
    entry, _source = profile_entry(device_kind, platform, path)
    if entry is not None and entry.get("kernel_default") is not None:
        return bool(entry["kernel_default"])
    _warn_once(
        f"kernel_default:{device_kind}:{platform}",
        f"no planner profile entry covers device_kind={device_kind!r} / "
        f"platform={platform!r}; use_kernel=None falls back to the static "
        f"rule (the hand-written kernels on CUDA, plain torch on the CPU)")
    return None
