"""The persistent warm path: the kernel build cache and session manifests.

Counterpart of ``repro.serve.cache``.  A warm ``Session`` dies with its
process; two pieces carry the pool across a restart:

  * **Persistent kernel cache.**  ``init_persistent_cache(dir)`` points the
    kernel build (``kernels._build``) at ``dir``: the library is built
    there once, and a later process that calls it first loads the built
    library instead of running ``nvcc``.  (The reference points jax's
    compilation cache there; the port has one library, not an executable
    per shape.)
  * **Session manifest.**  ``save_manifest``/``load_manifest`` persist
    ``router_manifest(router)`` (one ``Session.manifest()`` per pool: the
    shape-class records, nothing graph-specific) as JSON next to it, and
    ``prewarm_router`` recreates each pool and prewarms its buckets, so
    the first post-restart same-bucket decompose counts as warm.

``init_persistent_cache`` reports failure as the reference does: False and
a warning, leaving the build directory where it was.
"""
from __future__ import annotations

import json
import os
import tempfile
import warnings
from typing import Any, Dict, Optional

from ..core.session import MANIFEST_FORMAT

ROUTER_MANIFEST_FORMAT = "repro_torch.nucleus-server-manifest"
ROUTER_MANIFEST_VERSION = 1
MANIFEST_BASENAME = "session_manifest.json"


def init_persistent_cache(cache_dir: str) -> bool:
    """Build the kernel library into, and load it from, ``cache_dir``.

    Call it at process start, before the first kernel launch: a library
    already loaded stays loaded.  Returns True when the build directory
    was moved, False (with a warning) when ``cache_dir`` cannot be created
    or written."""
    from ..kernels import _build

    try:
        os.makedirs(cache_dir, exist_ok=True)
        with tempfile.TemporaryFile(dir=cache_dir):
            pass
        _build.set_build_dir(cache_dir)
    except OSError as e:
        warnings.warn(
            f"persistent kernel cache unavailable at {cache_dir!r} ({e!r});"
            f" the kernels keep building into {str(_build.BUILD_DIR)!r}",
            RuntimeWarning)
        return False
    return True


def router_manifest(router) -> Dict[str, Any]:
    """One manifest per pool, wrapped in the server envelope (everything
    ``prewarm_router`` needs, nothing graph- or tenant-specific)."""
    with router._lock:
        pools = list(router._pools.values())
    return {"format": ROUTER_MANIFEST_FORMAT,
            "version": ROUTER_MANIFEST_VERSION,
            "pools": [sess.manifest() for sess in pools]}


def prewarm_router(router, manifest: Dict[str, Any]) -> int:
    """Recreate every manifest pool on ``router`` and prewarm its shape
    buckets; returns the total bucket count prewarmed.  Existing pools
    prewarm in place (already-registered buckets are skipped)."""
    from ..core.api import NucleusConfig

    if manifest.get("format") != ROUTER_MANIFEST_FORMAT:
        raise ValueError(
            f"not a server manifest: format={manifest.get('format')!r} "
            f"(expected {ROUTER_MANIFEST_FORMAT!r}) — regenerate it with "
            f"serve.cache.router_manifest()")
    total = 0
    for pool_manifest in manifest.get("pools", []):
        if pool_manifest.get("format") != MANIFEST_FORMAT:
            raise ValueError(
                f"malformed pool entry: format="
                f"{pool_manifest.get('format')!r} — the manifest was "
                f"truncated or hand-edited; regenerate it")
        config = NucleusConfig.from_dict(pool_manifest["config"])
        sess = router.pool(config)
        total += sess.prewarm(pool_manifest)
    return total


def save_manifest(router, path: str) -> str:
    """Serialize ``router_manifest(router)`` to ``path`` (a directory gets
    ``session_manifest.json`` inside it).  Returns the file path."""
    if os.path.isdir(path):
        path = os.path.join(path, MANIFEST_BASENAME)
    blob = router_manifest(router)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f, sort_keys=True, indent=1)
        f.write("\n")
    os.replace(tmp, path)  # atomic: a crash never leaves a torn manifest
    return path


def load_manifest(path: str) -> Optional[Dict[str, Any]]:
    """Read a manifest written by ``save_manifest``; a directory resolves
    to ``session_manifest.json`` inside it.  Returns None when the file
    does not exist (a first boot), raises on a malformed one."""
    if os.path.isdir(path):
        path = os.path.join(path, MANIFEST_BASENAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        blob = json.load(f)
    if blob.get("format") != ROUTER_MANIFEST_FORMAT:
        raise ValueError(
            f"{path}: not a server manifest (format="
            f"{blob.get('format')!r}); delete it or regenerate with "
            f"save_manifest()")
    return blob
