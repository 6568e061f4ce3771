"""Fault-tolerant checkpointing: atomic, async, elastic (counterpart of
``repro.checkpoint.manager``).

  * **Atomic**: state is written to `step_N.tmp/` then `os.rename`d to
    `step_N/`; a crash mid-write never corrupts the latest checkpoint.
  * **Async**: the device->host copy happens in `save` (so the caller may
    update its tensors in place right after), the disk write runs on a
    background thread; `wait()` joins before the next save or at exit.
  * **Elastic re-mesh restore**: a checkpoint stores LOGICAL arrays (a
    sharded tensor is gathered in `save`), so `restore(...,
    sharding_tree=)` places them over whatever mesh the new job has, of
    any shape and slot count.
  * Retention: keeps the newest `keep` checkpoints.

**The files are the reference's.**  `arrays.npz` holds one `.npy` member
per leaf, keyed by its `jax.tree_util` key path joined by `/` (`tree.
flatten_with_paths`), and `meta.json` holds `{"step", "extra"}`.  A
bfloat16 leaf is stored as its raw 2-byte words under the reference's
header (`'<V2'`, what `np.save` writes for `ml_dtypes.bfloat16`), so the
members are byte for byte the reference's, and it is read back by
reinterpreting those bits, never through a float cast.  Each file can be
restored by the other package; the reference itself cannot restore a
bfloat16 leaf (its `astype` has no cast from `V2`).

`restore` gives each leaf the dtype of `like`'s leaf, and places it by
its sharding in `sharding_tree` (`distributed.sharding.NamedSharding`
leaves, or None), else as `like`'s leaf lies: on its device, or over its
mesh when it is a `ShardedTensor`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..distributed.sharding import NamedSharding, ShardedTensor, device_put
from ..tree import flatten_with_paths, leaves_like, unflatten

_BF16_DESCR = "<V2"  # np.save's header for an ml_dtypes.bfloat16 array


def _to_host(leaf: Any) -> np.ndarray:
    """A numpy copy of a leaf that later in-place updates cannot touch;
    bfloat16 tensors as int16 words (written under ``_BF16_DESCR``)."""
    if isinstance(leaf, ShardedTensor):
        host = leaf.gather("cpu")
    elif isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
    else:
        return np.array(leaf)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy()
    return host.numpy()


def _write_npz(path: str, host: Dict[str, np.ndarray],
               bf16: Dict[str, bool]) -> None:
    """``np.savez`` of ``host``, bfloat16 leaves under the reference's
    header."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in host.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if bf16[key]:
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": _BF16_DESCR, "fortran_order": False,
                        "shape": arr.shape})
                    fid.write(memoryview(np.ascontiguousarray(arr)).cast("B"))
                else:
                    np.lib.format.write_array(fid, np.asanyarray(arr),
                                              allow_pickle=False)


def _leaf_like(arr: np.ndarray, want: Any,
               sharding: Optional[NamedSharding]) -> Any:
    """A stored array as a leaf like ``want``: a tensor of its dtype
    (bfloat16 words reinterpreted) placed by ``sharding``, or else as
    ``want`` lies; the array as stored when ``want`` is no tensor."""
    if not isinstance(want, (torch.Tensor, ShardedTensor)):
        return arr
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(dtype=want.dtype)
    if sharding is None and isinstance(want, ShardedTensor):
        sharding = want.sharding
    if sharding is not None:
        return device_put(t, sharding)
    return t.to(device=want.device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        self.wait()
        flat = flatten_with_paths(state)
        host = {k: _to_host(v) for k, v in flat}
        bf16 = {k: isinstance(v, (torch.Tensor, ShardedTensor)) and
                v.dtype == torch.bfloat16 for k, v in flat}
        meta = {"step": int(step), "extra": extra or {}}

        def write():
            tmp = os.path.join(self.directory, f"step_{step}.tmp")
            final = os.path.join(self.directory, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            _write_npz(os.path.join(tmp, "arrays.npz"), host, bf16)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)          # the atomic commit point
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                sharding_tree: Any = None):
        """Restore into the structure of `like`; reshard if shardings given.

        Returns (state, step, extra).  `sharding_tree` mirrors `like` with
        `NamedSharding` leaves (or None to place a leaf as `like`'s lies):
        the elastic re-mesh path, since the stored arrays are logical and
        any mesh shape works."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        flat_like = flatten_with_paths(like)
        with np.load(os.path.join(path, "arrays.npz")) as arrays:
            missing = {k for k, _ in flat_like} - set(arrays.files)
            if missing:
                raise KeyError(f"checkpoint missing keys: "
                               f"{sorted(missing)[:5]}")
            shardings = (leaves_like(sharding_tree, like)
                         if sharding_tree is not None
                         else [None] * len(flat_like))
            leaves = [_leaf_like(arrays[k], want, sh) for (k, want), sh in
                      zip(flat_like, shardings)]
        return unflatten(like, leaves), meta["step"], meta["extra"]
