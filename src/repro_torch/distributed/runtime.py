"""Runtime services around the train loop (counterpart of
``repro.distributed.runtime``; host-only, as there).

  * `StragglerMonitor` - per-step wall-clock watchdog: a robust running
    median of step times, flagging steps slower than `slack` x median.
  * `PreemptionGuard` - SIGTERM/SIGINT hook that flips a flag the train
    loop polls; the loop then checkpoints and exits cleanly.
  * `ElasticPlan` - given a changed device count, the per-device batch
    and mesh shape that keep the global batch.
  * `HeartbeatLog` - a JSONL step-event log for postmortems.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import List, Optional, Tuple

import numpy as np


class StragglerMonitor:
    def __init__(self, slack: float = 2.0, warmup: int = 5,
                 window: int = 50):
        self.slack = slack
        self.warmup = warmup
        self.window = window
        self.durations: List[float] = []
        self.flagged: List[Tuple[int, float, float]] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def end_step(self) -> Optional[Tuple[int, float, float]]:
        """Returns (step, duration, median) when the step is a straggler."""
        assert self._t0 is not None, "start_step() not called"
        dur = time.monotonic() - self._t0
        self._t0 = None
        self._step += 1
        hist = self.durations[-self.window:]
        self.durations.append(dur)
        if len(hist) >= self.warmup:
            med = float(np.median(hist))
            if dur > self.slack * med:
                event = (self._step - 1, dur, med)
                self.flagged.append(event)
                return event
        return None


class PreemptionGuard:
    """Installs handlers; `should_stop` flips on SIGTERM/SIGINT."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.should_stop = False
        self._prev = {}
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        self.should_stop = True

    def request_stop(self) -> None:  # for tests / manual drain
        self.should_stop = True

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Re-mesh plan after a device-count change."""

    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    per_device_batch: int
    global_batch: int

    @staticmethod
    def plan(n_devices: int, global_batch: int, model_parallel: int,
             multi_pod: bool = False) -> "ElasticPlan":
        """Keep `model_parallel` fixed (weights must still fit); resize the
        data axis; adjust per-device batch so global batch is preserved
        (rounding up to keep it divisible)."""
        if n_devices % model_parallel:
            raise ValueError(
                f"devices ({n_devices}) not divisible by model parallelism "
                f"({model_parallel})")
        data = n_devices // model_parallel
        if multi_pod:
            # factor a pod axis of 2 when possible
            pod = 2 if data % 2 == 0 else 1
            shape = (pod, data // pod, model_parallel)
            names = ("pod", "data", "model")
        else:
            shape = (data, model_parallel)
            names = ("data", "model")
        per_dev = -(-global_batch // data)
        return ElasticPlan(mesh_shape=shape, axis_names=names,
                           per_device_batch=per_dev,
                           global_batch=per_dev * data)


class HeartbeatLog:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def event(self, kind: str, **fields) -> None:
        rec = {"t": time.time(), "kind": kind, **fields}
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
