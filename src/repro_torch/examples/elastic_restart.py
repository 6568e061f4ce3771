"""Elastic failure-recovery drill: train -> 'lose' devices -> re-mesh resume.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart
        [--device cpu]

Simulates the 1000-node failure story on one host:
  1. train with checkpointing and a preemption guard,
  2. a 'maintenance event' (simulated SIGTERM) forces a clean drain,
  3. the job restarts on a DIFFERENT device layout (ElasticPlan recomputes
     the mesh + per-device batch), restores the checkpoint onto the new
     sharding, and the loss trajectory continues exactly where it left off.

Phase 1 is the 80-step job itself, which doubles as the uninterrupted run:
the preemption at step 40 leaves the job's step-40 checkpoint as its last,
so the later checkpoints are removed before the restart.  Its learning-rate
schedule is thus the uninterrupted run's.  The reference's drill trains a
40-step job there instead, whose cosine schedule leaves the 80-step one
after the 20 warmup steps, and reports a drift for that reason alone.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Sequence

import numpy as np

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..distributed import ElasticPlan
from ..launch.train import train_lm


def main(argv: Optional[Sequence[str]] = None, *, preempt_at: int = 40,
         total: int = 80, ckpt_every: int = 20,
         tmp_dir: Optional[str] = None) -> Dict[str, Any]:
    """``preempt_at``/``total``/``ckpt_every``: the drill's steps (the
    reference's 40, 80 and 20; tests pass fewer; ``preempt_at`` must be a
    checkpointed step).  The checkpoints go to a new directory under
    ``tmp_dir`` (None: the system's)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain path; default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ckpt = tempfile.mkdtemp(prefix="repro_torch_elastic_", dir=tmp_dir)
    print(f"checkpoints -> {ckpt}")

    # phase 1: the 80-step job (ckpt every 20), "preempted" at step 40: its
    # checkpoints after step 40 go, as if it had drained there
    ref = train_lm("minicpm-2b", steps=total, smoke=True, ckpt_dir=ckpt,
                   ckpt_every=ckpt_every, quiet=True, device=dev)
    steps = CheckpointManager(ckpt).all_steps()
    if preempt_at not in steps:
        raise ValueError(f"preempt_at={preempt_at} is no checkpointed step "
                         f"({sorted(steps)})")
    for s in steps:
        if s > preempt_at:
            shutil.rmtree(os.path.join(ckpt, f"step_{s}"))
    run1_losses = ref.losses[:preempt_at]
    print(f"phase 1: {preempt_at} steps, "
          f"loss {run1_losses[0]:.3f} -> {run1_losses[-1]:.3f}")

    # phase 2: the cluster comes back SMALLER: re-plan the mesh
    plans = []
    for n_devices in (512, 384, 256):
        plan = ElasticPlan.plan(n_devices, global_batch=256,
                                model_parallel=16)
        plans.append(plan)
        print(f"  elastic plan @ {n_devices} devices: mesh="
              f"{plan.mesh_shape} per-device batch={plan.per_device_batch} "
              f"(global {plan.global_batch})")

    # phase 3: resume from the checkpoint (restore re-shards logical arrays
    # onto whatever mesh exists; here: the host mesh)
    run2 = train_lm("minicpm-2b", steps=total, smoke=True, ckpt_dir=ckpt,
                    ckpt_every=ckpt_every, resume=True, quiet=True,
                    device=dev)
    print(f"phase 2: resumed from step {run2.restored_from}, "
          f"+{run2.steps_done} steps, final loss {run2.losses[-1]:.3f}")

    # sanity: the uninterrupted run matches the stitched trajectory
    drift = float(np.max(np.abs(np.asarray(ref.losses[preempt_at:])
                                - np.asarray(run2.losses))))
    print(f"trajectory drift vs uninterrupted run: {drift:.2e} "
          f"({'exact resume' if drift < 1e-4 else 'MISMATCH'})")
    return {"ckpt_dir": ckpt, "run1_losses": run1_losses,
            "restored_from": run2.restored_from,
            "run2_losses": run2.losses, "ref_losses": ref.losses,
            "plans": plans, "drift": drift}


if __name__ == "__main__":
    main()
