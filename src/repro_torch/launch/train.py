"""End-to-end training loop (counterpart of ``repro.launch.train``).

Data pipeline -> train step -> checkpoint/restore -> straggler and
preemption handling, on the card unless ``device="cpu"`` (``--device
cpu``).  ``python -m repro_torch.launch.train --arch minicpm-2b --device
cpu --steps 30`` trains the smoke config on the CPU; every LM arch of the
reference trains, at its smoke config by default (``--full`` for the
published one).  ``--arch din`` trains the DIN CTR model on
``RecsysStream`` batches (``train_din``).  The parameters come from each
model's seeded ``init_params``.  ``train_lm`` places them, and the AdamW
moments beside them, over a named mesh by the reference's
``lm_param_rules`` (``mesh=``; by default every visible card on the data
axis, as the reference's ``make_host_mesh()``) and steps through
``steps.lm_train_step_sharded``; a one-slot mesh runs the one-device step
on the tensors themselves.  Checkpoints hold logical arrays, and a resumed
run restores them onto its own mesh.  ``train_din`` uses one device.  The
GNN archs have no launcher, as in the reference: they train through
``steps.gnn_train_step``.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_arch
from ..data import (RecsysStream, RecsysStreamConfig, TokenStream,
                    TokenStreamConfig)
from ..device import DeviceLike, resolve_device
from ..distributed import HeartbeatLog, PreemptionGuard, StragglerMonitor
from ..distributed import sharding
from ..models import din as DIN
from ..models import transformer as T
from ..optim import adamw
from . import steps as S
from .mesh import NamedMesh, make_named_host_mesh


@dataclasses.dataclass
class TrainRun:
    losses: list
    steps_done: int
    restored_from: Optional[int]


def _check_lm(arch_id: str) -> None:
    if get_arch(arch_id).family != "lm":
        raise ValueError(f"--arch {arch_id} is no LM: train_lm trains the "
                         f"LM archs (din trains with train_din)")


def train_lm(arch_id: str, steps: int = 200, smoke: bool = True,
             ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
             batch_override: Optional[int] = None,
             seq_override: Optional[int] = None,
             schedule: str = "cosine",
             resume: bool = False, log_every: int = 20,
             microbatches: int = 1, quiet: bool = False,
             device: DeviceLike = None,
             mesh: Optional[NamedMesh] = None) -> TrainRun:
    """Train ``arch_id`` for ``steps`` steps from seeded parameters;
    with ``resume`` and a checkpoint in ``ckpt_dir``, from its step on.

    The state lives on ``mesh`` (default: ``make_named_host_mesh`` of
    ``device``), each step's gradient over ``microbatches`` microbatches
    of every data index's rows."""
    _check_lm(arch_id)
    if mesh is None:
        mesh = make_named_host_mesh(device=device)
    dev = mesh.slots[0]
    spec = get_arch(arch_id)
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps,
                                schedule=schedule)
    B = batch_override or 8
    Sq = seq_override or 64
    stream = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=Sq,
                                           global_batch=B))
    params = T.init_params(cfg, device=dev)
    shardings = S.lm_state_shardings(params, cfg, mesh)
    params = sharding.device_put(params, shardings[0])
    opt_state = S.init_sharded_state(params)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    restored_from = None
    if mgr and resume and mgr.latest_step() is not None:
        (params, opt_state), start_step, _ = mgr.restore(
            (params, opt_state), sharding_tree=shardings)
        restored_from = start_step

    monitor = StragglerMonitor()
    guard = PreemptionGuard()
    log = HeartbeatLog(f"{ckpt_dir}/heartbeat.jsonl") if ckpt_dir else None
    losses = []
    step = start_step
    try:
        for step in range(start_step, steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in stream.batch(step).items()}
            monitor.start_step()
            params, opt_state, metrics = S.lm_train_step_sharded(
                params, opt_state, batch, cfg, opt_cfg, microbatches)
            loss = float(metrics["loss"])
            straggle = monitor.end_step()
            losses.append(loss)
            if log:
                log.event("step", step=step, loss=loss)
                if straggle:
                    log.event("straggler", step=straggle[0],
                              duration=straggle[1], median=straggle[2])
            # nucleuslint: disable=NL102 (host ints, additive taint)
            if not quiet and step % log_every == 0:
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"lr {float(metrics['lr']):.2e}", flush=True)
            # nucleuslint: disable=NL102 (host ints, additive taint)
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, (params, opt_state))
            if guard.should_stop:
                if mgr:
                    mgr.save(step + 1, (params, opt_state), blocking=True)
                break
    finally:
        if mgr:
            mgr.wait()
        guard.restore()
        if log:
            log.close()
    return TrainRun(losses=losses, steps_done=step + 1 - start_step,
                    restored_from=restored_from)


def train_din(steps: int = 100, smoke: bool = True, batch: int = 256,
              quiet: bool = False, device: DeviceLike = None) -> TrainRun:
    """Train din for ``steps`` steps of ``batch`` rows from seeded
    parameters (``din.init_params``), the reference's schedule: lr 1e-3,
    10 warmup steps, cosine, no weight decay."""
    dev = resolve_device(device)
    spec = get_arch("din")
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps,
                                schedule="cosine", weight_decay=0.0)
    stream = RecsysStream(RecsysStreamConfig(
        n_items=cfg.n_items, n_cates=cfg.n_cates, n_users=cfg.n_user_feats,
        seq_len=cfg.seq_len, batch=batch))
    params = DIN.init_params(cfg, device=dev)
    opt_state = adamw.init_state(params)
    losses = []
    for step in range(steps):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch(step).items()}
        params, opt_state, metrics = S.din_train_step(params, opt_state, b,
                                                      cfg, opt_cfg)
        losses.append(float(metrics["loss"]))
        if not quiet and step % 20 == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}", flush=True)
    return TrainRun(losses=losses, steps_done=steps, restored_from=None)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--schedule", default="cosine",
                    choices=["constant", "cosine", "wsd"])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain path; default: the card")
    args = ap.parse_args()
    if get_arch(args.arch).family == "recsys":
        run = train_din(steps=args.steps, smoke=args.smoke,
                        device=args.device)
    else:
        run = train_lm(args.arch, steps=args.steps, smoke=args.smoke,
                       ckpt_dir=args.ckpt_dir, resume=args.resume,
                       schedule=args.schedule,
                       microbatches=args.microbatches, device=args.device)
    print(f"done: {run.steps_done} steps, "
          f"loss {run.losses[0]:.4f} -> {run.losses[-1]:.4f}")


if __name__ == "__main__":
    main()
