"""Train an LM arch end-to-end with the full production loop:
checkpointing, restore-on-restart, straggler monitoring, WSD schedule.

    PYTHONPATH=src python -m repro_torch.examples.train_lm
        --arch minicpm-2b --steps 300 [--device cpu]

The reduced (smoke) config runs here; ``launch.train --full`` trains the
published config with the same step function.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict, Optional, Sequence

from .. import resolve_device
from ..launch.train import train_lm


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--schedule", default="wsd",
                    choices=["constant", "cosine", "wsd"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain path; default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    print(f"checkpoints -> {ckpt}")
    run = train_lm(args.arch, steps=args.steps, smoke=True, ckpt_dir=ckpt,
                   ckpt_every=100, schedule=args.schedule,
                   microbatches=args.microbatches, device=dev)
    print(f"trained {run.steps_done} steps: "
          f"loss {run.losses[0]:.3f} -> {run.losses[-1]:.3f}")
    return {"ckpt_dir": ckpt, "losses": run.losses,
            "steps_done": run.steps_done}


if __name__ == "__main__":
    main()
