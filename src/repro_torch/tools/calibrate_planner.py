"""Measure the planner's crossovers and write them into the planner profile.

``python -m repro_torch.tools.calibrate_planner [--quick] [--out PATH]
[--device cuda|cpu]`` (counterpart of the reference's
``tools/calibrate_planner.py``) times the port's engines on one device and
records, keyed by both the torch platform (``"cuda"``, what
``resolve_plan`` and ``engine.kernel_by_default`` look up) and the device
name (``torch.cuda.get_device_name()``):

  * ``kernel_default``: the ``use_kernel=None`` verdict (the reference's
    ``pallas_default``).  The round megakernel (``csrc/peel_round.cu``)
    races the plain-torch round chain, warm, on ``barabasi_albert(1000,
    6, seed=12)`` at (2, 3); True iff the megakernel wins.  Measured
    first, because the dense side of the ladder below runs what it picks.
  * ``tiny_nr``: the crossover behind ``resolve_plan``'s tiny rule.  On a
    ladder of ``barabasi_albert(n, 4, seed=11)`` at (2, 3), a cold dense
    peel races the eager gather loop, min of repeats, synchronised around
    each timing.  "Cold" is a fresh problem with its plan cache
    (``engine._plan_cache``) empty, in a process that has already loaded
    the kernel library: what a one-shot ``decompose()`` pays in a running
    server.  The first ``nvcc`` build is never timed: each kernel of the
    race is launched once before the ladder.  The record is the first
    ladder ``n_r`` where dense wins, or the top ``n_r`` + 1 if it never
    does, as the reference records it.
  * ``shard_min_incidence`` is not measured on one device (there is
    nothing to race), as in the reference; the key is left out, so
    ``thresholds()`` keeps the static constant for it.

``measured`` holds the platform, the device name, the power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives it,
the device count, ``quick`` and the raced times.  The profile is written
in ``planner_profile.FORMAT`` v1, merged into an existing file.

Without ``--device cpu`` the tool calibrates the card and raises if there
is none.  ``--device cpu`` exists for the tests: there the "kernel" side
runs the kernels' plain versions, so its verdict says nothing about a
card, and the committed profile holds no ``cpu`` entry (the static rule
keeps the CPU plans where the parity tests pin them).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..core import planner_profile
from ..core.engine import _plan_cache
from ..core.incidence import NucleusProblem, build_problem
from ..core.peel import exact_coreness
from ..device import resolve_device
from ..graph import generators

# the reference's ladders: n vertices of a BA graph at (2, 3), so n_r is
# the edge count and the dense engine pays a representative plan
LADDER = (16, 32, 64, 128, 256, 512)
LADDER_QUICK = (16, 64, 256)
RACE_N = 1_000
RACE_N_QUICK = 300


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn: Callable[[], object], repeats: int,
           dev: torch.device) -> float:
    """Min over ``repeats`` of ``fn``'s seconds, synchronised around each
    call."""
    best = float("inf")
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def power_limit_line() -> Optional[str]:
    """``name, power.limit`` of the card as nvidia-smi gives it, or None
    where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


class _Runs:
    """The races' peel calls on one device, counting the rounds of every
    call that launches the megakernel (``use_kernel=True`` on the card),
    so a caller can hold the launch counter to them."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.kernel_rounds = 0

    def dense(self, p: NucleusProblem, use_kernel: bool) -> None:
        res = exact_coreness(p, backend="dense", device=self.dev,
                             use_kernel=use_kernel, fast_lane=False)
        if use_kernel and self.dev.type == "cuda":
            self.kernel_rounds += res.rounds

    def cold_dense(self, p: NucleusProblem, use_kernel: bool) -> None:
        _plan_cache(p).clear()
        self.dense(p, use_kernel)

    def gather(self, p: NucleusProblem) -> None:
        exact_coreness(p, backend="gather", device=self.dev)


def measure_kernel_default(runs: _Runs, quick: bool, repeats: int,
                           log) -> Dict[str, float]:
    """Warm race: the round megakernel against the plain round chain."""
    g = generators.barabasi_albert(RACE_N_QUICK if quick else RACE_N, 6,
                                   seed=12, device=runs.dev)
    p = build_problem(g, 2, 3, device=runs.dev)
    runs.dense(p, True)                  # warm both bodies and the plans
    runs.dense(p, False)
    t_kernel = _timed(lambda: runs.dense(p, True), repeats, runs.dev)
    t_plain = _timed(lambda: runs.dense(p, False), repeats, runs.dev)
    log(f"  n_r={p.n_r}: megakernel {t_kernel * 1e3:.3f} ms, plain "
        f"rounds {t_plain * 1e3:.3f} ms")
    return {"n_r": p.n_r, "kernel_ms": t_kernel * 1e3,
            "plain_ms": t_plain * 1e3}


def measure_tiny_nr(runs: _Runs, ladder: Sequence[int], repeats: int,
                    use_kernel: bool, log) -> List[Dict[str, float]]:
    """Cold dense against eager gather at every rung of ``ladder``."""
    rows = []
    for n in ladder:
        g = generators.barabasi_albert(n, 4, seed=11, device=runs.dev)
        p = build_problem(g, 2, 3, device=runs.dev)
        t_dense = _timed(lambda: runs.cold_dense(p, use_kernel), repeats,
                         runs.dev)
        t_gather = _timed(lambda: runs.gather(p), repeats, runs.dev)
        log(f"  n={n} (n_r={p.n_r}): cold dense {t_dense * 1e3:.3f} ms, "
            f"gather {t_gather * 1e3:.3f} ms")
        rows.append({"n": n, "n_r": p.n_r, "dense_ms": t_dense * 1e3,
                     "gather_ms": t_gather * 1e3})
    return rows


def crossover(rows: List[Dict[str, float]]) -> int:
    """The first rung's n_r where dense wins, else the top n_r + 1."""
    for row in rows:
        if row["dense_ms"] <= row["gather_ms"]:
            return int(row["n_r"])
    return int(max(row["n_r"] for row in rows)) + 1


def write_entry(path: str, keys: Sequence[str], entry: dict) -> None:
    """Merge ``entry`` under each of ``keys`` into the profile at
    ``path`` (a malformed file is overwritten)."""
    blob = {"format": planner_profile.FORMAT,
            "version": planner_profile.VERSION, "profiles": {}}
    if os.path.exists(path):
        try:
            with open(path) as f:
                old = json.load(f)
            if old.get("format") == planner_profile.FORMAT:
                blob["profiles"].update(old.get("profiles", {}))
        except (ValueError, OSError):
            pass
    for k in keys:
        blob["profiles"][k] = entry
    with open(path, "w") as f:
        json.dump(blob, f, indent=1, sort_keys=True)
        f.write("\n")
    planner_profile.reset_cache()


def calibrate(device: str = "cuda", quick: bool = False,
              out: str = planner_profile.PROFILE_PATH, *,
              ladder: Optional[Sequence[int]] = None,
              repeats: Optional[int] = None, log=print) -> dict:
    """Run both races on ``device`` and merge the entry into ``out``.

    ``ladder`` and ``repeats`` override the quick/full choices (the tests
    run a two-rung ladder once).  Returns {"entry", "keys", "path",
    "kernel_rounds"}: ``kernel_rounds`` is the rounds of every peel that
    launched the megakernel, warm-up included."""
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"calibrate: device {dev} is neither the card nor "
                         f"the CPU")
    ladder = tuple(ladder or (LADDER_QUICK if quick else LADDER))
    reps = repeats or (2 if quick else 3)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    log(f"calibrating the planner on platform={dev.type!r} device="
        f"{name!r} n_devices={n_devices}")
    runs = _Runs(dev)
    if dev.type == "cuda":
        from ..kernels import _build
        _build.library()                # nvcc, never inside a timing
        warm = build_problem(generators.barabasi_albert(64, 4, seed=11,
                                                        device=dev), 2, 3,
                             device=dev)
        runs.dense(warm, True)          # each raced kernel launched once
    log("kernel_default (megakernel vs the plain round chain, warm):")
    race = measure_kernel_default(runs, quick, reps + 2, log)
    kernel = bool(race["kernel_ms"] < race["plain_ms"])
    log(f"  -> kernel_default = {kernel}")
    log("tiny_nr (cold dense vs the eager gather loop):")
    rows = measure_tiny_nr(runs, ladder, reps, kernel, log)
    tiny = crossover(rows)
    log(f"  -> tiny_nr = {tiny}")
    entry = {
        "tiny_nr": tiny,
        "kernel_default": kernel,
        # shard_min_incidence is left out: one device has nothing to race
        "measured": {
            "platform": dev.type,
            "device_name": name,
            "power_limit": power_limit_line() if dev.type == "cuda"
            else None,
            "n_devices": n_devices,
            "quick": bool(quick),
            "kernel_race": race,
            "ladder": rows,
        },
    }
    keys = [dev.type] + ([name] if name != dev.type else [])
    write_entry(out, keys, entry)
    log(f"wrote {out} (keys {keys})")
    return {"entry": entry, "keys": keys, "path": out,
            "kernel_rounds": runs.kernel_rounds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="short ladder, fewer repeats")
    ap.add_argument("--out", default=planner_profile.PROFILE_PATH,
                    help="profile path (default: the committed file)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device to calibrate (default: the card; "
                         "raises without one)")
    args = ap.parse_args(argv)
    calibrate(args.device, args.quick, args.out,
              log=lambda msg: print(msg, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
