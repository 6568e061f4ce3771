"""The paper's §8.3 trade-off, interactively: approximate vs exact
decomposition: rounds (span), wall time, and coreness error vs delta.

    PYTHONPATH=src python -m repro_torch.examples.approx_vs_exact
        [--device cpu]

Both peels run the eager gather loop (``backend="gather"``), whose every
round reads the frontier's size back to the host; ``decompose`` returns
host arrays, so each timing ends with the device's work.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from .. import NucleusConfig, build_problem, decompose, resolve_device
from ..graph import generators

DELTAS = (0.1, 0.5, 1.0)


def main(argv: Optional[Sequence[str]] = None, *, n: int = 3_000
         ) -> Dict[str, Any]:
    """``n``: the BA graph's vertices (the reference's 3,000; tests pass
    fewer)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain path; default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = generators.barabasi_albert(n, 8, seed=5, device=dev)
    problem = build_problem(g, 2, 3, device=dev)
    print(f"graph n={g.n} m={g.m}; (2,3) decomposition, "
          f"n_r={problem.n_r}, n_s={problem.n_s}")

    cfg = NucleusConfig(r=2, s=3, backend="gather", hierarchy="none")
    t0 = time.perf_counter()
    exact = decompose(problem, cfg, device=dev)
    t_exact = time.perf_counter() - t0
    e = exact.core.astype(float)
    print(f"\nexact : {exact.rounds:5d} peel rounds  {t_exact:6.2f}s  "
          f"kmax={int(e.max())}")
    out = {"n": g.n, "m": g.m, "n_r": problem.n_r, "n_s": problem.n_s,
           "exact": {"core": exact.core, "rounds": exact.rounds,
                     "s": t_exact}, "approx": {}}

    for delta in DELTAS:
        t0 = time.perf_counter()
        approx = decompose(problem, cfg, device=dev, method="approx",
                           delta=delta)
        t_a = time.perf_counter() - t0
        a = approx.core.astype(float)
        sel = e > 0
        ratio = a[sel] / e[sel]
        print(f"delta={delta:3.1f}: {approx.rounds:5d} peel rounds  "
              f"{t_a:6.2f}s  speedup={t_exact / t_a:4.1f}x  "
              f"err mean={ratio.mean():.2f} median={np.median(ratio):.2f} "
              f"max={ratio.max():.2f}")
        out["approx"][delta] = {"core": approx.core, "rounds": approx.rounds,
                                "s": t_a, "err_mean": float(ratio.mean()),
                                "err_median": float(np.median(ratio)),
                                "err_max": float(ratio.max())}
    print("\n(rounds == the span term: over a mesh each round is one "
          "reduction of the slabs' decrements; see "
          "repro_torch.core.distributed)")
    return out


if __name__ == "__main__":
    main()
