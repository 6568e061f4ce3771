"""Quickstart: (r, s) nucleus decomposition + hierarchy in five minutes.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--r 2 --s 3]
        [--device cpu]

Builds a graph with planted dense structure, computes exact coreness
values, constructs the hierarchy (interleaved single-pass ANH-EL), and
walks the tree to extract nuclei at every resolution: the paper's Figure 1
workflow.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

from .. import NucleusConfig, decompose, resolve_device
from ..graph import generators


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--s", type=int, default=3)
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--backend", default="auto",
                    help="a registered backend name, or 'auto' to let the "
                         "planner pick (default)")
    ap.add_argument("--hierarchy", default="auto")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain path; default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = generators.planted_cliques(args.n, [16, 12, 9, 7], 0.02, seed=1,
                                   device=dev)
    print(f"graph: n={g.n} m={g.m};  ({args.r},{args.s}) nucleus "
          f"decomposition")

    # ONE call: incidence structure + peel + hierarchy; with backend="auto"
    # the registry planner picks the backend/hierarchy from the device kind
    # and problem size, and the decision rides on the artifact
    dec = decompose(g, NucleusConfig(r=args.r, s=args.s,
                                     backend=args.backend,
                                     hierarchy=args.hierarchy), device=dev)
    print(dec.plan_report())
    print(f"r-cliques: {dec.n_r}, s-cliques: {dec.problem.n_s}")

    core = dec.core
    print(f"coreness: max={core.max()}  "
          f"mean={core.mean():.2f}  peel rounds={dec.rounds}")

    tree = dec.tree  # lazy: materialized from the fused forest on demand
    print(f"hierarchy: {tree.n_leaves} leaves, {tree.n_internal} internal "
          f"nodes")
    out = {"n": g.n, "m": g.m, "n_r": dec.n_r, "n_s": dec.problem.n_s,
           "core": core, "core_max": int(core.max()),
           "core_mean": float(core.mean()), "rounds": dec.rounds,
           "backend": dec.config.backend,
           "hierarchy": dec.config.hierarchy, "leaves": tree.n_leaves,
           "internal": tree.n_internal, "nuclei": {}}
    for c in sorted(set([1, int(core.max() // 2), int(core.max())])):
        nuclei = dec.nuclei(c)
        dens = sorted((nc.density, len(nc.vertices))
                      for nc in nuclei.values())[::-1][:3]
        print(f"  c={c:3d}: {len(nuclei):4d} nuclei; densest: "
              + ", ".join(f"density={d:.2f} |V|={k}" for d, k in dens))
        out["nuclei"][c] = {"count": len(nuclei), "densest": dens}
    return out


if __name__ == "__main__":
    main()
