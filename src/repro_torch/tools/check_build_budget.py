"""Gate for the memory-bounded chunked incidence build.

``python -m repro_torch.tools.check_build_budget [--device cuda|cpu]``
(counterpart of the reference's ``tools/check_build_budget.py``) builds
ba4k = ``barabasi_albert(4_000, 8, seed=7)`` at (2, 3) twice, eagerly and
chunked under a deliberately tiny ``BUDGET``, each build in a fresh
subprocess of this module (the two run side by side; each measures its
own process), and fails if:

  1. the chunked build's ``problem_digest`` differs from the committed
     fingerprint ``tests/golden/build/ba4k_build_r2s3.json`` (read, never
     written);
  2. the chunked digest differs from the eager build's;
  3. the builder's accounted intermediate peak
     (``build_stats["peak_intermediate_bytes"]``) exceeds ``BUDGET`` x
     ``TOLERANCE``;
  4. the measured peak exceeds ``BUDGET`` x ``TOLERANCE`` plus a constant
     slack.  On the card the measured peak is the
     ``torch.cuda.max_memory_allocated()`` delta over the build; its slack
     (``DEVICE_SLACK``) covers what the build keeps that is not
     intermediate state: the problem's own arrays, the oriented graph's
     CSR, and the caching allocator's rounding of every block up to 512
     bytes.  On the CPU it is VmHWM minus VmRSS before the build; its
     slack (``RSS_SLACK``) covers the allocator pools and numpy scratch
     the process keeps, as in the reference.  A slack is a constant, not
     a ratio, so a build that goes eager still trips the accounted check.

Without ``--device cpu`` the gate runs on the card and raises without one.
There is no ``--regen``: the fingerprint is the reference's oracle, which
the port is held to and never rewrites (the same reason the reference's
``tools/regen_golden.py`` has no counterpart here).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

GRAPH, R, S = "ba4k", 2, 3
BUDGET = 8 << 20          # tiny on purpose: ba4k must chunk
TOLERANCE = 1.2           # the ">20%" gate
DEVICE_SLACK = 4 << 20    # bytes: outputs, the oriented CSR, block rounding
RSS_SLACK = 64 << 20      # bytes: allocator pools and numpy scratch
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
GOLDEN = os.path.join(ROOT, "tests", "golden", "build",
                      f"{GRAPH}_build_r{R}s{S}.json")


def _status_kb(field: str) -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1])
    raise RuntimeError(f"/proc/self/status has no {field}")


def child(build: str, device: str) -> dict:
    """One build in this process: {"digest", "accounted_bytes",
    "peak_bytes", "wall_s", "stats", "n_r", "n_s"}."""
    import torch
    from ..core.incidence import build_problem, problem_digest
    from ..device import resolve_device
    from ..graph.generators import barabasi_albert

    torch.set_num_threads(1)
    dev = resolve_device(device)
    g = barabasi_albert(4_000, 8, seed=7, device=dev)
    kw = {"memory_budget_bytes": BUDGET} if build == "chunked" else {}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    else:
        before = _status_kb("VmRSS") << 10
    t0 = time.perf_counter()
    p = build_problem(g, R, S, build=build, device=dev, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - before
    else:
        peak = (_status_kb("VmHWM") << 10) - before
    wall = time.perf_counter() - t0
    return {"build": build, "device": str(dev), "digest": problem_digest(p),
            "accounted_bytes": int(p.build_stats["peak_intermediate_bytes"]),
            "peak_bytes": int(peak), "wall_s": wall,
            "stats": p.build_stats, "n_r": p.n_r, "n_s": p.n_s}


def _spawn(build: str, device: str) -> subprocess.Popen:
    """``child`` in a fresh subprocess of this module."""
    env = dict(os.environ)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.tools.check_build_budget",
         "--child", build, "--device", device],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def run_children(device: str, timeout: int = 600) -> dict:
    """The eager and the chunked ``child``, each in a fresh subprocess,
    both started together (each measures its own process); the last
    stdout line of each is its record."""
    procs = {b: _spawn(b, device) for b in ("eager", "chunked")}
    out = {}
    for build, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{build} build child failed "
                               f"({proc.returncode}):\n{stderr[-4000:]}")
        out[build] = json.loads(stdout.strip().splitlines()[-1])
    return out


def check(eager: dict, chunked: dict, golden: dict) -> list:
    """The gate's failures (empty when it passes)."""
    failures = []
    if chunked["digest"] != golden["digest"]:
        failures.append(f"chunked digest {chunked['digest']} != golden "
                        f"{golden['digest']} "
                        f"({os.path.relpath(GOLDEN, ROOT)})")
    if chunked["digest"] != eager["digest"]:
        failures.append(f"chunked digest {chunked['digest']} != eager "
                        f"{eager['digest']}")
    limit = BUDGET * TOLERANCE
    if chunked["accounted_bytes"] > limit:
        failures.append(f"accounted intermediate peak "
                        f"{chunked['accounted_bytes']} B exceeds budget "
                        f"{BUDGET} B by >20%")
    slack = DEVICE_SLACK if chunked["device"].startswith("cuda") \
        else RSS_SLACK
    if chunked["peak_bytes"] > limit + slack:
        failures.append(f"measured peak {chunked['peak_bytes']} B exceeds "
                        f"budget {BUDGET} B (+20% +{slack} B slack)")
    return failures


def gate(device: str = "cuda", log=print) -> dict:
    """Both builds in fresh subprocesses, then ``check``.  Returns
    {"eager", "chunked", "failures"}."""
    from ..device import resolve_device
    resolve_device(device)              # raise here, not in a child
    recs = run_children(device)
    eager, chunked = recs["eager"], recs["chunked"]
    log(f"eager:   wall={eager['wall_s']:.3f}s accounted="
        f"{eager['accounted_bytes']} peak={eager['peak_bytes']} "
        f"digest={eager['digest']}")
    log(f"chunked: wall={chunked['wall_s']:.3f}s budget={BUDGET} chunks="
        f"{chunked['stats']['n_chunks']} accounted="
        f"{chunked['accounted_bytes']} peak={chunked['peak_bytes']} "
        f"digest={chunked['digest']}")
    with open(GOLDEN) as f:
        golden = json.load(f)
    failures = check(eager, chunked, golden)
    for msg in failures:
        log(f"FAIL: {msg}")
    if not failures:
        log("OK: the chunked build is bit-identical and within the memory "
            "budget")
    return {"eager": eager, "chunked": chunked, "failures": failures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the builds run (default: the card; raises "
                         "without one)")
    ap.add_argument("--child", choices=("eager", "chunked"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.device)), flush=True)
        return 0
    res = gate(args.device, log=lambda m: print(m, flush=True))
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
