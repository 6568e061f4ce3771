"""Smoke run of the PyTorch/CUDA port on one card: ``python3 chip_smoke.py``.

Drives ``repro_torch``'s main path, ``decompose(graph, NucleusConfig())`` at
its defaults ((2,3), exact, dense, fused hierarchy, eager build), on a seeded
graph of about a million vertices, ten million edges and ten million
triangles, and checks every kernel of the path against its plain-torch
version on the card.  Phases (any failure ends the run with a non-zero exit):

  1. device report and kernel build (nvcc, from src/repro_torch/kernels/csrc);
  2. each kernel vs its plain version at the smoke graph's plan, with times;
  3. the main path, with the megakernel's launch count == peel rounds;
  4. the segment-sum path (``fused_kernel=False``), bit-identical to phase 3;
  5. card vs CPU on a ~20k-vertex graph (exact and approx) and the golden
     fixtures of tests/golden on the card;
  6. a JSON line of per-kernel numbers, the card's name and power limit,
     and the result line.

It needs a CUDA card and nvcc; it imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SMOKE_N = 1_000_000  # vertices of the smoke graph
SMALL_N = 20_000     # vertices of the card-vs-CPU graph


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn() on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_kernels(problem, seed: int):
    """Phase 2: each kernel against its plain version at the real plan."""
    from repro_torch.core.engine import _round_plan, _scatter_plan
    from repro_torch.kernels.peel_round import (fused_peel_round,
                                                peel_round_plain)
    from repro_torch.kernels.segment_sum import (segment_sum,
                                                 segment_sum_plain)
    dev = problem.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_r = problem.n_r
    offsets, members = _round_plan(problem)
    E, C = int(members.shape[0]), int(members.shape[1])
    deg0 = problem.deg0
    qs = torch.quantile(deg0.float()[:min(n_r, 1 << 24)],
                        torch.tensor([0.1, 0.5, 0.9], device=dev))
    rows = []
    timed_state = None
    pr_err = 0
    for frac, q in zip((0.0, 0.3, 0.7), qs.tolist()):
        level = int(q)
        peeled = (torch.rand(n_r, generator=gen, device=dev) < frac).to(
            torch.int32)
        deg = deg0 - torch.randint(0, 3, (n_r,), generator=gen, device=dev,
                                   dtype=torch.int32)
        core = torch.randint(-1, 50, (n_r,), generator=gen, device=dev,
                             dtype=torch.int32)
        order = torch.randint(-1, 50, (n_r,), generator=gen, device=dev,
                              dtype=torch.int32)
        args = (offsets, members, deg, peeled, core, order, level, 7)
        got = fused_peel_round(*args)
        want = peel_round_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("deg", "peeled", "core", "order"), got, want):
            pr_err = max(pr_err, int((a.to(torch.int64) -
                                      b.to(torch.int64)).abs().max()))
            require(torch.equal(a, b),
                    f"peel_round {name} differs from its plain version at "
                    f"level {level}, peeled fraction {frac}")
        dead = int((got[0] != deg).sum())
        log(f"[kernels] peel_round level={level} peeled_frac={frac}: equal "
            f"to plain (r-cliques decremented: {dead})")
        if timed_state is None or frac == 0.3:
            timed_state = args
    pr_ms = cuda_ms(lambda: fused_peel_round(*timed_state), 20)
    pr_plain = cuda_ms(lambda: peel_round_plain(*timed_state), 3, 1)
    pr_bytes = 4 * (E * C + (n_r + 1) + 2 * C * E + 8 * n_r)
    rows.append({"name": "peel_round", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/peel_round.cu",
                 "replaces": "src/repro/kernels/peel_round.py:142",
                 "max_abs_err": pr_err, "ms": pr_ms, "plain_ms": pr_plain,
                 "bound_ms": 1e3 * pr_bytes / HBM_BYTES_PER_S,
                 "bound_by": "bytes", "library_ms": None})

    rids, sids = _scatter_plan(problem)
    max_err = 0
    for frac in (0.05, 0.5):
        dead = (torch.rand(problem.n_s, generator=gen, device=dev) < frac)
        data = dead[sids.long()].to(torch.int32)[:, None].contiguous()
        got = segment_sum(data, rids, n_r)
        want = segment_sum_plain(data, rids, n_r)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"segment_sum int32 differs from its plain version "
                f"(dead fraction {frac})")
        max_err = max(max_err, int((got - want).abs().max()) if n_r else 0)
        log(f"[kernels] segment_sum int32 d=1 dead_frac={frac}: equal to "
            f"plain")
    fdata = torch.rand((E, 4), generator=gen, device=dev)
    fgot = segment_sum(fdata, rids, n_r)
    fwant = segment_sum_plain(fdata, rids, n_r)
    ferr = float((fgot - fwant).abs().max())
    # float sums in another order: a few ulps of the largest segment sum
    require(torch.allclose(fgot, fwant, rtol=1e-5, atol=1e-4),
            f"segment_sum float32 d=4 max abs err {ferr}")
    log(f"[kernels] segment_sum float32 d=4: max abs err {ferr:.3g} "
        f"(rtol 1e-5, atol 1e-4)")
    ss_ms = cuda_ms(lambda: segment_sum(data, rids, n_r), 20)
    ss_plain = cuda_ms(lambda: segment_sum_plain(data, rids, n_r), 5)
    ss_lib = cuda_ms(lambda: torch.zeros((n_r, 1), dtype=torch.int32,
                                         device=dev).index_add_(
                                             0, rids.long(), data), 5)
    ss_bytes = 4 * (E + E + n_r)
    rows.append({"name": "segment_sum", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
                 "replaces": "src/repro/kernels/segment_sum.py:85",
                 "max_abs_err": max_err, "ms": ss_ms, "plain_ms": ss_plain,
                 "bound_ms": 1e3 * ss_bytes / HBM_BYTES_PER_S,
                 "bound_by": "bytes", "library_ms": ss_lib})
    for r in rows:
        log(f"[kernels] {r['name']}: kernel_ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"library_ms={r['library_ms']}")
    return rows


def exact_core_support_ok(problem, core: torch.Tensor) -> bool:
    """Every r-clique of core k lies in >= k s-cliques whose members all
    have core >= k (the nucleus definition's support condition)."""
    counts = (problem.mem_offsets[1:] - problem.mem_offsets[:-1]).long()
    rid = torch.repeat_interleave(
        torch.arange(problem.n_r, device=core.device), counts)
    s_min = core[problem.inc_rid.long()].min(dim=1).values   # (n_s,)
    ok = (s_min[problem.mem_sids.long()] >= core[rid]).to(torch.int32)
    support = torch.zeros(problem.n_r, dtype=torch.int32, device=core.device)
    support.index_add_(0, rid, ok)
    return bool((support >= core).all())


def profile_peel(problem) -> None:
    """Where the peel's time goes: decompose() of the built problem (fused
    hierarchy on), once untraced and then once traced.  The trace's device
    events (kernels, copies) give the device time; the busy share is that
    over the untraced call's wall time, because tracing slows the host
    side."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import NucleusConfig, decompose
    torch.cuda.synchronize()
    t = time.perf_counter()
    decompose(problem, NucleusConfig())
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t
    t = time.perf_counter()
    # device activity only: the host-op events of every round would make
    # the trace's post-processing cost minutes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decompose(problem, NucleusConfig())
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e6
    total_s = time.perf_counter() - t
    if busy == 0:
        log(f"[profile] traced wall {traced_s:.2f} s; the profiler captured "
            f"no device time (device share not measured)")
        return
    log(f"[profile] peel with fused hierarchy: device time {busy:.2f} s "
        f"over {untraced_s:.2f} s untraced wall = "
        f"{100 * busy / untraced_s:.1f}% busy, "
        f"{100 * (1 - busy / untraced_s):.1f}% idle (traced wall "
        f"{traced_s:.2f} s, trace processing {total_s - traced_s:.1f} s)")
    for e in sorted(events, key=dev_us, reverse=True)[:6]:
        log(f"[profile]   {dev_us(e) / 1e6:8.3f} s  x{e.count:<7d} "
            f"{e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import NucleusConfig, decompose
    from repro_torch.core import (build_problem, canonicalize_labels,
                                  dense_coreness, make_schedule)
    from repro_torch.graph.generators import (community_power_law,
                                              golden_suite)
    from repro_torch.kernels import _build, launch_counts, \
        reset_launch_counts

    # -- phase 1: the card and the kernel build ---------------------------
    smi = smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    log(f"[build] {os.path.relpath(lib, ROOT)} from "
        f"{[os.path.relpath(s, ROOT) for s in _build.sources()]} in "
        f"{time.perf_counter() - t:.2f} s")

    # -- phase 2: the smoke graph, its plan, kernels vs plain -------------
    t = time.perf_counter()
    g = community_power_law(SMOKE_N, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    problem = build_problem(g, 2, 3, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    log(f"[graph] n={g.n} m={g.m} n_r={problem.n_r} n_s={problem.n_s} "
        f"orientation={problem.orientation} plan_bytes="
        f"{4 * problem.n_s * problem.n_sub ** 2} generate_s={gen_s:.2f} "
        f"build_s={build_s:.2f}")
    rows = phase_kernels(problem, args.seed)
    del problem
    torch.cuda.empty_cache()

    # -- phase 3: the main path --------------------------------------------
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    dec = decompose(g, NucleusConfig())
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t
    main_counts = dict(launch_counts)
    p = dec.problem
    log(f"[main] decompose(g, NucleusConfig()): n={g.n} m={g.m} "
        f"n_r={p.n_r} n_s={p.n_s} rounds={dec.rounds} decompose_s="
        f"{dec_s:.2f} (build_s={build_s:.2f} measured in phase 2, peel_s~"
        f"{dec_s - build_s:.2f}) launches={main_counts}")
    require(main_counts["peel_round"] == dec.rounds,
            f"megakernel launches {main_counts['peel_round']} != rounds "
            f"{dec.rounds}")
    require(main_counts["segment_sum"] == 0, "segment_sum ran on the "
            "megakernel path")
    core_t = torch.as_tensor(dec.core, device="cuda")
    require(bool((dec.core >= 0).all()), "an r-clique was never peeled")
    require(bool(((dec.order_round >= 0) &
                  (dec.order_round < dec.rounds)).all()),
            "order_round outside [0, rounds)")
    require(bool((dec.core <= p.deg0.cpu().numpy()).all()),
            "core above the initial degree")
    require(exact_core_support_ok(p, core_t),
            "an r-clique of core k lies in < k s-cliques of core >= k")
    # the same peel without the fused hierarchy, on the built problem: the
    # difference is what the link state costs
    torch.cuda.synchronize()
    t = time.perf_counter()
    bare = decompose(p, NucleusConfig(hierarchy="none"))
    torch.cuda.synchronize()
    bare_s = time.perf_counter() - t
    require(np.array_equal(bare.core, dec.core) and
            bare.rounds == dec.rounds, "hierarchy='none' changed the peel")
    kernel_s = main_counts["peel_round"] * rows[0]["ms"] / 1e3
    log(f"[main] time split: build_s={build_s:.2f} peel_s(no hierarchy)="
        f"{bare_s:.2f} of which megakernel~{kernel_s:.2f} "
        f"(launches x kernel_ms), fused hierarchy~"
        f"{dec_s - build_s - bare_s:.2f}")
    profile_peel(p)
    levels = np.unique(dec.core[dec.core > 0])
    t = time.perf_counter()
    tree = dec.tree
    tree_s = time.perf_counter() - t
    log(f"[main] tree: {tree.n_nodes} nodes ({tree.n_internal} internal) "
        f"in {tree_s:.2f} s; {levels.size} distinct core levels, max "
        f"{int(levels.max()) if levels.size else 0}")
    for c in np.quantile(levels, [0.25, 0.5, 0.9]).astype(int) \
            if levels.size else []:
        t = time.perf_counter()
        labels = dec.cut(int(c))
        nuc = dec.nuclei(int(c))
        q_s = time.perf_counter() - t
        require(set(np.unique(labels[labels >= 0]).tolist()) == set(nuc),
                f"cut({c}) and nuclei({c}) disagree")
        big = max(nuc.values(), key=lambda x: x.vertices.size)
        log(f"[main] cut({c}): {len(nuc)} nuclei over "
            f"{int((labels >= 0).sum())} r-cliques; largest "
            f"{big.vertices.size} vertices, density {big.density:.3f} "
            f"({q_s:.2f} s)")

    # -- phase 4: the segment-sum path on the same problem ----------------
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    core4, order4, rounds4, parent4, L4 = dense_coreness(
        p, make_schedule(p, "exact"), fused_kernel=False, hierarchy=True)
    torch.cuda.synchronize()
    scatter_s = time.perf_counter() - t
    scatter_counts = dict(launch_counts)
    log(f"[scatter] dense_coreness(fused_kernel=False): rounds={rounds4} "
        f"peel_s={scatter_s:.2f} launches={scatter_counts}")
    require(scatter_counts["segment_sum"] == rounds4,
            "segment_sum launches != rounds")
    require(scatter_counts["peel_round"] == 0,
            "the megakernel ran on the segment-sum path")
    require(rounds4 == dec.rounds, "rounds differ between the two paths")
    for name, a, b in (("core", core4, dec.peel_value),
                       ("order_round", order4, dec.order_round),
                       ("uf_parent", parent4, dec.uf_parent),
                       ("uf_L", L4, dec.uf_L)):
        require(np.array_equal(a.cpu().numpy(), b),
                f"{name} differs between the megakernel and segment-sum "
                f"paths")
    log("[scatter] core, order_round, rounds, uf_parent, uf_L bit-identical "
        "to the megakernel path")
    rows[0]["launches"] = main_counts["peel_round"]
    rows[0]["path"] = "decompose(g, NucleusConfig())"
    rows[1]["launches"] = scatter_counts["segment_sum"]
    rows[1]["path"] = "dense_coreness(fused_kernel=False)"
    del dec, p, core4, order4, parent4, L4, core_t
    torch.cuda.empty_cache()

    # -- phase 5: card vs CPU, and the golden fixtures on the card ---------
    small = community_power_law(SMALL_N, seed=args.seed + 1,
                                device="cpu")
    for method in ("exact", "approx"):
        cfg = NucleusConfig(method=method, delta=0.1)
        t = time.perf_counter()
        d_gpu = decompose(small, cfg, device="cuda")
        t_gpu = time.perf_counter() - t
        t = time.perf_counter()
        d_cpu = decompose(small, cfg, device="cpu")
        t_cpu = time.perf_counter() - t
        require(d_gpu.rounds == d_cpu.rounds, f"{method}: rounds differ")
        for name in ("core", "order_round", "peel_value", "uf_parent",
                     "uf_L"):
            require(np.array_equal(getattr(d_gpu, name),
                                   getattr(d_cpu, name)),
                    f"{method}: {name} differs between card and CPU")
        lv = np.unique(d_cpu.peel_value[d_cpu.peel_value > 0])
        for c in lv[:: max(1, lv.size // 4)]:
            require(np.array_equal(canonicalize_labels(d_gpu.cut(int(c))),
                                   canonicalize_labels(d_cpu.cut(int(c)))),
                    f"{method}: cut({c}) differs between card and CPU")
        log(f"[cpu-vs-card] {method}: n={small.n} m={small.m} "
            f"n_r={d_cpu.n_r} rounds={d_cpu.rounds} card_s={t_gpu:.2f} "
            f"cpu_s={t_cpu:.2f}: all arrays and cuts equal")
    gdir = os.path.join(ROOT, "tests", "golden")
    suite = golden_suite()
    n_fx = 0
    for fname in sorted(os.listdir(gdir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(gdir, fname)) as f:
            fx = json.load(f)
        d = decompose(suite[fx["graph"]](device="cuda"),
                      NucleusConfig(r=fx["r"], s=fx["s"]))
        require(d.n_r == fx["n_r"], f"{fname}: n_r differs")
        if d.n_r:
            require(np.array_equal(d.core, fx["core"]),
                    f"{fname}: core differs from the fixture")
            for c, want in fx["partitions"].items():
                require(np.array_equal(canonicalize_labels(d.cut(int(c))),
                                       want),
                        f"{fname}: cut({c}) differs from the fixture")
        n_fx += 1
    log(f"[golden] {n_fx} fixtures: core and cut partitions equal on the "
        f"card")

    # -- phase 6: the result lines ------------------------------------------
    for r in rows:
        require(r["launches"] > 0, f"{r['name']} never launched on its path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
