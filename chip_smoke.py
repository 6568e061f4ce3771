"""Smoke run of the PyTorch/CUDA port on one card: ``python3 chip_smoke.py``.

Drives ``repro_torch``'s main path, ``decompose(graph, NucleusConfig())`` at
its defaults ((2,3), exact, dense, fused hierarchy, eager build), on a seeded
graph of about a million vertices, ten million edges and ten million
triangles, then the memory-bounded chunked build on the card: its dense
(2,3) fast path on a 32,768-vertex graph and its sparse seed-chunked path on
the million-vertex graph.  Every kernel of those paths is checked against
its plain-torch version on the card.  Phases (any failure ends the run with
a non-zero exit):

  1. device report and kernel build (nvcc, from src/repro_torch/kernels/csrc);
  2. each kernel vs its plain version, with times: the round kernels at the
     smoke graph's plan, tricount at ragged small n and on the 32k graph's
     oriented adjacency;
  3. the main path, with the megakernel's launch count == peel rounds;
  4. the segment-sum path (``fused_kernel=False``), bit-identical to phase 3;
  5. the chunked build: ``decompose(g32k, build="chunked", 24 GiB budget)``
     takes the dense fast path (one tricount launch) and equals the eager
     decompose; the sparse path on the smoke graph (4 GiB budget, many
     chunks) reproduces phase 2's eager arrays; the ba4k build fingerprint
     of tests/golden/build;
  6. card vs CPU on a ~20k-vertex graph (exact and approx) and the golden
     fixtures of tests/golden on the card, eager and chunked (fast and
     sparse);
  7. a JSON line of per-kernel numbers, the card's name and power limit,
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
INT8_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor-core rate (data sheet)
SMOKE_N = 1_000_000  # vertices of the smoke graph
SMALL_N = 20_000     # vertices of the card-vs-CPU graph
DENSE_N = 32_768     # vertices of the chunked build's dense fast-path graph
DENSE_BUDGET = 24 << 30   # >= 5·n²·4 at DENSE_N: the dense (2,3) fast path
SPARSE_BUDGET = 4 << 30   # far under 5·n²·4 at SMOKE_N: the sparse path
RAGGED_N = (1, 127, 130, 257)


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


def phase_tricount(g32k, seed: int):
    """Phase 2, tricount: kernel vs plain at ragged small n (both operand
    layouts, random 0/1 with no symmetry, so a transposed operand would
    show) and on the 32k graph's oriented adjacency, with times."""
    from repro_torch.kernels.tricount import (tricount_oriented,
                                              tricount_oriented_plain,
                                              tricount_per_edge,
                                              tricount_per_edge_plain)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pairs = ((tricount_oriented, tricount_oriented_plain),
             (tricount_per_edge, tricount_per_edge_plain))
    for n in RAGGED_N:
        a = (torch.rand((n, n), generator=gen, device="cuda") < 0.3).float()
        for kernel, plain in pairs:
            require(torch.equal(kernel(a), plain(a)),
                    f"{kernel.__name__} differs from its plain version at "
                    f"n={n}")
    log(f"[kernels] tricount oriented/per_edge at n={RAGGED_N}: equal to "
        f"plain")
    from repro_torch.core.incidence import dense_dag, pick_rank
    dg, _ = pick_rank(g32k)
    dense = dense_dag(dg)[2]
    n = g32k.n
    err = 0.0
    for kernel, plain in pairs:
        got = kernel(dense)
        want = plain(dense)
        err = max(err, float((got - want).abs().max()))
        require(torch.equal(got, want),
                f"{kernel.__name__} differs from its plain version on the "
                f"{n}-vertex graph's oriented adjacency")
        if kernel is tricount_oriented:
            n_tri = int(got.sum())
        del got, want
    torch.cuda.empty_cache()
    log(f"[kernels] tricount oriented/per_edge at n={n} (dmax={dg.dmax}, "
        f"{n_tri} triangles): equal to plain")
    tc_ms = cuda_ms(lambda: tricount_oriented(dense), 5)
    tc_plain = cuda_ms(lambda: tricount_oriented_plain(dense), 1, 1)

    # library calls of the same function, f32 in and out: int8 tensor-core
    # product with int32 sums (exact for 0/1, the kernel's own route), bf16
    # with fp32 accumulation (exact while counts stay under 2^8 in its bf16
    # output) and f32 on the SIMT units (TF32 is off)
    def lib_int8():
        d8 = dense.to(torch.int8)
        return torch._int_mm(d8, d8.t()).to(torch.float32).mul_(dense)

    def lib_bf16():
        db = dense.to(torch.bfloat16)
        return torch.mm(db, db.t()).to(torch.float32).mul_(dense)

    def lib_f32():
        return torch.mm(dense, dense.t()).mul_(dense)

    want = tricount_oriented_plain(dense)
    require(torch.equal(lib_int8(), want), "the int8 library product "
            "differs from the plain version")
    bf16_equal = bool(torch.equal(lib_bf16(), want))
    del want
    lib = {"int8 torch._int_mm": cuda_ms(lib_int8, 3, 1),
           "bf16 torch.mm": cuda_ms(lib_bf16, 3, 1),
           "f32 torch.mm": cuda_ms(lib_f32, 1, 1)}
    log(f"[kernels] tricount library calls at n={n} (ms, each followed by "
        f"the f32 mask): {lib}; bf16 equal to plain: {bf16_equal}")
    # the least work of the function on this run's input: read D (f32)
    # once and write the (n, n) f32 output once; one length-n dot product
    # per output that the mask keeps, 2·n·nnz(D) operations at the int8
    # tensor-core rate
    nnz = int(dg.neighbors.shape[0])
    bytes_ms = 1e3 * 8.0 * n * n / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2.0 * n * nnz / INT8_OPS_PER_S
    log(f"[kernels] tricount bound at n={n}, nnz(D)={nnz}: bytes "
        f"{bytes_ms:.4f} ms, operations {ops_ms:.4f} ms")
    del dense
    torch.cuda.empty_cache()
    return {"name": "tricount", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tricount.cu",
            "replaces": "src/repro/kernels/tricount.py:67",
            "max_abs_err": err, "ms": tc_ms, "plain_ms": tc_plain,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib["int8 torch._int_mm"],
            "library_call": "torch._int_mm(D8, D8.t()) * D"}


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


def paired_build_s(g, budget: int):
    """Wall seconds of build_problem(g, 2, 3) in turns eager, chunked,
    chunked, eager (each ending in a device sync), so the two builders
    are compared on one card in one run."""
    from repro_torch.core import build_problem
    out = []
    for build in ("eager", "chunked", "chunked", "eager"):
        kw = {"memory_budget_bytes": budget} if build == "chunked" else {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        build_problem(g, 2, 3, build=build, **kw)
        torch.cuda.synchronize()
        out.append(round(time.perf_counter() - t, 4))
    return out


def log_phase(k: int, since: float) -> float:
    now = time.perf_counter()
    log(f"[phase {k}] {now - since:.2f} s")
    return now


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
    from repro_torch.core.incidence import INCIDENCE_FIELDS, problem_digest
    from repro_torch.graph.generators import (barabasi_albert,
                                              community_power_law,
                                              golden_suite)
    from repro_torch.kernels import _build, launch_counts, \
        reset_launch_counts

    # -- phase 1: the card and the kernel build ---------------------------
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    phase_t = time.perf_counter()
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
    phase_t = log_phase(1, phase_t)

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
    eager_digest = problem_digest(problem)
    del problem
    torch.cuda.empty_cache()
    g32k = community_power_law(DENSE_N, seed=args.seed, device="cuda")
    rows.append(phase_tricount(g32k, args.seed))
    phase_t = log_phase(2, phase_t)

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

    phase_t = log_phase(3, phase_t)

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
    phase_t = log_phase(4, phase_t)

    # -- phase 5: the chunked build, dense fast path and sparse path ------
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    dch = decompose(g32k, NucleusConfig(build="chunked",
                                        memory_budget_bytes=DENSE_BUDGET))
    torch.cuda.synchronize()
    dch_s = time.perf_counter() - t
    dense_counts = dict(launch_counts)
    st = dch.problem.build_stats
    log(f"[chunked] decompose(g32k, build='chunked', budget={DENSE_BUDGET}):"
        f" n={g32k.n} m={g32k.m} n_r={dch.n_r} n_s={dch.problem.n_s} "
        f"rounds={dch.rounds} decompose_s={dch_s:.2f} build_stats={st} "
        f"launches={dense_counts}")
    require(st["fastpath"], "the 24 GiB budget did not take the dense path")
    require(dense_counts["tricount"] == 1,
            f"tricount launched {dense_counts['tricount']} times, not once")
    require(dense_counts["peel_round"] == dch.rounds,
            "megakernel launches != rounds on the chunked path")
    t = time.perf_counter()
    deg = decompose(g32k, NucleusConfig())
    torch.cuda.synchronize()
    deg_s = time.perf_counter() - t
    for f in INCIDENCE_FIELDS:
        require(torch.equal(getattr(dch.problem, f),
                            getattr(deg.problem, f)),
                f"chunked dense-path {f} differs from the eager build")
    require(dch.rounds == deg.rounds, "chunked path: rounds differ")
    for name in ("core", "order_round", "uf_parent", "uf_L"):
        require(np.array_equal(getattr(dch, name), getattr(deg, name)),
                f"chunked path: {name} differs from the eager decompose")
    b32 = paired_build_s(g32k, DENSE_BUDGET)
    log(f"[chunked] dense path == eager (5 arrays, core, rounds, "
        f"order_round, uf_parent, uf_L); eager decompose_s={deg_s:.2f}; "
        f"build_s eager/chunked/chunked/eager={b32}")
    rows[2]["launches"] = dense_counts["tricount"]
    rows[2]["path"] = ("decompose(g32k, NucleusConfig(build='chunked', "
                       "memory_budget_bytes=24 << 30))")
    del dch, deg, g32k
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    t = time.perf_counter()
    sp = build_problem(g, 2, 3, build="chunked",
                       memory_budget_bytes=SPARSE_BUDGET)
    torch.cuda.synchronize()
    sp_s = time.perf_counter() - t
    st = sp.build_stats
    require(st["n_chunks"] > 1 and not st["fastpath"],
            f"the sparse chunked build ran {st}")
    require(problem_digest(sp) == eager_digest,
            "the sparse chunked build differs from phase 2's eager build")
    del sp
    torch.cuda.empty_cache()
    b1m = paired_build_s(g, SPARSE_BUDGET)
    log(f"[chunked] sparse path on the smoke graph: build_s={sp_s:.2f} "
        f"n_chunks={st['n_chunks']} chunk_size={st['chunk_size']}: digest "
        f"equal to the eager build; build_s eager/chunked/chunked/eager="
        f"{b1m}")
    with open(os.path.join(ROOT, "tests", "golden", "build",
                           "ba4k_build_r2s3.json")) as f:
        fx = json.load(f)
    ba = build_problem(barabasi_albert(4000, 8, seed=7, device="cuda"),
                       fx["r"], fx["s"], build="chunked",
                       memory_budget_bytes=fx["budget"])
    require(problem_digest(ba) == fx["digest"],
            "the ba4k chunked build differs from its committed fingerprint")
    log(f"[chunked] ba4k (2,3) at budget {fx['budget']}: n_chunks="
        f"{ba.build_stats['n_chunks']}, digest equal to "
        f"tests/golden/build/ba4k_build_r2s3.json")
    phase_t = log_phase(5, phase_t)

    # -- phase 6: card vs CPU, and the golden fixtures on the card ---------
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
    builds = {"eager": {}, "chunked-fast": {"build": "chunked",
                                            "memory_budget_bytes": 1 << 30},
              "chunked-sparse": {"build": "chunked", "build_chunk_size": 3}}
    for fname in sorted(os.listdir(gdir)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(gdir, fname)) as f:
            fx = json.load(f)
        for bname, kw in builds.items():
            d = decompose(suite[fx["graph"]](device="cuda"),
                          NucleusConfig(r=fx["r"], s=fx["s"], **kw))
            what = f"{fname} ({bname})"
            require(d.n_r == fx["n_r"], f"{what}: n_r differs")
            if d.n_r:
                require(np.array_equal(d.core, fx["core"]),
                        f"{what}: core differs from the fixture")
                for c, want in fx["partitions"].items():
                    require(np.array_equal(
                        canonicalize_labels(d.cut(int(c))), want),
                        f"{what}: cut({c}) differs from the fixture")
        n_fx += 1
    log(f"[golden] {n_fx} fixtures x {list(builds)}: core and cut "
        f"partitions equal on the card")
    phase_t = log_phase(6, phase_t)

    # -- phase 7: the result lines ------------------------------------------
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
