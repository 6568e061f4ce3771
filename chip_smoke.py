"""Smoke run of the PyTorch/CUDA port on one card: ``python3 chip_smoke.py``.

Drives ``repro_torch``'s main path, ``decompose(graph, NucleusConfig())`` at
its defaults ((2,3), exact, dense, fused hierarchy, eager build), on a seeded
graph of about a million vertices, ten million edges and ten million
triangles, then the memory-bounded chunked build on the card: its dense
(2,3) fast path on a 32,768-vertex graph and its sparse seed-chunked path on
the million-vertex graph, then LM inference of minicpm-2b at full width
(random seeded weights): a 32,768-token prefill through the flash-attention
kernel and a decode server, and last the nucleus server (a warm Session,
exact updates, a multi-tenant router and its HTTP surface).  Every kernel
of those paths is checked against its plain-torch version on the card.
Phases (any failure ends the run with a non-zero exit):

  1. device report and kernel build (nvcc, from src/repro_torch/kernels/csrc),
     printing what ptxas reports for every kernel: registers, static
     shared memory, spills;
  2. each kernel vs its plain version, with times: the round kernels at the
     smoke graph's plan (the megakernel also with every r-clique peeled,
     dying or unchanged, on one run of 150,000 edges, on the C = 2, 4, 6
     plans of golden problems and through unaligned views; the segment sum
     also through unaligned views and on runs that cross many of its
     tiles), tricount at ragged small n (densities 1e-3 and 0.3, an empty
     and a full row, the raise on values other than 0/1), on the 32k
     graph's oriented adjacency and on a dense input (n = 8,192, density
     0.3); the megakernel's bound counts what the timed round needs;
  3. the main path, with the megakernel's launch count == peel rounds, its
     traced device time summed over the rounds beside the path's bound
     (reckoned from order_round: the edges of the r-cliques still live
     after each round);
  4. the segment-sum path (``fused_kernel=False``), bit-identical to phase 3;
  5. the chunked build: ``decompose(g32k, build="chunked", 24 GiB budget)``
     takes the dense fast path (one tricount launch) and equals the eager
     decompose; the sparse path on the smoke graph (4 GiB budget, many
     chunks) reproduces phase 2's eager arrays; the ba4k build fingerprint
     of tests/golden/build;
  6. card vs CPU on a ~20k-vertex graph (exact and approx) and the golden
     fixtures of tests/golden on the card, eager and chunked (fast and
     sparse);
  7. every single-device configuration of decompose(): (1,2) on the smoke
     graph through the k-core lane (the segment-sum kernel, one launch a
     round, no megakernel) and with use_kernel=True through the generic
     engine on the megakernel, bit-identical, and the segment sum timed
     at the lane's plan; the gather backend at (2,3) and backend='auto'
     at a 4 GiB budget (dense/fused on the chunked build), each
     bit-identical to phase 3; dense/replay and dense/two_phase at (2,3)
     on the smoke graph, their trees timed and their cuts equal to phase
     3's (replay's forest and tree bit-identical); every other non-sharded (method, backend,
     hierarchy) on the SMALL_N graph, card == CPU with cuts at four
     levels equal to dense/fused's; the JSON artifact's round trip;
  8. LM inference: flash attention vs its plain twin at the model's head
     shapes (minicpm-2b, minitron-4b's GQA, stablelm-12b's head dim 160,
     ragged, f32, non-causal, Sq < Sk, the wgmma kernel's block and tile
     edges, B > 1) and at the prefill shape (the twin in query-row
     slices), each beside a control with the scale 3% off that the bar
     must reject, with its times at the prefill shape and at minitron-4b's
     (1, 24, 8, 4096, 128);
     ``lm_prefill_step`` of minicpm-2b at full width, B = 1, S = 32,768
     (one flash launch per layer); the card's ``forward`` vs the CPU's at
     full width with 2 layers in f32; ``serve_lm`` of the minicpm-2b and
     minitron-4b smoke configs on the card and the CPU (equal greedy
     tokens); ``serve_lm`` of minicpm-2b at full width on the card (decode
     runs the online scan: no flash launch);
  9. the nucleus server: ``Session().decompose`` of the smoke problem
     (counted in its pow2 shape bucket, run by ``decompose``'s engine),
     bit-identical to phase 3 with megakernel launches == rounds, and a
     warm same-bucket call; one seeded delta of 8 inserts and 8 deletes
     through ``Session.update`` at (2,3) and on phase 7's (1,2) artifact,
     each equal to a fresh decompose of the edited graph (core, uf_parent,
     tree, cuts at three levels; uf_L equal to the canonical-chain
     forest the update resolves, its entries apart from the fused peel's L
     counted); the warm pool: 6 graphs of 250,000 + 1,000·i
     vertices round-robin over (2,3) exact, (1,2) exact and (2,3) approx
     through one ``Router`` (3 pools, 3 warm hits, every artifact equal to
     ``decompose``, the megakernel or the k-core lane's segment sum
     launched once a round) with 16 queries per artifact (each nuclei
     answer's labels equal to its cut's); the HTTP
     server's selftest and a restart from its cache directory (every
     decompose warm); ``serve_nucleus`` on the saved smoke artifact;
 10. a JSON line of per-kernel numbers, the card's name and power limit,
     and the result line.

It needs a CUDA card and nvcc; it imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor-core rate (data sheet)
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
SMOKE_N = 1_000_000  # vertices of the smoke graph
SMALL_N = 20_000     # vertices of the card-vs-CPU graph
DENSE_N = 32_768     # vertices of the chunked build's dense fast-path graph
DENSE_BUDGET = 24 << 30   # >= 5·n²·4 at DENSE_N: the dense (2,3) fast path
SPARSE_BUDGET = 4 << 30   # far under 5·n²·4 at SMOKE_N: the sparse path
RAGGED_N = (1, 31, 33, 127, 130, 257)  # around tricount's 32-column words
TRICOUNT_DENSITY = (1e-3, 0.3)  # probe counts and popcount counts
DENSE_INPUT_N = 8_192    # tricount's dense input (density 0.3), timed
LONG_RUN = 150_000       # edges of one r-clique in peel_round's edge case
# (r, s) problems on golden graphs whose plans have C = 2, 4 and 6 members
GOLDEN_PLANS = (("planted40", 1, 2), ("planted40", 3, 4), ("er20", 2, 4))
LM_ARCH = "minicpm-2b"   # the LM path's model, at its published width
PREFILL_S = 32_768       # prefill_32k's sequence (its global batch 32 -> 1)
PLAIN_ROWS = 1_024       # query rows per slice of the plain twin at PREFILL_S
CPU_CHECK_S = 256        # card-vs-CPU forward: full width, 2 layers, f32
UPDATE_OPS = 8           # phase 9 (b): inserts and deletes of one delta
POOL_N = 250_000         # phase 9 (c): the warm pool's graphs have
POOL_STEP = 1_000        # POOL_N + POOL_STEP·i vertices
POOL_GRAPHS = 6          # ... round-robin over POOL_CONFIGS: 2 per pool
POOL_QUERIES = 16        # ... cut/nuclei queries per artifact
SERVE_QUERIES = 64       # phase 9 (e): queries of the saved artifact
POOL_CONFIGS = ({"r": 2, "s": 3}, {"r": 1, "s": 2},
                {"r": 2, "s": 3, "method": "approx"})
# flash attention vs its plain twin: (B, H, Hkv, Sq, Sk, D, causal, dtype)
FLASH_CASES = (
    (1, 2, 2, 96, 96, 64, True, torch.bfloat16),          # ragged
    (1, 36, 36, 4096, 4096, 64, True, torch.bfloat16),    # minicpm-2b
    (1, 24, 8, 4096, 4096, 128, True, torch.bfloat16),    # minitron-4b
    (1, 32, 8, 2048, 2048, 160, True, torch.bfloat16),    # stablelm-12b
    (1, 36, 36, 1000, 1000, 64, True, torch.float32),     # f32
    (1, 8, 8, 1000, 1000, 128, False, torch.bfloat16),    # non-causal
    (1, 24, 8, 700, 2000, 128, True, torch.bfloat16),     # Sq < Sk
    # the wgmma kernel's edges: blocks of 192 (D = 64) or 128 (D = 128)
    # query rows, tiles of 128 keys, B > 1 with GQA
    (1, 4, 4, 127, 127, 64, True, torch.bfloat16),
    (1, 4, 4, 129, 129, 64, True, torch.bfloat16),
    (1, 4, 2, 255, 255, 128, True, torch.bfloat16),
    (1, 4, 4, 257, 257, 64, False, torch.bfloat16),
    (3, 8, 2, 257, 257, 64, True, torch.bfloat16),
    (2, 6, 3, 255, 255, 128, False, torch.bfloat16),
    (1, 24, 8, 2048, 2048, 128, True, torch.bfloat16),
)
# minitron-4b's attention (GQA, D = 128), timed beside the prefill shape
FLASH_D128 = (1, 24, 8, 4096, 128)
# flash attention's bar: the largest ||got - want|| / ||want|| over output
# rows (a row is one query's D values).  bf16: the output's rounding is
# relative (half an ulp, 2^-9), so a bar relative to each row holds at every
# row, where an absolute one would be near the size of the late rows'
# values (about sqrt(e / (i + 1)) for randn inputs).  f32: sums in another
# order than the twin's, far under the ~1e-3 of a bf16 or TF32 product.
FLASH_ROW_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
CONTROL_SCALE = 1.03     # the control: q scaled, i.e. the softmax scale off


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


def int8_product(adj: torch.Tensor) -> torch.Tensor:
    """The int8 library call of tricount_oriented's function: a tensor-core
    product with int32 sums (exact for 0/1), then the f32 mask."""
    d8 = adj.to(torch.int8)
    return torch._int_mm(d8, d8.t()).to(torch.float32).mul_(adj)


def phase_tricount(g32k, seed: int):
    """Phase 2, tricount: kernel vs plain at ragged small n around the
    32-column words, at densities 1e-3 and 0.3 with an empty and a full row
    (both operand layouts, random 0/1 with no symmetry, so a transposed
    operand would show), the raise on values other than 0/1, on the 32k
    graph's oriented adjacency and on a dense input, with times."""
    from repro_torch.kernels.tricount import (tricount_oriented,
                                              tricount_oriented_plain,
                                              tricount_per_edge,
                                              tricount_per_edge_plain)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pairs = ((tricount_oriented, tricount_oriented_plain),
             (tricount_per_edge, tricount_per_edge_plain))
    for n in RAGGED_N:
        for density in TRICOUNT_DENSITY:
            a = (torch.rand((n, n), generator=gen, device="cuda") <
                 density).float()
            if n > 3:
                a[1] = 0.0  # an empty row
                a[2] = 1.0  # a full row
            for kernel, plain in pairs:
                require(torch.equal(kernel(a), plain(a)),
                        f"{kernel.__name__} differs from its plain version "
                        f"at n={n}, density {density}")
    for bad in (2.0, float("nan")):
        a = torch.zeros((70, 70), device="cuda")
        a[3, 69] = bad
        for kernel, _ in pairs:
            try:
                kernel(a)
            except ValueError:
                continue
            raise AssertionError(f"{kernel.__name__} took the value {bad}")
    log(f"[kernels] tricount oriented/per_edge at n={RAGGED_N}, densities "
        f"{TRICOUNT_DENSITY}, an empty and a full row: equal to plain; "
        f"2.0 and NaN raise")
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
    # product with int32 sums (exact for 0/1), bf16 with fp32 accumulation
    # (exact while counts stay under 2^8 in its bf16 output) and f32 on the
    # SIMT units (TF32 is off)
    def lib_int8():
        return int8_product(dense)

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

    # a dense input: every row holds ~0.3 n ones, more than its n / 32
    # bitset words, so the kernel counts by popcounts over whole rows
    n8 = DENSE_INPUT_N
    a = (torch.rand((n8, n8), generator=gen, device="cuda") < 0.3).float()
    want = tricount_oriented_plain(a)
    require(torch.equal(tricount_oriented(a), want),
            f"tricount_oriented differs from its plain version on the dense "
            f"input (n={n8}, density 0.3)")
    require(torch.equal(int8_product(a), want), "the int8 library product "
            "differs from the plain version on the dense input")
    nnz8 = int(a.sum())
    del want
    dense_in = {"shape": f"({n8}, {n8}) density 0.3, oriented",
                "ms": cuda_ms(lambda: tricount_oriented(a), 5),
                "plain_ms": cuda_ms(lambda: tricount_oriented_plain(a), 3,
                                    1),
                "library_ms": cuda_ms(lambda: int8_product(a), 5),
                "bound_ms": max(1e3 * 8.0 * n8 * n8 / HBM_BYTES_PER_S,
                                1e3 * 2.0 * n8 * nnz8 / INT8_OPS_PER_S)}
    del a
    torch.cuda.empty_cache()
    log(f"[kernels] tricount on the dense input {dense_in['shape']}: kernel "
        f"{dense_in['ms']:.4f} ms, plain {dense_in['plain_ms']:.4f} ms, int8 "
        f"library {dense_in['library_ms']:.4f} ms, bound "
        f"{dense_in['bound_ms']:.4f} ms")
    return {"name": "tricount", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tricount.cu",
            "replaces": "src/repro/kernels/tricount.py:67",
            "max_abs_err": err, "ms": tc_ms, "plain_ms": tc_plain,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib["int8 torch._int_mm"],
            "library_call": "torch._int_mm(D8, D8.t()) * D",
            "dense_input": dense_in}


def phase_kernels(problem, seed: int):
    """Phase 2: each kernel against its plain version at the real plan."""
    from repro_torch.core.engine import _round_plan, _scatter_plan
    from repro_torch.kernels.peel_round import (PEELED, fused_peel_round,
                                                peel_key, peel_round_plain)
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
        args = (offsets, members, deg, peel_key(deg, peeled), core, order,
                level, 7)
        got = fused_peel_round(*args)
        want = peel_round_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("deg", "key", "core", "order"), got, want):
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
    peel_round_edges(offsets, members, deg0, gen)
    pr_ms = cuda_ms(lambda: fused_peel_round(*timed_state), 20)
    pr_plain = cuda_ms(lambda: peel_round_plain(*timed_state), 3, 1)
    # the least bytes of the timed round on its input, each input read
    # once: the member rows (C int32) of the edges of the r-cliques that
    # are live and above level (the only ones whose deg' takes a dead
    # count), the offsets, and 8·n_r int32 of state in and out (the
    # members' keys are re-reads of the state); beside it the earlier
    # count, which read the whole plan and two gathered int32 per member
    deg_t, key_t, level_t = timed_state[2], timed_state[3], timed_state[6]
    counts = offsets[1:] - offsets[:-1]
    e_need = int(counts[(key_t != PEELED) & (deg_t > level_t)].sum())
    pr_bytes = 4 * (C * e_need + (n_r + 1) + 8 * n_r)
    pr_full = 4 * (3 * C * E + (n_r + 1) + 8 * n_r)
    log(f"[kernels] peel_round timed state (peeled fraction 0.3, level "
        f"{level_t}): {e_need} of {E} plan edges needed; bound by need "
        f"{1e3 * pr_bytes / HBM_BYTES_PER_S:.4f} ms, full plan with two "
        f"gathered int32 per member (the earlier count) "
        f"{1e3 * pr_full / HBM_BYTES_PER_S:.4f} ms")
    rows.append({"name": "peel_round", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/peel_round.cu",
                 "replaces": "src/repro/kernels/peel_round.py:142",
                 "max_abs_err": pr_err, "ms": pr_ms, "plain_ms": pr_plain,
                 "bound_ms": 1e3 * pr_bytes / HBM_BYTES_PER_S,
                 "bound_by": "bytes", "library_ms": None,
                 "needed_edges": e_need,
                 "bound_full_plan_ms": 1e3 * pr_full / HBM_BYTES_PER_S})

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
    # the flat-tile design's edges: views one row in (their pointers miss
    # the 16-byte vector loads' alignment) at the real plan, and three
    # segments over 200,000 rows (each run crosses many 4,096-row tiles)
    one = torch.ones((1, 1), dtype=torch.int32, device=dev)
    for what, d_in, i_in, n in (
            ("the plan through views one row in",
             torch.cat([one, data])[1:], torch.cat([rids[:1], rids])[1:],
             n_r),
            ("3 segments over 200,000 rows",
             torch.randint(-3, 4, (200_000, 1), generator=gen, device=dev,
                           dtype=torch.int32),
             torch.sort(torch.randint(0, 3, (200_000,), generator=gen,
                                      device=dev, dtype=torch.int32)).values,
             3)):
        require(torch.equal(segment_sum(d_in, i_in, n),
                            segment_sum_plain(d_in, i_in, n)),
                f"segment_sum int32 differs from its plain version on {what}")
        log(f"[kernels] segment_sum int32 on {what}: equal to plain")
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
                                             0, rids, data), 5)
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


def peel_round_edges(offsets, members, deg0, gen) -> None:
    """peel_round vs its plain version where the redesign could break: the
    skip's extremes on the smoke plan (every r-clique peeled, every one
    dying, none changing), one r-clique owning LONG_RUN edges beside runs
    of 1 to 3, the C = 2, 4 and 6 plans of GOLDEN_PLANS, and the smoke plan
    through views one element in (pointers off 16-byte alignment)."""
    from repro_torch.core import build_problem
    from repro_torch.core.engine import _round_plan
    from repro_torch.graph.generators import golden_suite
    from repro_torch.kernels.peel_round import (fused_peel_round, peel_key,
                                                peel_round_plain)
    dev = offsets.device

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def state_of(deg, peeled, core, order):
        return deg, peel_key(deg, peeled), core, order

    def check(what, offs, mem, state, level):
        args = (offs, mem) + tuple(state) + (level, 5)
        got = fused_peel_round(*args)
        want = peel_round_plain(*args)
        for name, a, b in zip(("deg", "key", "core", "order"), got, want):
            require(torch.equal(a, b), f"peel_round {name} differs from its "
                    f"plain version on {what}")

    n_r, level = int(deg0.shape[0]), 4
    zeros = torch.zeros(n_r, dtype=torch.int32, device=dev)
    core, order = ints(-1, 50, n_r), ints(-1, 50, n_r)
    for what, deg, peeled in (
            ("every r-clique peeled", deg0, zeros + 1),
            ("every r-clique dying", torch.clamp(deg0, max=level), zeros),
            ("no r-clique changing", deg0 + level + 1, zeros)):
        check(f"the smoke plan, {what}", offsets, members,
              state_of(deg, peeled, core, order), level)
    state = state_of(deg0 - ints(0, 3, n_r),
                     (ints(0, 10, n_r) < 3).to(torch.int32), core, order)
    check("the smoke plan through views one element in",
          *[torch.cat([x[:1], x])[1:] for x in (offsets, members)],
          [torch.cat([x[:1], x])[1:] for x in state], level)
    del state

    counts = ints(1, 4, 200_000)
    counts[100_000] = LONG_RUN
    offs = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(counts, 0, dtype=torch.int32)])
    n = counts.shape[0]
    mem = torch.randint(-1, n, (int(offs[-1]), 3), generator=gen,
                        device=dev, dtype=torch.int32)
    for level in (0, 4, 11):
        check(f"one run of {LONG_RUN} edges beside 199,999 of 1 to 3",
              offs, mem, state_of(ints(0, 12, n), ints(0, 10, n) < 3,
                                  ints(-1, 50, n), ints(-1, 50, n)), level)
    for name, r, s in GOLDEN_PLANS:
        p = build_problem(golden_suite()[name](device=dev), r, s, device=dev)
        offs, mem = _round_plan(p)
        n = p.n_r
        for level in (0, 4, 11):
            check(f"{name} ({r},{s}), C={mem.shape[1]}", offs, mem,
                  state_of(ints(0, 12, n), ints(0, 10, n) < 3,
                           ints(-1, 50, n), ints(-1, 50, n)), level)
    log(f"[kernels] peel_round on the smoke plan with every r-clique peeled,"
        f" dying or unchanged and through unaligned views, one run of "
        f"{LONG_RUN} edges, the C = 2, 4, 6 plans of {GOLDEN_PLANS}: equal "
        f"to plain")


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


def profile_peel(problem):
    """Where the peel's time goes: decompose() of the built problem (fused
    hierarchy on), once untraced and then once traced.  The trace's device
    events (kernels, copies) give the device time; the busy share is that
    over the untraced call's wall time, because tracing slows the host
    side.  Returns the megakernel's summed device seconds and launch count
    in the traced call (None, 0 when the trace has no device time)."""
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
        return None, 0
    log(f"[profile] peel with fused hierarchy: device time {busy:.2f} s "
        f"over {untraced_s:.2f} s untraced wall = "
        f"{100 * busy / untraced_s:.1f}% busy, "
        f"{100 * (1 - busy / untraced_s):.1f}% idle (traced wall "
        f"{traced_s:.2f} s, trace processing {total_s - traced_s:.1f} s)")
    for e in sorted(events, key=dev_us, reverse=True)[:6]:
        log(f"[profile]   {dev_us(e) / 1e6:8.3f} s  x{e.count:<7d} "
            f"{e.key[:90]}")
    mega = [e for e in events if "peel_round" in e.key]
    return (sum(dev_us(e) for e in mega) / 1e6,
            sum(e.count for e in mega))


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


def timed(fn):
    """(result, wall seconds) of fn(), ending in a device sync."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_lane_kernel(problem12, seed: int):
    """The segment sum at the k-core lane's shape: data (2m, 1) int32 (a
    peeled mask gathered by the neighbor slots) summed by the ascending
    vertex slots, over n vertices (isolated ones are empty segments)."""
    from repro_torch.core.kcore import kcore_plan
    from repro_torch.kernels.segment_sum import (segment_sum,
                                                 segment_sum_plain)
    vids, nbrs = kcore_plan(problem12)
    n, E = problem12.n_r, int(vids.shape[0])
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    err = 0
    for frac in (0.01, 0.5):
        a = (torch.rand(n, generator=gen, device="cuda") < frac).to(
            torch.int32)
        data = torch.index_select(a, 0, nbrs)[:, None]
        got = segment_sum(data, vids, n)
        want = segment_sum_plain(data, vids, n)
        require(torch.equal(got, want), f"segment_sum differs from its "
                f"plain version at the k-core lane's plan (frac {frac})")
        err = max(err, int((got - want).abs().max()))
    ms = cuda_ms(lambda: segment_sum(data, vids, n), 20)
    plain = cuda_ms(lambda: segment_sum_plain(data, vids, n), 5)
    lib = cuda_ms(lambda: torch.zeros((n, 1), dtype=torch.int32,
                                      device="cuda").index_add_(
                                          0, vids, data), 5)
    bound = 1e3 * 4 * (E + E + n) / HBM_BYTES_PER_S
    log(f"[configs] segment_sum at the k-core lane's plan (E={E}, n={n}): "
        f"equal to plain; kernel_ms={ms:.4f} plain_ms={plain:.4f} "
        f"library_ms={lib:.4f} bound_ms={bound:.4f}")
    return {"kcore_ms": ms, "kcore_plain_ms": plain, "kcore_library_ms": lib,
            "kcore_bound_ms": bound, "kcore_max_abs_err": err}


# the non-sharded triples phase 7 runs on the SMALL_N graph, card and CPU
# (dense/fused runs in phase 6, gather/none in phase 7's (b), dense/none in
# phase 3)
SWEEP = [(m, b, h) for m in ("exact", "approx")
         for b, h in (("gather", "replay"), ("gather", "two_phase"),
                      ("gather", "basic"), ("dense", "replay"),
                      ("dense", "two_phase"), ("dense", "basic"),
                      ("nh", "none"), ("nh", "two_phase"),
                      ("nh", "basic"))
         if not (m == "approx" and b == "nh")]


def phase_configs(g, main, small_fused, seed: int):
    """Phase 7: every single-device configuration of decompose().

    (a) (1,2) on the smoke graph: the k-core lane (segment-sum launches ==
    rounds, no megakernel), then use_kernel=True (the generic engine on
    the megakernel), bit-identical; (b) the gather backend at (2,3),
    bit-identical to phase 3; (b') dense/replay and dense/two_phase at
    (2,3), arrays and cuts equal to phase 3's; (c) backend='auto' at a 4 GiB budget:
    dense/fused on the chunked build, bit-identical to phase 3; (d) every
    other non-sharded triple on the SMALL_N graph, card == CPU, cuts equal
    to dense/fused's (``small_fused``: phase 6's dense/fused (card, CPU)
    decompositions of that graph by method); (e) the artifact's JSON round
    trip.  Returns the segment-sum row's k-core fields and the (1,2)
    k-core-lane artifact (phase 9 updates it)."""
    from repro_torch import Decomposition, NucleusConfig, decompose
    from repro_torch.core import build_problem, canonicalize_labels
    from repro_torch.kernels import launch_counts, reset_launch_counts

    # (a) the k-core lane vs the generic engine on the megakernel
    p12, build12_s = timed(lambda: build_problem(g, 1, 2))
    reset_launch_counts()
    lane, lane_s = timed(lambda: decompose(g, NucleusConfig(r=1, s=2)))
    lane_counts = dict(launch_counts)
    require(any(r.startswith("fast lane 'kcore'") for r in lane.plan.reasons),
            "the (1,2) plan does not record the k-core lane")
    require(lane_counts["segment_sum"] == lane.rounds and
            lane_counts["peel_round"] == 0,
            f"k-core lane launches {lane_counts} over {lane.rounds} rounds")
    reset_launch_counts()
    generic, generic_s = timed(lambda: decompose(
        lane.problem, NucleusConfig(r=1, s=2, use_kernel=True)))
    generic_counts = dict(launch_counts)
    require(generic_counts["peel_round"] == generic.rounds and
            generic_counts["segment_sum"] == 0,
            f"use_kernel=True at (1,2) launched {generic_counts}")
    require(lane.rounds == generic.rounds, "(1,2): rounds differ")
    for name in ("core", "order_round", "uf_parent", "uf_L"):
        require(np.array_equal(getattr(lane, name), getattr(generic, name)),
                f"(1,2): {name} differs between the lane and the engine")
    log(f"[configs] (1,2) on the smoke graph: n_r={lane.n_r} "
        f"n_s={lane.problem.n_s} rounds={lane.rounds}; k-core lane "
        f"decompose_s={lane_s:.2f} (build_s={build12_s:.2f}) launches="
        f"{lane_counts}; use_kernel=True on the built problem "
        f"decompose_s={generic_s:.2f} launches={generic_counts}; core, "
        f"order_round, rounds, uf_parent, uf_L bit-identical")
    row = {"kcore_path": "decompose(g, NucleusConfig(r=1, s=2))",
           "kcore_launches": lane_counts["segment_sum"]}
    row.update(phase_lane_kernel(p12, seed))
    lane12 = lane
    del lane, generic, p12
    torch.cuda.empty_cache()

    def same_as_main(dec, what, fields):
        require(dec.rounds == main["rounds"], f"{what}: rounds differ from "
                f"phase 3")
        for name in fields:
            require(np.array_equal(getattr(dec, name), main[name]),
                    f"{what}: {name} differs from phase 3")

    # (b) the gather backend at (2,3)
    gat, gat_s = timed(lambda: decompose(
        g, NucleusConfig(backend="gather", hierarchy="none")))
    same_as_main(gat, "gather", ("core", "order_round"))
    log(f"[configs] gather/none at (2,3) on the smoke graph: "
        f"decompose_s={gat_s:.2f} (build included); core, order_round, "
        f"rounds equal to phase 3")
    del gat

    # (b') the host hierarchies at (2,3): dense/replay (the forest replayed
    # from the peel trace) and dense/two_phase (the per-level sweep), each
    # on one build, the tree timed apart from the peel
    p23 = build_problem(g, 2, 3)
    for h in ("replay", "two_phase"):
        dec, peel_s = timed(lambda: decompose(p23, NucleusConfig(
            hierarchy=h)))
        same_as_main(dec, f"dense/{h}", ("core", "order_round"))
        tree, tree_s = timed(lambda: dec.tree)
        if h == "replay":
            same_as_main(dec, "dense/replay", ("uf_parent", "uf_L"))
            require(np.array_equal(tree.parent, main["tree_parent"]) and
                    np.array_equal(tree.level, main["tree_level"]),
                    "dense/replay: tree differs from phase 3's")
        t = time.perf_counter()
        for c, want in main["cuts"].items():
            require(np.array_equal(canonicalize_labels(dec.cut(c)), want),
                    f"dense/{h}: cut({c}) differs from phase 3's")
        cut_s = time.perf_counter() - t
        log(f"[configs] dense/{h} at (2,3) on the smoke graph: "
            f"decompose_s={peel_s:.2f} (on the built problem) tree_s="
            f"{tree_s:.2f} ({tree.n_nodes} nodes) cuts at "
            f"{sorted(main['cuts'])} {cut_s:.2f} s; core, order_round, "
            f"rounds{', forest, tree' if h == 'replay' else ''} and cuts "
            f"equal to phase 3")
        del dec, tree
    del p23
    torch.cuda.empty_cache()

    # (c) backend='auto' under a 4 GiB budget
    reset_launch_counts()
    auto, auto_s = timed(lambda: decompose(
        g, NucleusConfig(backend="auto", memory_budget_bytes=SPARSE_BUDGET)))
    require((auto.plan.backend, auto.plan.hierarchy) == ("dense", "fused")
            and auto.config.build == "chunked",
            f"auto resolved to {auto.plan.backend}/{auto.plan.hierarchy} "
            f"on build {auto.config.build}")
    require(launch_counts["peel_round"] == auto.rounds,
            "auto: megakernel launches != rounds")
    same_as_main(auto, "auto", ("core", "order_round", "uf_parent", "uf_L"))
    log(f"[configs] backend='auto', memory_budget_bytes={SPARSE_BUDGET}: "
        f"decompose_s={auto_s:.2f} (chunked build included), arrays equal "
        f"to phase 3\n{auto.plan_report()}")
    del auto
    torch.cuda.empty_cache()

    # (d) every other non-sharded triple on SMALL_N, card and CPU
    probs = {"cuda": small_fused["exact"][0].problem,
             "cpu": small_fused["exact"][1].problem}
    fused = {m: pair[1] for m, pair in small_fused.items()}
    levels = {}
    for m, d in fused.items():
        lv = np.unique(d.core[d.core > 0])
        levels[m] = lv[np.linspace(0, lv.size - 1, 4).astype(int)]
    def with_tree(dec):
        if dec.has_hierarchy:
            dec.tree
        return dec
    tp_cuts = {}
    times = []
    swept = {("exact", "dense", "fused"): small_fused["exact"][0]}
    for triple in SWEEP:
        m, b, h = triple
        cfg = NucleusConfig(method=m, backend=b, hierarchy=h)
        (d_gpu, t_gpu) = timed(lambda: with_tree(decompose(probs["cuda"],
                                                           cfg)))
        t = time.perf_counter()
        d_cpu = with_tree(decompose(probs["cpu"], cfg, device="cpu"))
        t_cpu = time.perf_counter() - t
        what = "/".join(triple)
        require(d_gpu.rounds == d_cpu.rounds, f"{what}: rounds differ")
        for name in ("core", "order_round", "peel_value"):
            a, c = getattr(d_gpu, name), getattr(d_cpu, name)
            require((a is None and c is None) or np.array_equal(a, c),
                    f"{what}: {name} differs between card and CPU")
        require(np.array_equal(d_cpu.core, fused[m].core),
                f"{what}: core differs from dense/fused")
        if h != "none":
            for c in levels[m]:
                cut = canonicalize_labels(d_gpu.cut(int(c)))
                require(np.array_equal(
                    cut, canonicalize_labels(d_cpu.cut(int(c)))),
                    f"{what}: cut({c}) differs between card and CPU")
                # approx two_phase/basic trees are built over the clipped
                # estimates, fused/replay over the raw bucket values
                if m == "exact" or h == "replay":
                    want = canonicalize_labels(fused[m].cut(int(c)))
                else:
                    want = tp_cuts.setdefault((m, int(c)), cut)
                require(np.array_equal(cut, want),
                        f"{what}: cut({c}) differs from its reference tree")
        times.append(f"{what} {t_gpu:.2f}/{t_cpu:.2f}")
        swept[triple] = d_gpu
    log(f"[configs] SMALL_N n_r={probs['cpu'].n_r}: {len(SWEEP)} triples "
        f"card == CPU, cuts at levels {levels} equal to dense/fused's "
        f"(approx two_phase/basic: to each other); card/CPU s (tree "
        f"included): "
        f"{', '.join(times)}")

    # (e) the artifact
    for triple in (("exact", "dense", "fused"), ("exact", "nh",
                                                  "two_phase")):
        live = swept[triple]
        (blob, json_s) = timed(live.to_json)
        loaded = Decomposition.from_json(blob)
        require(loaded.to_json() == blob, f"{triple}: JSON round trip "
                f"is not byte for byte")
        for c in levels["exact"]:
            require(np.array_equal(loaded.cut(int(c)), live.cut(int(c))),
                    f"{triple}: loaded cut({c}) differs")
            a, z = loaded.nuclei(int(c)), live.nuclei(int(c))
            require(sorted(a) == sorted(z) and all(
                np.array_equal(a[k].vertices, z[k].vertices) and
                a[k].density == z[k].density for k in a),
                f"{triple}: loaded nuclei({c}) differ")
        log(f"[configs] {'/'.join(triple)} artifact: {len(blob)} bytes in "
            f"{json_s:.2f} s, round trip byte for byte, cut/nuclei equal")
    return row, lane12


def flash_inputs(gen, B, H, Hkv, Sq, Sk, D, dtype):
    """q, k, v as the model hands them to the kernel: (B, S, H, D) tensors
    viewed as (B, H, S, D)."""
    def make(S, heads):
        return torch.randn((B, S, heads, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype).transpose(1, 2)
    return make(Sq, H), make(Sk, Hkv), make(Sk, Hkv)


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of ||got - want|| / ||want||, norms over the last
    (head) dim."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30))
                 .max())


def plain_causal_rows(q, k, v, rows: int = PLAIN_ROWS) -> torch.Tensor:
    """The plain twin's causal output for Sq == Sk and H == Hkv, query rows
    [i0, i1) at a time against keys [0, i1): ``ref.attention_ref``'s f32
    scores, -inf mask by index, softmax and cast, with rows * i1 scores per
    slice instead of S * S (155 GB in f32 at minicpm-2b's 36 heads and
    S = 32,768)."""
    S, D = q.shape[2], q.shape[3]
    out = torch.empty_like(q)
    for i0 in range(0, S, rows):
        i1 = min(i0 + rows, S)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, i0:i1].float(),
                         k[:, :, :i1].float()) / math.sqrt(D)
        mask = (torch.arange(i1, device=q.device)[None, :] <=
                torch.arange(i0, i1, device=q.device)[:, None])
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        out[:, :, i0:i1] = torch.einsum("bhqk,bhkd->bhqd", p,
                                        v[:, :, :i1].float()).to(q.dtype)
        del p
    return out


def check_flash(got, want, ctl, dt, what: str):
    """Requires got within FLASH_ROW_TOL of want and the control (the kernel
    with q * CONTROL_SCALE) outside it; returns (max abs err, row err,
    control's row err)."""
    tol = FLASH_ROW_TOL[dt]
    e = float((got.float() - want.float()).abs().max())
    r, c = row_rel_err(got, want), row_rel_err(ctl, want)
    require(r <= tol, f"flash_attention differs from its plain twin at "
            f"{what}: row rel err {r} > {tol} (max abs err {e})")
    require(c > tol, f"the bar does not reject the scale-x{CONTROL_SCALE} "
            f"control at {what}: row rel err {c} <= {tol}")
    log(f"[lm] flash_attention {what}: row rel err {r:.3g}, max abs err "
        f"{e:.3g} (bar: row rel {tol}); control scale x{CONTROL_SCALE}: "
        f"row rel err {c:.3g}")
    return e, r, c


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def profile_decode(params, cfg, steps: int = 8) -> None:
    """Where a full-width decode step's time goes: `steps` warm steps of
    4 slots timed on the host clock (each ending in a sync), then one step
    traced: its device time, kernel launches and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import lm_decode_step
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, 4, steps + 2, device="cuda")
    tok = torch.zeros((4, 1), dtype=torch.int64, device="cuda")
    n, walls = 0, []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        nxt, cache, n = lm_decode_step(params, tok, cache, n, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        tok = nxt[:, None]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lm_decode_step(params, tok, cache, n, cfg)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    wall_ms = 1e3 * float(np.median(walls[1:]))
    log(f"[lm] decode step, full width, 4 slots: wall {wall_ms:.3f} ms "
        f"(median of {steps - 1} warm steps; first {1e3 * walls[0]:.1f} "
        f"ms), traced device time {busy_ms:.3f} ms in {n_kernels} kernels"
        f" = {100 * busy_ms / wall_ms:.1f}% busy")


def phase_lm(seed: int):
    """Phase 7: flash attention vs its plain twin and its times, then the
    LM path of minicpm-2b: full-width prefill, card vs CPU, serving."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.steps import lm_prefill_step
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(seed)
    err = row_err = 0.0
    for B, H, Hkv, Sq, Sk, D, causal, dt in FLASH_CASES:
        q, k, v = flash_inputs(gen, B, H, Hkv, Sq, Sk, D, dt)
        got = flash_attention(q, k, v, causal)
        ctl = flash_attention(q * CONTROL_SCALE, k, v, causal)
        want = flash_attention_plain(q, k, v, causal)
        e, r, _ = check_flash(got, want, ctl, dt,
                              f"B={B} H={H} Hkv={Hkv} Sq={Sq} Sk={Sk} D={D} "
                              f"causal={causal} {str(dt)[6:]}")
        err, row_err = max(err, e), max(row_err, r)
        del got, ctl, want, q, k, v
    torch.cuda.empty_cache()

    # the prefill's shape: the kernel vs the twin in query-row slices, then
    # the kernel's, the twin's and SDPA's times on the same inputs
    H, D, S = 36, 64, PREFILL_S
    q, k, v = flash_inputs(gen, 1, H, H, S, S, D, torch.bfloat16)
    got = flash_attention(q, k, v, True)
    ctl = flash_attention(q * CONTROL_SCALE, k, v, True)
    want = plain_causal_rows(q, k, v)
    e, r, _ = check_flash(got, want, ctl, torch.bfloat16,
                          f"(1, {H}, {S}, {D}) bf16 causal (twin in "
                          f"{PLAIN_ROWS}-row slices)")
    err, row_err = max(err, e), max(row_err, r)
    del ctl
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(q, k, v, is_causal=True)
    lib_err, lib_want = row_rel_err(got, lib), row_rel_err(lib, want)
    # two bf16 outputs of one function, each within ~2^-9 of the f32 value
    require(lib_err <= FLASH_ROW_TOL[torch.bfloat16],
            f"flash_attention differs from SDPA at the prefill shape: row "
            f"rel err {lib_err}")
    del got, want, lib
    torch.cuda.empty_cache()
    fa_ms = cuda_ms(lambda: flash_attention(q, k, v, True), 10)
    lib_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True), 10)
    plain_ms = cuda_ms(lambda: plain_causal_rows(q, k, v), 2, 1)
    del q, k, v
    torch.cuda.empty_cache()
    ops_ms = 1e3 * 4.0 * D * H * S * (S + 1) / 2 / BF16_FLOPS_PER_S
    bytes_ms = 1e3 * 4.0 * S * H * D * 2 / HBM_BYTES_PER_S
    log(f"[lm] flash_attention (1, {H}, {S}, {D}) bf16 causal: kernel "
        f"{fa_ms:.4f} ms, plain (sliced) {plain_ms:.4f} ms, SDPA "
        f"{lib_ms:.4f} ms (row rel err kernel vs SDPA {lib_err:.3g}, SDPA "
        f"vs plain {lib_want:.3g}), bound {max(ops_ms, bytes_ms):.4f} ms "
        f"(operations {ops_ms:.4f}, bytes {bytes_ms:.4f})")

    # minitron-4b's attention (GQA, D = 128: the two-warpgroup variant),
    # held to its twin in FLASH_CASES; here its times beside SDPA's
    B, H2, Hkv2, S2, D2 = FLASH_D128
    q, k, v = flash_inputs(gen, B, H2, Hkv2, S2, S2, D2, torch.bfloat16)
    d128 = {"shape": f"{FLASH_D128[:3] + (S2, D2)} bf16 causal",
            "ms": cuda_ms(lambda: flash_attention(q, k, v, True), 20),
            "library_ms": cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                               enable_gqa=True), 20)}
    d128_ops = 1e3 * 4.0 * D2 * H2 * S2 * (S2 + 1) / 2 / BF16_FLOPS_PER_S
    d128_bytes = 1e3 * 2.0 * S2 * D2 * 2 * (H2 + Hkv2) / HBM_BYTES_PER_S
    d128["bound_ms"] = max(d128_ops, d128_bytes)
    d128["bound_by"] = "operations" if d128_ops >= d128_bytes else "bytes"
    del q, k, v
    log(f"[lm] flash_attention {d128['shape']}: kernel {d128['ms']:.4f} ms, "
        f"SDPA {d128['library_ms']:.4f} ms, bound {d128['bound_ms']:.4f} ms "
        f"(operations {d128_ops:.4f}, bytes {d128_bytes:.4f})")

    # the main path: lm_prefill_step at full width, B = 1, S = 32,768
    cfg = get_arch(LM_ARCH).make_config()
    t = time.perf_counter()
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    toks = torch.randint(0, cfg.vocab, (1, PREFILL_S), generator=gen,
                         device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    nxt = lm_prefill_step(params, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_counts = dict(launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(prefill_counts["flash_attention"] == cfg.n_layers,
            f"prefill launched flash attention "
            f"{prefill_counts['flash_attention']} times, not n_layers="
            f"{cfg.n_layers}")
    # again, split as lm_prefill_step is, to read the last logits
    t = time.perf_counter()
    last = T.head(params, T.trunk(params, toks, cfg)[:, -1], cfg)
    torch.cuda.synchronize()
    prefill2_s = time.perf_counter() - t
    require(tuple(last.shape) == (1, cfg.vocab) and
            bool(torch.isfinite(last).all()), "prefill logits not finite")
    require(torch.equal(torch.argmax(last, dim=-1), nxt),
            "the prefill's argmax differs between two runs")
    n_params = cfg.param_count()
    log(f"[lm] {LM_ARCH} prefill B=1 S={PREFILL_S}: {n_params} params "
        f"(bf16, init {init_s:.2f} s), prefill {prefill_s:.3f} s (again "
        f"{prefill2_s:.3f} s), peak {peak_gb:.2f} GB, next token "
        f"{int(nxt)}, launches={prefill_counts}")

    # full-width serving on the card: decode runs the online scan
    reset_launch_counts()
    t = time.perf_counter()
    served = serve_lm(LM_ARCH, n_requests=8, batch_slots=4, smoke=False,
                      params=params, device="cuda")
    serve_s = time.perf_counter() - t
    serve_counts = dict(launch_counts)
    require(serve_counts["flash_attention"] == 0,
            "flash attention launched during decode")
    require(sorted(served) == list(range(8)) and all(
        x.shape == (24,) and ((x >= 0) & (x < cfg.vocab)).all()
        for x in served.values()), "full-width serving output malformed")
    log(f"[lm] serve_lm({LM_ARCH!r}, 8 requests, 4 slots, full width): "
        f"{serve_s:.2f} s, launches={serve_counts}")
    profile_decode(params, cfg)
    del params, last, toks
    torch.cuda.empty_cache()

    # card vs CPU: full width, 2 layers, f32 (TF32 is off since phase 1)
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    cpu_params = T.init_params(cfg2, generator=torch.Generator().manual_seed(
        seed), device="cpu")
    toks = torch.randint(0, cfg2.vocab, (1, CPU_CHECK_S),
                         generator=torch.Generator().manual_seed(seed))
    t = time.perf_counter()
    want = T.forward(cpu_params, toks, cfg2)
    cpu_s = time.perf_counter() - t
    reset_launch_counts()
    got = T.forward(to_device(cpu_params, "cuda"), toks.cuda(), cfg2).cpu()
    require(launch_counts["flash_attention"] == cfg2.n_layers,
            "the card's forward did not run the kernel once per layer")
    e = float((got - want).abs().max())
    # f32 products of length 2304..5760 summed in another order by cuBLAS
    # and the CPU, through two layers: ~1e-5 on logits of order 1
    require(torch.allclose(got, want, rtol=1e-3, atol=1e-3),
            f"card forward differs from CPU forward: max abs err {e}")
    log(f"[lm] forward {LM_ARCH} full width, 2 layers, f32, S="
        f"{CPU_CHECK_S}: card == CPU (max abs err {e:.3g}, rtol/atol 1e-3;"
        f" CPU {cpu_s:.2f} s)")
    del cpu_params, got, want

    # the smoke configs' serving, card vs CPU, with the same weights
    for arch in ("minicpm-2b", "minitron-4b"):
        scfg = get_arch(arch).make_smoke_config()
        sp = T.init_params(scfg, generator=torch.Generator().manual_seed(
            seed), device="cpu")
        reset_launch_counts()
        on_card = serve_lm(arch, params=to_device(sp, "cuda"),
                           device="cuda", quiet=True)
        on_cpu = serve_lm(arch, params=sp, device="cpu", quiet=True)
        require(launch_counts["flash_attention"] == 0,
                "flash attention launched during smoke decode")
        require(sorted(on_card) == sorted(on_cpu) and all(
            np.array_equal(on_card[r], on_cpu[r]) for r in on_cpu),
            f"serve_lm({arch!r}) smoke: card tokens differ from the CPU's")
        log(f"[lm] serve_lm({arch!r}) smoke: {len(on_cpu)} requests, equal "
            f"greedy tokens on card and CPU")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:72",
            "launches": prefill_counts["flash_attention"],
            "max_abs_err": err, "max_row_rel_err": row_err,
            "tolerance": "row rel L2 1e-2 bf16, 1e-4 f32",
            "ms": fa_ms, "plain_ms": plain_ms,
            "plain_call": f"attention_ref in {PLAIN_ROWS}-query-row slices",
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms,
            "library_call": "scaled_dot_product_attention(is_causal=True)",
            "shape": f"(1, {H}, {PREFILL_S}, {D}) bf16 causal",
            "routes": "bf16 D=64: wgmma/TMA, 3 consumer warpgroups; bf16 "
                      "D=128: wgmma/TMA, 2; bf16 D=160 and f32: the first "
                      "design (mma.sync m16n8k16 / FMA)",
            "d128": d128,
            "path": f"lm_prefill_step({LM_ARCH}, B=1, S={PREFILL_S})"}


def smoke_delta(g, seed: int):
    """A seeded GraphDelta of UPDATE_OPS inserts (absent pairs) and
    UPDATE_OPS deletes (present edges) of the graph g."""
    from repro_torch import GraphDelta
    rng = np.random.default_rng(seed + 9)
    edges = g.edges.cpu().numpy().astype(np.int64)
    keys = set(((edges[:, 0] << 32) | edges[:, 1]).tolist())
    ins = []
    while len(ins) < UPDATE_OPS:
        u, v = sorted(int(x) for x in rng.integers(0, g.n, 2))
        if u != v and (u << 32) | v not in keys:
            keys.add((u << 32) | v)
            ins.append((u, v))
    dels = edges[rng.choice(edges.shape[0], UPDATE_OPS, replace=False)]
    return GraphDelta(insert=np.array(ins), delete=dels)


def same_arrays(got, want, fields, what: str) -> None:
    for name in fields:
        require(np.array_equal(np.asarray(getattr(got, name)),
                               np.asarray(want[name] if isinstance(want, dict)
                                          else getattr(want, name))),
                f"{what}: {name} differs")


def quantile_levels(core: np.ndarray):
    levels = np.unique(core[core > 0])
    return sorted({int(c) for c in np.quantile(levels, [0.25, 0.5, 0.9])
                   .astype(int)}) if levels.size else []


def chain_forest(dec):
    """(parent, L) of the canonical chain multiset (each s-clique's members
    sorted by core, consecutive pairs linked) over dec's problem and core:
    the forest ``update`` resolves."""
    from repro_torch.core.streaming import _chain_forest
    p = dec.problem
    return _chain_forest(p.inc_rid, torch.as_tensor(dec.core,
                                                    device=p.device), None)


def log_step(name: str, since: float) -> float:
    now = time.perf_counter()
    log(f"[server] ({name}) {now - since:.2f} s")
    return now


def phase_server(g, main, lane12, seed: int):
    """Phase 9: the nucleus server on the card.

    (a) ``Session().decompose`` of the smoke problem (its pow2 bucket
    counted, ``decompose``'s engine run), bit-identical to phase 3 with
    megakernel launches == rounds, then a warm same-bucket call; (b) one
    seeded delta of UPDATE_OPS inserts and deletes through ``Session.update``
    at (2,3) (on (a)'s artifact) and (1,2) (on phase 7's k-core-lane
    artifact), each equal to a fresh decompose of the edited graph; (c) the
    warm pool: POOL_GRAPHS graphs round-robin over POOL_CONFIGS through one
    ``Router``, bit-identical to ``decompose``, launches == rounds, and
    POOL_QUERIES queries per artifact; (d) the HTTP server's selftest and a
    restart from its cache directory; (e) ``serve_nucleus`` on (a)'s saved
    artifact.  Returns the launch counts of (c)'s pools by kernel."""
    import tempfile

    from repro_torch import NucleusConfig, Session, decompose
    from repro_torch.core import build_problem
    from repro_torch.graph.generators import community_power_law
    from repro_torch.kernels import _build, launch_counts, \
        reset_launch_counts
    from repro_torch.launch.serve import serve_nucleus, serve_nucleus_server
    from repro_torch.serve import Request, Router
    forest = ("core", "uf_parent", "uf_L")

    step_t = time.perf_counter()
    # (a) the Session at the smoke size
    p23 = build_problem(g, 2, 3)
    sess = Session()
    reset_launch_counts()
    art, cold_s = timed(lambda: sess.decompose(p23))
    counts = dict(launch_counts)
    key = sess.bucket_key(p23)
    require(counts["peel_round"] == art.rounds and
            counts["segment_sum"] == 0,
            f"Session launches {counts} over {art.rounds} rounds")
    require(art.rounds == main["rounds"], "Session: rounds differ")
    same_arrays(art, main, ("core", "order_round", "uf_parent", "uf_L"),
                "Session vs phase 3")
    _, warm_s = timed(lambda: sess.decompose(p23))
    require(sess.stats["warm"] == 1 and sess.stats["cold"] == 1,
            f"the second same-bucket decompose is not warm: {sess.stats}")
    log(f"[server] Session().decompose at the smoke size: bucket n_r_pad="
        f"{key[4]} n_s_pad={key[5]} e_pad={key[7]} (plan "
        f"{4 * key[7] * p23.n_sub} B); rounds={art.rounds}, launches="
        f"{counts}; core, order_round, rounds, uf_parent, uf_L equal to "
        f"phase 3; cold {cold_s:.2f} s, warm {warm_s:.2f} s (phase 3's "
        f"decompose, build included: {main['decompose_s']:.2f} s)")
    del p23

    step_t = log_step("a", step_t)
    # (b) one delta through Session.update at (2,3) and (1,2)
    delta = smoke_delta(g, seed)
    for cfg, live in ((NucleusConfig(), art),
                      (NucleusConfig(r=1, s=2), lane12)):
        what = f"update ({cfg.r},{cfg.s})"
        usess = sess if cfg.s == 3 else Session(cfg)
        new, upd_s = timed(lambda: usess.update(live, delta))
        fresh, fresh_s = timed(lambda: decompose(new.problem.g, cfg))
        same_arrays(new, fresh, ("core", "uf_parent"),
                    f"{what} vs a fresh decompose")
        require(np.array_equal(new.tree.parent, fresh.tree.parent) and
                np.array_equal(new.tree.level, fresh.tree.level),
                f"{what}: the tree differs from a fresh decompose")
        cuts = quantile_levels(fresh.core)
        for c in cuts:
            require(np.array_equal(new.cut(c), fresh.cut(c)),
                    f"{what}: cut({c}) differs from a fresh decompose")
        # uf_L: the update re-resolves the canonical chain multiset (as the
        # reference does), whose L ties can break apart from the fused
        # peel's link stream; it must equal that multiset's forest on the
        # fresh problem exactly, and the count apart from the fused L is
        # reported
        chain_L = chain_forest(fresh)[1]
        require(np.array_equal(new.uf_L, chain_L),
                f"{what}: uf_L differs from the canonical-chain forest")
        apart = int((new.uf_L != fresh.uf_L).sum())
        st = usess.stats
        log(f"[server] {what}: {delta.n_ops} ops in {upd_s:.2f} s "
            f"({upd_s / delta.n_ops:.3f} s/op; fresh decompose "
            f"{fresh_s:.2f} s); {new.update_stats}; stream_warm="
            f"{st['stream_warm']} stream_cold={st['stream_cold']}; core, "
            f"uf_parent, tree and cut at {cuts} equal to a fresh decompose;"
            f" uf_L equal to the canonical-chain forest, {apart} of "
            f"{new.n_r} entries apart from the fused peel's L")
        del new, fresh
    del lane12
    torch.cuda.empty_cache()

    step_t = log_step("b", step_t)
    # (c) the warm pool at real size
    router = Router()
    pool_launches = {"peel_round": 0, "segment_sum": 0}
    per_pool = {}
    spent = {"graph and build": 0.0, "decompose twin": 0.0, "queries": 0.0}
    lat_us = []
    rng = np.random.default_rng(seed)
    for i in range(POOL_GRAPHS):
        cfg = POOL_CONFIGS[i % len(POOL_CONFIGS)]
        t = time.perf_counter()
        gi = community_power_law(POOL_N + POOL_STEP * i, seed=i,
                                 device="cuda")
        pi = build_problem(gi, cfg["r"], cfg["s"])
        torch.cuda.synchronize()
        spent["graph and build"] += time.perf_counter() - t
        reset_launch_counts()
        dec, dec_s = timed(lambda: router.route(Request(graph=pi, **cfg)))
        counts = dict(launch_counts)
        kernel = "segment_sum" if cfg["s"] == 2 else "peel_round"
        require(counts[kernel] == dec.rounds and sum(counts.values()) ==
                dec.rounds, f"pool {cfg}: launches {counts} over "
                f"{dec.rounds} rounds")
        pool_launches[kernel] += counts[kernel]
        want, twin_s = timed(lambda: decompose(pi, NucleusConfig(**cfg)))
        spent["decompose twin"] += twin_s
        require(dec.rounds == want.rounds, f"pool {cfg}: rounds differ")
        same_arrays(dec, want, forest + ("order_round", "peel_value"),
                    f"pool {cfg} vs decompose")
        kmax = int(dec.core.max())
        for q, c in enumerate(rng.integers(1, max(kmax, 1) + 1,
                                           size=POOL_QUERIES)):
            t = time.perf_counter()
            got = dec.nuclei(int(c)) if q % 2 else dec.cut(int(c))
            lat_us.append((time.perf_counter() - t) * 1e6)
            if q % 2:
                labels = dec.cut(int(c))
                require(set(got) == set(np.unique(labels[labels >= 0])
                                        .tolist()),
                        f"pool {cfg}: nuclei({c}) and cut({c}) disagree")
        spent["queries"] += sum(lat_us[-POOL_QUERIES:]) / 1e6
        per_pool.setdefault(str(cfg), []).append(
            f"{dec_s:.2f} s (n={gi.n} m={gi.m} n_r={pi.n_r} n_s={pi.n_s} "
            f"rounds={dec.rounds})")
        del gi, pi, dec, want
    report = router.report()
    warm = sum(p["stats"]["warm"] for p in report["pools"])
    buckets = [b for p in report["pools"] for b in p["buckets"]]
    require(len(report["pools"]) == len(POOL_CONFIGS) and
            warm == POOL_GRAPHS - len(POOL_CONFIGS) and
            len(buckets) == len(POOL_CONFIGS),
            f"warm pool: {len(report['pools'])} pools, {warm} warm hits, "
            f"buckets {buckets}")
    lat = np.asarray(lat_us)
    log(f"[server] warm pool: {POOL_GRAPHS} graphs, {len(report['pools'])} "
        f"pools, {warm} warm hits, buckets {buckets}; decompose cold, warm "
        f"per pool: {per_pool}; launches {pool_launches}; every artifact "
        f"equal to decompose; {lat.size} queries p50="
        f"{np.percentile(lat, 50):.0f} us p95={np.percentile(lat, 95):.0f}"
        f" us; seconds spent besides the routed decomposes: "
        f"{ {k: round(v, 2) for k, v in spent.items()} }")
    del router
    torch.cuda.empty_cache()

    step_t = log_step("c", step_t)
    # (d) the HTTP server, then a restart from its cache directory
    build_dir = _build.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        try:
            first, first_s = timed(lambda: serve_nucleus_server(
                selftest=True, cache_dir=tmp, quiet=True))
            again, again_s = timed(lambda: serve_nucleus_server(
                selftest=True, cache_dir=tmp, quiet=True))
        finally:
            _build.set_build_dir(build_dir)
    require(again["prewarmed"] >= 1 and
            again["warm_hits"] == again["decomposes"],
            f"the restarted server did not start warm: {again}")
    log(f"[server] HTTP selftest {first} in {first_s:.2f} s; restart from "
        f"its cache directory {again} in {again_s:.2f} s (every decompose "
        f"warm)")

    step_t = log_step("d", step_t)
    # (e) serialized-artifact queries at the smoke size
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.json")
        _, save_s = timed(lambda: art.save(path))
        size = os.path.getsize(path)
        stats, serve_s = timed(lambda: serve_nucleus(
            path, n_queries=SERVE_QUERIES, seed=seed, quiet=True))
    require(stats["queries"] == SERVE_QUERIES and stats["n_r"] == art.n_r,
            f"serve_nucleus: {stats}")
    log(f"[server] serve_nucleus on the saved smoke artifact ({size} B, "
        f"saved in {save_s:.2f} s): {stats['queries']} queries "
        f"({stats['cut']} cut, {stats['nuclei']} nuclei) at "
        f"{stats['qps']:.2f} q/s, p50={stats['p50_us']:.0f} us "
        f"p95={stats['p95_us']:.0f} us; load + queries {serve_s:.2f} s")
    log_step("e", step_t)
    return pool_launches


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
    mega_s, mega_n = profile_peel(p)
    # the path's least bytes, reckoned from the run: in round t the needed
    # r-cliques are those peeled after it (order_round > t), so their
    # member rows are read in order_round rounds; each round also streams
    # the offsets and 8·n_r int32 of state
    counts = (p.mem_offsets[1:] - p.mem_offsets[:-1]).long()
    order_t = torch.as_tensor(dec.order_round, device="cuda").long()
    path_edges = int((counts * order_t).sum())
    n_plan = int(p.mem_sids.shape[0])
    C = int(p.inc_rid.shape[1])
    path_bytes = 4 * (C * path_edges + dec.rounds * (9 * p.n_r + 1))
    path_bound_s = path_bytes / HBM_BYTES_PER_S
    log(f"[main] megakernel over the {dec.rounds} rounds (traced): "
        f"{mega_s if mega_s is None else round(mega_s, 4)} s device time in "
        f"{mega_n} launches; the path's bound by need {path_bound_s:.4f} s "
        f"({path_edges} needed edge reads = "
        f"{path_edges / max(1, dec.rounds * n_plan):.4f} of rounds x E)")
    rows[0]["path_ms"] = None if mega_s is None else 1e3 * mega_s
    rows[0]["path_launches"] = mega_n
    rows[0]["path_bound_ms"] = 1e3 * path_bound_s
    levels = np.unique(dec.core[dec.core > 0])
    t = time.perf_counter()
    tree = dec.tree
    tree_s = time.perf_counter() - t
    log(f"[main] tree: {tree.n_nodes} nodes ({tree.n_internal} internal) "
        f"in {tree_s:.2f} s; {levels.size} distinct core levels, max "
        f"{int(levels.max()) if levels.size else 0}")
    main_cuts = {}
    for c in np.quantile(levels, [0.25, 0.5, 0.9]).astype(int) \
            if levels.size else []:
        t = time.perf_counter()
        labels = dec.cut(int(c))
        main_cuts[int(c)] = canonicalize_labels(labels)
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
    phase3 = {"rounds": dec.rounds, "cuts": main_cuts, "decompose_s": dec_s,
              "tree_parent": tree.parent, "tree_level": tree.level}
    phase3.update({name: getattr(dec, name) for name in (
        "core", "order_round", "peel_value", "uf_parent", "uf_L")})
    rows[1]["launches"] = scatter_counts["segment_sum"]
    rows[1]["path"] = "dense_coreness(fused_kernel=False)"
    del dec, p, core4, order4, parent4, L4, core_t, tree
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
    small_fused = {}
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
        small_fused[method] = (d_gpu, d_cpu)
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

    # -- phase 7: every single-device configuration ------------------------
    row12, lane12 = phase_configs(g, phase3, small_fused, args.seed)
    rows[1].update(row12)
    del small_fused
    phase_t = log_phase(7, phase_t)

    # -- phase 8: LM inference ------------------------------------------------
    rows.append(phase_lm(args.seed))
    phase_t = log_phase(8, phase_t)

    # -- phase 9: the nucleus server -----------------------------------------
    server = phase_server(g, phase3, lane12, args.seed)
    rows[0]["server_launches"] = server["peel_round"]
    rows[1]["server_launches"] = server["segment_sum"]
    del phase3, lane12
    phase_t = log_phase(9, phase_t)

    # -- phase 10: the result lines -----------------------------------------
    for r in rows:
        require(r["launches"] > 0, f"{r['name']} never launched on its path")
    require(rows[1]["kcore_launches"] > 0,
            "segment_sum never launched on the k-core lane")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
