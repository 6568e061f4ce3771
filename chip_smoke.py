"""Smoke run of the PyTorch/CUDA port on one card: ``python3 chip_smoke.py``.

Drives ``repro_torch``'s main path, ``decompose(graph, NucleusConfig())`` at
its defaults ((2,3), exact, dense, fused hierarchy, eager build), on a seeded
graph of about a million vertices, ten million edges and ten million
triangles, then the memory-bounded chunked build on the card: its dense
(2,3) fast path on a 32,768-vertex graph and its sparse seed-chunked path on
the million-vertex graph, then LM inference of minicpm-2b at full width
(random seeded weights): a 32,768-token prefill through the flash-attention
kernel and a decode server, and stablelm-12b's 32,768-token prefill at
full width (the kernel's head dim 160), then the nucleus server (a warm
Session, exact updates, a multi-tenant router and its HTTP surface), the
sharded lane (the sharded build, the peel over a mesh of slabs, its exact
compressed reduction and a sharded pool), MoE and MLA inference of
moonshot-v1-16b-a3b and deepseek-v2-lite-16b at full width, LM training
of minicpm-2b at full width (AdamW steps, checkpoints), the recsys (din)
and GNN (gin-tu, egnn, dimenet, mace) families at their published widths,
then minicpm-2b's training sharded over a (2, 2) named mesh with the
elastic re-mesh restore (the last three run no kernel), the port's
tooling (the planner calibration, the build-budget gate, the dry run),
and last the reference's six examples as the port's entry points and
Erdos-Renyi graphs up to ten million edges.  Every kernel of those paths
is checked against its plain-torch version on the card.
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
     edges at D = 64, 128 and 160, B > 1) and at the prefill shape (the
     twin in query-row slices), each beside a control with the scale 3%
     off that the bar must reject, with its times at the prefill shape and
     at minitron-4b's (1, 24, 8, 4096, 128);
     ``lm_prefill_step`` of minicpm-2b at full width, B = 1, S = 32,768
     (one flash launch per layer); the card's ``forward`` vs the CPU's at
     full width with 2 layers in f32; ``serve_lm`` of the minicpm-2b and
     minitron-4b smoke configs on the card and the CPU (equal greedy
     tokens); ``serve_lm`` of minicpm-2b at full width on the card (decode
     runs the online scan: no flash launch); ``lm_prefill_step`` of
     stablelm-12b at full width, B = 1, S = 32,768 (the D = 160 route:
     flash launches = layers and the next token equal in two runs, layer
     0's attention held to the twin in a third, one run traced), then the
     kernel's, the twin's, SDPA's and the bound's times at
     (1, 32, 8, 4096, 160) and (1, 32, 8, 32768, 160);
  9. the nucleus server: ``Session().decompose`` of the smoke problem
     (counted in its pow2 shape bucket, run by ``decompose``'s engine),
     bit-identical to phase 3 with megakernel launches == rounds, and a
     warm same-bucket call; one seeded delta of 4 inserts and 4 deletes
     through ``Session.update`` at (2,3) and on phase 7's (1,2) artifact,
     each equal to a fresh decompose of the edited graph (core, uf_parent,
     tree, cuts at three levels; uf_L equal to the canonical-chain
     forest the update resolves, its entries apart from the fused peel's L
     counted); the warm pool: 6 graphs of 250,000 + 1,000·i
     vertices round-robin over (2,3) exact, (1,2) exact and (2,3) approx
     through one ``Router`` (3 pools, 3 warm hits, every artifact equal to
     ``decompose``, the megakernel or the k-core lane's segment sum
     launched once a round) with 4 queries per artifact (each nuclei
     answer's labels equal to its cut's); the HTTP
     server's selftest and a restart from its cache directory (every
     decompose warm); ``serve_nucleus`` on the saved smoke artifact;
 10. the sharded lane on the smoke graph: the sharded build over 4 shards
     (digest equal to phase 2's eager build, its stats and seconds beside
     the eager build's); ``decompose`` on the sharded backend over
     ``Mesh(("cuda:0",) * 4)`` (core, rounds, uf_parent, uf_L and cuts at
     three levels equal to phase 3's; segment-sum launches == 4 x rounds
     and no megakernel launch), on ``make_host_mesh()`` (one card: one
     slab and no collective; several: NCCL), with ``compress=True``
     (equal arrays, drain steps printed; a 70,000-leaf star at (1,2) over
     two slabs gives its hub core 1) and at approx (equal to the dense
     approx run); a ``Router`` pool of two POOL_N graphs on the sharded
     backend (one warm hit, a "sharded" bucket of 4 shards, each artifact
     equal to ``decompose``); the segment sum timed at one slab's plan;
 11. MoE and MLA inference of moonshot-v1-16b-a3b and deepseek-v2-lite-16b
     at their published widths (random seeded weights), one model on the
     card at a time: ``lm_prefill_step`` at B = 1, S = 32,768 (flash
     launches = layers, the next token equal in two runs, the capacity
     drops counted over the layers), ``serve_lm`` at full width (no flash
     launch), ``forward`` card == CPU at full width with 2 layers in f32
     with equal top-k expert choices at every token and layer, and the
     smoke configs' ``serve_lm`` on card and CPU (equal greedy tokens);
     flash attention's, SDPA's and the bound's times at their prefill
     shape (1, 16, 32768, 128);
 12. LM training of minicpm-2b (``phase_train``): at full width in bf16
     with remat, B = 1 and train_4k's S = 4,096, four ``lm_train_step``s
     and two ``lm_train_step_microbatched`` of 2 x 1 timed (finite losses,
     every leaf updated, no flash launch: training attends through the
     online scan), one step traced, and the trained weights' prefill (one
     flash launch a layer); card == CPU at 2 layers in f32 (loss, every
     gradient leaf, the params after a step); ``train_lm`` of the 2-layer
     cut in bf16 saving at step 2 and a run resumed from it (bit for bit,
     the reference's checkpoint keys, losses equal to an uninterrupted
     run's);
 13. the recsys and GNN families at their published widths, no kernel
     launched (none of the four is on their path): din (``phase_din``)
     trains through ``train_din`` at train_batch's 65,536 rows (each step
     timed, every leaf changed), serves serve_p99's 512 and serve_bulk's
     262,144 rows through ``serve_din``, scores retrieval_cand's 1,000,448
     padded candidates in chunks (equal to ``forward``), and equals the
     CPU on a 512-row batch; gin-tu, egnn, dimenet and mace
     (``phase_gnn``) take two ``gnn_train_step``s on each of the four
     GNN cells (molecule, full_graph_sm, minibatch_lg from
     ``GraphMinibatchStream`` over an uncut reddit-sized base graph,
     ogb_products uncut where a probe reckons it fits, else on the
     largest cut that does), with finite losses, no weight decay, and
     a zero gradient exactly on the leaves the loss cannot reach
     (``gnn_unreached``), every other leaf changed; the second step is
     timed; and equal the CPU on the molecule cell;
 14. sharded LM training of minicpm-2b (``phase_sharded_train``): at full
     width in bf16 with remat on a ("data", "model") = (2, 2) mesh over
     the card's slots, parameters and AdamW moments placed by the
     reference's ``lm_param_rules`` (each slot's bytes equal to the specs'
     share), three ``lm_train_step_sharded`` at B = 2, S = 4,096 timed
     (finite losses, every leaf's slot-0 shard changed); the same step at
     2 layers in f32 against the one-device ``lm_train_step`` (loss 1e-4,
     params 5e-4 outside Adam's eps regime) and bit for bit against
     ``lm_train_step_microbatched``, replicated slices bit-identical across
     slots; ``train_lm`` of the 2-layer cut in bf16 on (2, 2) saving at
     step 2, the checkpoint restored with ``sharding_tree`` onto (4, 1),
     (1, 4) and (1, 1) bit for bit and a run resumed on (1, 1) equal to an
     uninterrupted one; ``setup_platform``'s record.  No kernel launched;
 15. the tooling (``phase_tooling``): ``calibrate_planner --quick`` on
     the card into a temporary profile, which ``resolve_plan`` then
     reads, the megakernel launched exactly on the rounds its races ran,
     and the committed ``cuda`` entry the one the default path loads;
     ``check_build_budget`` on the card (both digests equal the ba4k
     fingerprint, the chunked build inside its budget); the dry run of
     minicpm-2b's train_4k on a device-less (2, 2) mesh, its slot bytes
     equal to phase 14's and its FLOPs per token within 5 % of 6ND +
     attention;
 16. the reference's examples as the port's entry points and the
     Erdos-Renyi graphs (``phase_examples``): the six
     ``repro_torch.examples`` through their ``main`` at the reference's
     default arguments (quickstart's and approx_vs_exact's cores and
     rounds, graph_pipeline's curated edges equal to the CPU's,
     elastic_restart's drift 0.0), each one's seconds and launches
     logged; er2k at (1,2), (2,3), (3,4) card == CPU; the 10^7-edge
     ``erdos_renyi_sparse`` graph at (2,3) (megakernel launches ==
     rounds) and (1,2) (segment-sum launches == rounds);
 17. a JSON line of per-kernel numbers, the card's name and power limit,
     and the result line.

It needs a CUDA card and nvcc; it imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

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
UPDATE_OPS = 4           # phase 9 (b): inserts and deletes of one delta
POOL_N = 250_000         # phase 9 (c): the warm pool's graphs have
POOL_STEP = 1_000        # POOL_N + POOL_STEP·i vertices
POOL_GRAPHS = 6          # ... round-robin over POOL_CONFIGS: 2 per pool
POOL_QUERIES = 4         # ... cut/nuclei queries per artifact
SERVE_QUERIES = 16       # phase 9 (e): queries of the saved artifact
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
    # the wgmma kernel's edges: blocks of 192 (D = 64) or 128 (D = 128,
    # 160) query rows, tiles of 128 keys, B > 1 with GQA
    (1, 4, 4, 127, 127, 64, True, torch.bfloat16),
    (1, 4, 4, 129, 129, 64, True, torch.bfloat16),
    (1, 4, 2, 255, 255, 128, True, torch.bfloat16),
    (1, 4, 4, 257, 257, 64, False, torch.bfloat16),
    (3, 8, 2, 257, 257, 64, True, torch.bfloat16),
    (2, 6, 3, 255, 255, 128, False, torch.bfloat16),
    (1, 24, 8, 2048, 2048, 128, True, torch.bfloat16),
    (1, 4, 4, 127, 127, 160, True, torch.bfloat16),
    (1, 4, 2, 129, 129, 160, True, torch.bfloat16),
    (1, 2, 2, 129, 257, 160, True, torch.bfloat16),
    (1, 4, 4, 257, 255, 160, False, torch.bfloat16),
    (3, 8, 2, 257, 257, 160, True, torch.bfloat16),
    (2, 6, 3, 255, 255, 160, False, torch.bfloat16),
)
# minitron-4b's attention (GQA, D = 128), timed beside the prefill shape
FLASH_D128 = (1, 24, 8, 4096, 128)
# phase 8's second model: stablelm-12b (GQA, D = 160) prefilled at full
# width, its attention timed at S = 4,096 and at the prefill's S
D160_ARCH = "stablelm-12b"
FLASH_D160 = ((1, 32, 8, 4096, 160), (1, 32, 8, PREFILL_S, 160))
# phase 11: the MoE/MLA archs, one on the card at a time, and the flash
# kernel at their prefill shape
MOE_ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v2-lite-16b")
FLASH_MOE = (1, 16, 16, PREFILL_S, 128)
# flash attention's bar: the largest ||got - want|| / ||want|| over output
# rows (a row is one query's D values).  bf16: the output's rounding is
# relative (half an ulp, 2^-9), so a bar relative to each row holds at every
# row, where an absolute one would be near the size of the late rows'
# values (about sqrt(e / (i + 1)) for randn inputs).  f32: sums in another
# order than the twin's, far under the ~1e-3 of a bf16 or TF32 product.
FLASH_ROW_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
CONTROL_SCALE = 1.03     # the control: q scaled, i.e. the softmax scale off
# phase 12: LM training of minicpm-2b (train_4k's sequence of 4,096 tokens)
TRAIN_B = 1              # train_4k's global batch of 256, cut to one card
TRAIN_STEPS = 4          # lm_train_step calls, then MICRO_STEPS calls of
MICRO_STEPS = 2          # lm_train_step_microbatched over 2 x TRAIN_B rows
TRAIN_LR = 2e-3          # the least round lr whose first AdamW step
                         # (lr·(1 ± 0.1)) moves a bf16 1.0 (> 2^-9)
TRAIN_CPU_B, TRAIN_CPU_S = 2, 256  # card vs CPU: 2 layers, f32
TRAIN_CPU_TOL = 1e-3     # ||card - cpu|| / ||cpu|| per leaf, f32 sums
RESUME_STEPS = 4         # (c): bf16, 2 layers, resumed from step 2
# (c)'s arrays.npz members: the reference's key paths of (params, opt_state)
PARAM_KEYS = ("['embed']", "['layers']/['ln1']", "['layers']/['ln2']",
              "['layers']/['w1']", "['layers']/['w2']", "['layers']/['w3']",
              "['layers']/['wk']", "['layers']/['wo']", "['layers']/['wq']",
              "['layers']/['wv']", "['ln_f']", "['unembed']")
CKPT_MEMBERS = ([f"[0]/{k}.npy" for k in PARAM_KEYS] + ["[1]/.step.npy"] +
                [f"[1]/.{m}/{k}.npy" for m in ("mu", "nu")
                 for k in PARAM_KEYS])


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
    events = device_events(prof)
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
    """The plain twin's causal output for Sq == Sk, query rows [i0, i1) at
    a time against keys [0, i1): ``flash_attention_plain``'s KV heads
    repeated for their query heads, ``ref.attention_ref``'s f32 scores,
    -inf mask by index, softmax and cast, with rows * i1 scores per slice
    instead of S * S (155 GB in f32 at minicpm-2b's 36 heads and
    S = 32,768)."""
    S, D = q.shape[2], q.shape[3]
    G = q.shape[1] // k.shape[1]
    if G > 1:
        k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
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


def check_flash(got, want, ctl, dt, what: str, tag: str = "lm"):
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
    log(f"[{tag}] flash_attention {what}: row rel err {r:.3g}, max abs err "
        f"{e:.3g} (bar: row rel {tol}); control scale x{CONTROL_SCALE}: "
        f"row rel err {c:.3g}")
    return e, r, c


def flash_row(gen, B, H, Hkv, S, D, iters: int, tag: str,
              hold_sdpa: bool = False):
    """flash_attention at (B, H, Hkv, S, D) bf16 causal, on inputs laid out
    as the models hand them over: held to its plain twin (in query-row
    slices) with the scale control, then the kernel's, SDPA's and the
    twin's ms on the same inputs beside the bound: 4·D·H·S(S+1)/2 flops at
    the bf16 rate, or q, k, v and the output once at the memory rate,
    whichever is larger.  hold_sdpa: SDPA's output must lie within the bar
    of the kernel's too."""
    from repro_torch.kernels.flash_attention import flash_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = H != Hkv
    shape = f"({B}, {H}, {Hkv}, {S}, {D}) bf16 causal"
    q, k, v = flash_inputs(gen, B, H, Hkv, S, S, D, torch.bfloat16)
    got = flash_attention(q, k, v, True)
    ctl = flash_attention(q * CONTROL_SCALE, k, v, True)
    want = plain_causal_rows(q, k, v)
    e, r, _ = check_flash(got, want, ctl, torch.bfloat16,
                          f"{shape} (twin in {PLAIN_ROWS}-row slices)", tag)
    del ctl
    lib = sdpa(q, k, v, is_causal=True, enable_gqa=gqa)
    lib_err, lib_want = row_rel_err(got, lib), row_rel_err(lib, want)
    # two bf16 outputs of one function, each within ~2^-9 of the f32 value
    require(not hold_sdpa or lib_err <= FLASH_ROW_TOL[torch.bfloat16],
            f"flash_attention differs from SDPA at {shape}: row rel err "
            f"{lib_err}")
    del got, want, lib
    torch.cuda.empty_cache()
    row = {"shape": shape, "max_abs_err": e, "max_row_rel_err": r,
           "ms": cuda_ms(lambda: flash_attention(q, k, v, True), iters),
           "library_ms": cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                              enable_gqa=gqa), iters),
           "plain_ms": cuda_ms(lambda: plain_causal_rows(q, k, v), 2, 1)}
    del q, k, v
    torch.cuda.empty_cache()
    ops_ms = 1e3 * 4.0 * D * H * B * S * (S + 1) / 2 / BF16_FLOPS_PER_S
    bytes_ms = 1e3 * 2.0 * B * S * D * 2 * (H + Hkv) / HBM_BYTES_PER_S
    row["bound_ms"] = max(ops_ms, bytes_ms)
    row["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    log(f"[{tag}] flash_attention {shape}: kernel {row['ms']:.4f} ms, "
        f"plain (sliced) {row['plain_ms']:.4f} ms, SDPA "
        f"{row['library_ms']:.4f} ms (row rel err kernel vs SDPA "
        f"{lib_err:.3g}, SDPA vs plain {lib_want:.3g}), bound "
        f"{row['bound_ms']:.4f} ms (operations {ops_ms:.4f}, bytes "
        f"{bytes_ms:.4f})")
    return row


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def profile_decode(params, cfg, steps: int = 8, tag: str = "lm"):
    """Where a full-width decode step's time goes: `steps` warm steps of
    4 slots timed on the host clock (each ending in a sync), then one step
    traced: its device time, kernel launches and the busy share."""
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

    events = device_events(prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    wall_ms = 1e3 * float(np.median(walls[1:]))
    log(f"[{tag}] decode step, full width, 4 slots: wall {wall_ms:.3f} ms "
        f"(median of {steps - 1} warm steps; first {1e3 * walls[0]:.1f} "
        f"ms), traced device time {busy_ms:.3f} ms in {n_kernels} kernels"
        f" = {100 * busy_ms / wall_ms:.1f}% busy")
    top_kernels(events, busy_ms, tag, "decode step")
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "kernels": n_kernels}


class DeviceEvent(NamedTuple):
    key: str          # kernel, copy or set name
    count: int
    device_us: float  # summed device time


def dev_us(e: DeviceEvent) -> float:
    return e.device_us


def device_events(prof) -> list:
    """The trace's device events (kernels, copies, sets) with device time,
    summed by name.  Read from the kineto results: the profiler's Python
    parse of every event (``key_averages``) took ~100 s of a decompose's
    trace."""
    from torch.autograd import DeviceType
    total = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            count, ns = total.get(e.name(), (0, 0))
            total[e.name()] = (count + 1, ns + e.duration_ns())
    return [DeviceEvent(k, c, ns / 1e3) for k, (c, ns) in total.items()]


def top_kernels(events, total_ms: float, tag: str, what: str,
                n: int = 6) -> None:
    """Logs the n kernels of largest summed device time, with shares."""
    for e in sorted(events, key=dev_us, reverse=True)[:n]:
        ms = dev_us(e) / 1e3
        log(f"[{tag}]   {what}: {ms:9.3f} ms {100 * ms / total_ms:5.1f}% "
            f"x{e.count} {e.key[:90]}")


def profile_prefill(params, cfg, toks, tag: str):
    """One traced ``lm_prefill_step``: its device time beside its wall time,
    and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import lm_prefill_step
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lm_prefill_step(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t)
    events = device_events(prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    flash_ms = sum(dev_us(e) for e in events if "flash" in e.key) / 1e3
    log(f"[{tag}] prefill traced: device time {busy_ms:.1f} ms in "
        f"{sum(e.count for e in events)} kernels over a {wall_ms:.1f} ms "
        f"wall (traced); flash attention {flash_ms:.1f} ms "
        f"({100 * flash_ms / busy_ms:.1f}%)")
    top_kernels(events, busy_ms, tag, "prefill")
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "flash_ms": flash_ms}


def two_prefills(params, cfg, toks, arch: str):
    """Two ``lm_prefill_step`` runs of one model, each synced and timed with
    its flash launches counted (= layers), the next token equal in both;
    returns (seconds of each run, next token, launches, peak GB)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import lm_prefill_step
    torch.cuda.reset_peak_memory_stats()
    runs, nxts, launches = [], [], []
    for _ in range(2):
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        nxts.append(lm_prefill_step(params, {"tokens": toks}, cfg))
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t)
        launches.append(launch_counts["flash_attention"])
        require(launches[-1] == cfg.n_layers,
                f"{arch} prefill launched flash attention "
                f"{launches[-1]} times, not n_layers={cfg.n_layers}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(torch.equal(nxts[0], nxts[1]),
            f"{arch}: the prefill's next token differs between two runs")
    return runs, nxts[0], launches, peak_gb


def prefill_d160(seed: int, gen):
    """stablelm-12b's ``lm_prefill_step`` at full width, bf16, B = 1,
    S = 32,768 (the D = 160 route of the flash kernel): two timed runs
    (flash launches = layers, the next token equal), a third whose layer 0
    attention is held to the twin on the path's own q, k, v, one traced;
    the model is freed before returning."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import lm_prefill_step
    from repro_torch.models import transformer as T
    torch.cuda.empty_cache()
    cfg = get_arch(D160_ARCH).make_config()
    t = time.perf_counter()
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    toks = torch.randint(0, cfg.vocab, (1, PREFILL_S), generator=gen,
                         device="cuda")
    runs, nxt, launches, peak_gb = two_prefills(params, cfg, toks, D160_ARCH)
    with FirstAttentionCheck(T.ops, "lm") as fa:
        chk = lm_prefill_step(params, {"tokens": toks}, cfg)
    require(torch.equal(chk, nxt), f"{D160_ARCH}: the checked prefill's "
            f"next token differs")
    row = {"params": cfg.param_count(), "init_s": init_s, "prefill_s": runs,
           "peak_gb": peak_gb, "next_token": int(nxt),
           "flash_launches": launches, "layer0_max_abs_err": fa.err[0],
           "layer0_max_row_rel_err": fa.err[1]}
    log(f"[lm] {D160_ARCH} prefill B=1 S={PREFILL_S}: {row['params']} "
        f"params (bf16, init {init_s:.2f} s), prefill {runs[0]:.3f} s "
        f"(again {runs[1]:.3f} s), peak {peak_gb:.2f} GB, next token "
        f"{row['next_token']} in both runs, flash launches {launches} "
        f"(layers {cfg.n_layers})")
    row["prefill_profile"] = profile_prefill(params, cfg, toks, "lm")
    del params, toks, chk
    torch.cuda.empty_cache()
    return row


def phase_lm(seed: int):
    """Phase 8: flash attention vs its plain twin and its times, then the
    LM path of minicpm-2b: full-width prefill, card vs CPU, serving; then
    stablelm-12b's full-width prefill (D = 160) and the kernel's times at
    its head shape."""
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
    pre = flash_row(gen, 1, 36, 36, PREFILL_S, 64, iters=10, tag="lm",
                    hold_sdpa=True)
    err, row_err = max(err, pre["max_abs_err"]), max(row_err,
                                                     pre["max_row_rel_err"])

    # minitron-4b's attention (GQA, D = 128: the two-warpgroup variant)
    d128 = flash_row(gen, *FLASH_D128, iters=20, tag="lm")

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

    # stablelm-12b: the D = 160 route on a full-width prefill, then the
    # kernel at its head shape at S = 4,096 and at the prefill's S
    d160_path = prefill_d160(seed, gen)
    d160 = [flash_row(gen, *shape, iters=20 if shape[3] < PREFILL_S else 5,
                      tag="lm") for shape in FLASH_D160]
    err = max([err, d160_path["layer0_max_abs_err"]] +
              [x["max_abs_err"] for x in d160])
    row_err = max([row_err, d160_path["layer0_max_row_rel_err"]] +
                  [x["max_row_rel_err"] for x in d160])
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:72",
            "launches": prefill_counts["flash_attention"],
            "max_abs_err": err, "max_row_rel_err": row_err,
            "tolerance": "row rel L2 1e-2 bf16, 1e-4 f32",
            "ms": pre["ms"], "plain_ms": pre["plain_ms"],
            "plain_call": f"attention_ref in {PLAIN_ROWS}-query-row slices",
            "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
            "library_ms": pre["library_ms"],
            "library_call": "scaled_dot_product_attention(is_causal=True)",
            "shape": pre["shape"],
            "routes": "bf16 D=64: wgmma/TMA, 3 consumer warpgroups; bf16 "
                      "D=128: wgmma/TMA, 2; bf16 D=160: wgmma/TMA, 2, "
                      "32-dim boxes under the 64-byte swizzle; f32: the "
                      "first design (FMA)",
            "d128": d128, "d160": d160[0], "d160_long": d160[1],
            "d160_path": {k: d160_path[k] for k in (
                "prefill_s", "peak_gb", "flash_launches")} | {
                "flash_ms": d160_path["prefill_profile"]["flash_ms"],
                "device_ms": d160_path["prefill_profile"]["device_ms"],
                "path": f"lm_prefill_step({D160_ARCH}, B=1, "
                        f"S={PREFILL_S})"},
            "path": f"lm_prefill_step({LM_ARCH}, B=1, S={PREFILL_S})"}


class MoERecorder:
    """Wraps ``transformer.moe_block`` while open: per call, the routing
    the call takes (the first K of one stable descending sort of the
    router probabilities, as ``moe_route`` takes them), its capacity drops
    (``moe_slots``) and the gap between the K-th and (K+1)-th probability
    of each token, kept on the host.  The wrapped block computes as
    before."""

    def __init__(self, T):
        self.T, self.choices, self.gaps, self.dropped = T, [], [], []

    def __enter__(self):
        T, block = self.T, self.T.moe_block

        def recorded(x, params, cfg):
            K = cfg.top_k
            probs = torch.softmax(x.float() @ params["router"].float(), -1)
            top, order = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
            _, keep = T.moe_slots(order[:, :K], cfg.n_experts,
                                  T.moe_capacity(x.shape[0], cfg))
            self.choices.append(order[:, :K].cpu())
            self.gaps.append((top[:, K - 1] - top[:, K]).cpu())
            self.dropped.append(int((~keep).sum()))
            return block(x, params, cfg)
        self.block, T.moe_block = block, recorded
        return self

    def __exit__(self, *exc):
        self.T.moe_block = self.block


class FirstAttentionCheck:
    """Wraps ``kernels.ops.attention`` while open: its first call's output,
    as the model hands it q, k and v (MLA's concatenated rope and nope
    parts included), is held to the plain twin in query-row slices, with
    the scale control; later calls pass through."""

    def __init__(self, ops, tag: str):
        self.ops, self.tag, self.err = ops, tag, None

    def __enter__(self):
        attention = self.ops.attention

        def checked(q, k, v, causal=True, **kw):
            out = attention(q, k, v, causal=causal, **kw)
            if self.err is None:
                ctl = attention(q * CONTROL_SCALE, k, v, causal=causal, **kw)
                want = plain_causal_rows(q, k, v)
                self.err = check_flash(
                    out, want, ctl, q.dtype, f"{tuple(q.shape)} layer 0 of "
                    f"the prefill (q strides {q.stride()}, k strides "
                    f"{k.stride()})", self.tag)[:2]
                del ctl, want
            return out
        self.attention, self.ops.attention = attention, checked
        return self

    def __exit__(self, *exc):
        self.ops.attention = self.attention


def phase_moe(seed: int):
    """Phase 11: MoE and MLA inference of moonshot-v1-16b-a3b and
    deepseek-v2-lite-16b, one model on the card at a time: (a)
    ``lm_prefill_step`` at full width, B = 1, S = 32,768 (flash launches
    = layers, the next token equal in two runs, capacity drops counted in
    a third, recorded run); (b) ``serve_lm`` at full width (no flash
    launch); (c) ``forward`` card == CPU at full width with 2 layers in
    f32 with equal expert choices; (d) the smoke configs' ``serve_lm`` on
    card and CPU.  Then flash attention at these archs' prefill shape,
    beside SDPA and the bound."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.steps import lm_prefill_step
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for arch in MOE_ARCHS:
        torch.cuda.empty_cache()
        cfg = get_arch(arch).make_config()
        t = time.perf_counter()
        params = T.init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(seed), device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        toks = torch.randint(0, cfg.vocab, (1, PREFILL_S), generator=gen,
                             device="cuda")
        runs, nxt, launches, peak_gb = two_prefills(params, cfg, toks, arch)
        # a third, uncounted run: the capacity drops, and the first layer's
        # attention held to the twin on the path's own q, k, v
        with MoERecorder(T) as rec, FirstAttentionCheck(T.ops, "moe") as fa:
            rec_nxt = lm_prefill_step(params, {"tokens": toks}, cfg)
        require(torch.equal(rec_nxt, nxt) and len(rec.dropped) ==
                cfg.n_layers, f"{arch}: the recorded prefill differs")
        cap = T.moe_capacity(PREFILL_S, cfg.moe)
        row = {"params": cfg.param_count(), "init_s": init_s,
               "prefill_s": runs, "peak_gb": peak_gb,
               "next_token": int(nxt),
               "flash_launches": launches, "cap": cap,
               "layer0_max_abs_err": fa.err[0],
               "layer0_max_row_rel_err": fa.err[1],
               "dropped": sum(rec.dropped),
               "assignments": cfg.n_layers * PREFILL_S * cfg.moe.top_k}
        log(f"[moe] {arch} prefill B=1 S={PREFILL_S}: {row['params']} "
            f"params (bf16, init {init_s:.2f} s), prefill {runs[0]:.3f} s "
            f"(again {runs[1]:.3f} s), peak {peak_gb:.2f} GB, next token "
            f"{row['next_token']} in both runs, flash launches {launches} "
            f"(layers {cfg.n_layers}); capacity {cap} slots an expert, "
            f"{row['dropped']} of {row['assignments']} assignments dropped "
            f"over the layers")
        row["prefill_profile"] = profile_prefill(params, cfg, toks, "moe")
        del rec, toks

        # (b) full-width serving: decode runs the online scan
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        served = serve_lm(arch, n_requests=8, batch_slots=4, smoke=False,
                          params=params, device="cuda")
        serve_s = time.perf_counter() - t
        require(launch_counts["flash_attention"] == 0,
                f"{arch}: flash attention launched during decode")
        require(sorted(served) == list(range(8)) and all(
            x.shape == (24,) and ((x >= 0) & (x < cfg.vocab)).all()
            for x in served.values()),
            f"{arch}: full-width serving output malformed")
        row["serve_s"] = serve_s
        row["serve_tok_s"] = 8 * 24 / serve_s
        log(f"[moe] serve_lm({arch!r}, 8 requests x 24 tokens, 4 slots, "
            f"full width): {serve_s:.2f} s = {row['serve_tok_s']:.1f} tok/s"
            f", 0 flash launches")
        row["decode_profile"] = profile_decode(params, cfg, tag="moe")
        del params
        torch.cuda.empty_cache()

        # (c) card vs CPU: full width, 2 layers, f32, TF32 off
        cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
        t = time.perf_counter()
        cpu_params = T.init_params(cfg2, generator=torch.Generator()
                                   .manual_seed(seed), device="cpu")
        toks = torch.randint(0, cfg2.vocab, (1, CPU_CHECK_S),
                             generator=torch.Generator().manual_seed(seed))
        with MoERecorder(T) as want_rec:
            want = T.forward(cpu_params, toks, cfg2)
        cpu_s = time.perf_counter() - t
        reset_launch_counts()
        with MoERecorder(T) as got_rec:
            got = T.forward(to_device(cpu_params, "cuda"), toks.cuda(),
                            cfg2).cpu()
        require(launch_counts["flash_attention"] == cfg2.n_layers,
                f"{arch}: the card's forward did not run the kernel once "
                f"per layer")
        for layer, (a, b, gap) in enumerate(zip(
                got_rec.choices, want_rec.choices, want_rec.gaps)):
            diff = (a != b).any(dim=1)
            if bool(diff.any()):
                log(f"[moe] {arch} layer {layer}: expert choices differ at "
                    f"tokens {diff.nonzero().flatten().tolist()}, K-th vs "
                    f"(K+1)-th probability gap there "
                    f"{gap[diff].tolist()}")
            require(not bool(diff.any()),
                    f"{arch}: top-k expert choices differ between card and "
                    f"CPU at layer {layer}")
        e = float((got - want).abs().max())
        require(torch.allclose(got, want, rtol=1e-3, atol=1e-3),
                f"{arch}: card forward differs from CPU forward: max abs "
                f"err {e}")
        min_gap = min(float(g.min()) for g in want_rec.gaps)
        row.update(cpu_check_max_abs_err=e, cpu_check_min_gap=min_gap)
        log(f"[moe] forward {arch} full width, 2 layers, f32, S="
            f"{CPU_CHECK_S}: card == CPU (max abs err {e:.3g}, rtol/atol "
            f"1e-3), expert choices equal at every token and layer "
            f"(smallest K-th/(K+1)-th probability gap {min_gap:.3g}); CPU "
            f"init + forward {cpu_s:.2f} s")
        del cpu_params, got, want, want_rec, got_rec

        # (d) the smoke config's serving, card vs CPU, same weights
        scfg = get_arch(arch).make_smoke_config()
        sp = T.init_params(scfg, generator=torch.Generator().manual_seed(
            seed), device="cpu")
        reset_launch_counts()
        on_card = serve_lm(arch, params=to_device(sp, "cuda"),
                           device="cuda", quiet=True)
        on_cpu = serve_lm(arch, params=sp, device="cpu", quiet=True)
        require(launch_counts["flash_attention"] == 0,
                f"{arch}: flash attention launched during smoke decode")
        require(sorted(on_card) == sorted(on_cpu) and all(
            np.array_equal(on_card[r], on_cpu[r]) for r in on_cpu),
            f"serve_lm({arch!r}) smoke: card tokens differ from the CPU's")
        log(f"[moe] serve_lm({arch!r}) smoke: {len(on_cpu)} requests, equal "
            f"greedy tokens on card and CPU")
        out[arch] = row
        torch.cuda.empty_cache()

    # the flash kernel at these archs' prefill shape (head_dim 2048/16 =
    # 128, Hkv = H = 16)
    timing = {"moe_mla_prefill": flash_row(gen, *FLASH_MOE, iters=10,
                                           tag="moe", hold_sdpa=True)}
    return out, timing


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (a float -0.0 is not 0.0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (x.view(ints[x.element_size()]) for x in (a, b))
    return torch.equal(a, b)


def rel_norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.double()
    return float((got.double() - want).norm() / want.norm().clamp(
        min=1e-30))


def phase_train(seed: int):
    """Phase 12: LM training of minicpm-2b.  (a) At its published width
    (bf16, remat) on ``TokenStream`` batches of train_4k's 4,096 tokens:
    TRAIN_STEPS ``lm_train_step``s at B = 1, then MICRO_STEPS
    ``lm_train_step_microbatched`` of 2 x 1, each timed (synced), with
    finite loss and norm, every parameter leaf changed by the first step
    and no flash launch; one more step traced; then ``lm_prefill_step``
    of the trained weights (flash launches = layers).  (b) The training
    route card == CPU at full width with 2 layers in f32: loss, every
    gradient leaf and the params after one ``lm_train_step``.  (c) The
    same 2-layer cut in bf16 through ``train_lm``: a run saves its state
    at step 2 (``arrays.npz`` keyed as the reference keys it), a second
    run resumes from it bit for bit and its losses equal an uninterrupted
    run's (rtol 1e-4)."""
    import shutil
    import tempfile
    import zipfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import base, get_arch
    from repro_torch.data import TokenStream, TokenStreamConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import (lm_prefill_step, lm_train_step,
                                          lm_train_step_microbatched,
                                          value_and_grad)
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten_with_paths, leaves

    spec = get_arch(LM_ARCH)
    cfg = spec.make_config()
    S = spec.shape("train_4k").dims["seq_len"]
    require(cfg.remat and cfg.dtype == torch.bfloat16,
            "the full config trains in bf16 with remat")
    n_params = cfg.param_count()
    total = TRAIN_STEPS + MICRO_STEPS
    opt = adamw.AdamWConfig(lr=TRAIN_LR, schedule="wsd", warmup_steps=1,
                            total_steps=total)

    def on_card(b):
        return {k: torch.from_numpy(v).cuda() for k, v in b.items()}

    # -- (a) full width ---------------------------------------------------
    t = time.perf_counter()
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    opt_state = adamw.init_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    streams = [TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=S,
                                             global_batch=n * TRAIN_B,
                                             seed=seed)) for n in (1, 2)]
    log(f"[train] {LM_ARCH} full width: {n_params} params, bf16, remat; "
        f"params + moments {init_s:.2f} s; train_4k's S = {S}, its global "
        f"batch of 256 cut to {TRAIN_B} (one card); AdamW lr {TRAIN_LR} "
        f"(WSD, warmup cut to 1 step; step 0 includes the first call's "
        f"set-up)")
    first = [p.clone() for p in leaves(params)]
    steps = []
    reset_launch_counts()
    for i in range(total):
        micro = i >= TRAIN_STEPS
        b = on_card(streams[micro].batch(i))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        if micro:
            params, opt_state, m = lm_train_step_microbatched(
                params, opt_state, b, cfg, opt, 2)
        else:
            params, opt_state, m = lm_train_step(params, opt_state, b, cfg,
                                                 opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        m = {k: float(v) for k, v in m.items()}
        ntok = b["tokens"].numel()
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps.append({"step": i, "micro": micro, "s": wall,
                      "tok_s": ntok / wall, "peak_gb": peak, **m})
        log(f"[train] step {i} ({'microbatched 2 x 1' if micro else 'B=1'}"
            f"): {wall:.3f} s, {ntok / wall:.0f} tok/s "
            f"({6 * n_params * ntok / wall / 1e12:.1f} TFLOP/s by 6ND), "
            f"loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, lr "
            f"{m['lr']:.3g}, peak {peak:.2f} GB")
        require(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
                f"step {i}: loss or grad_norm not finite")
        if i == 0:
            same = [k for (k, p), p0 in zip(flatten_with_paths(params),
                                            first) if torch.equal(p, p0)]
            require(not same, f"leaves unchanged by the first step: {same}")
            del first
            torch.cuda.empty_cache()
    train_counts = dict(launch_counts)
    require(train_counts["flash_attention"] == 0,
            f"flash attention launched {train_counts['flash_attention']} "
            f"times during training")

    b = on_card(streams[0].batch(total))
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, opt_state, m = lm_train_step(params, opt_state, b, cfg, opt)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t)
    events = device_events(prof)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    log(f"[train] traced lm_train_step: device time {busy_ms:.1f} ms in "
        f"{sum(e.count for e in events)} kernels over a {wall_ms:.1f} ms "
        f"wall (traced): {100 * (1 - busy_ms / wall_ms):.1f}% idle")
    top_kernels(events, busy_ms, "train", "train step", n=8)
    del opt_state
    torch.cuda.empty_cache()

    reset_launch_counts()
    nxt = lm_prefill_step(params, {"tokens": b["tokens"]}, cfg)
    torch.cuda.synchronize()
    prefill_launches = launch_counts["flash_attention"]
    require(prefill_launches == cfg.n_layers,
            f"the trained model's prefill launched flash attention "
            f"{prefill_launches} times, not {cfg.n_layers}")
    require(0 <= int(nxt) < cfg.vocab, "prefill token out of range")
    log(f"[train] lm_prefill_step of the trained weights, S={S}: next "
        f"token {int(nxt)}, flash launches {prefill_launches}; "
        f"launches during the {total} steps: {train_counts}")
    del params, b
    torch.cuda.empty_cache()

    # -- (b) card vs CPU: full width, 2 layers, f32 -------------------------
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    cpu_params = T.init_params(cfg2, generator=torch.Generator().manual_seed(
        seed), device="cpu")
    toks = torch.randint(0, cfg2.vocab, (TRAIN_CPU_B, TRAIN_CPU_S + 1),
                         generator=torch.Generator().manual_seed(seed))
    cb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    gb = {k: v.cuda() for k, v in cb.items()}
    t = time.perf_counter()
    cpu_loss, cpu_grads = value_and_grad(T.loss_fn, cpu_params,
                                         cb["tokens"], cb["labels"], cfg2)
    cpu_s = time.perf_counter() - t
    card_loss, card_grads = value_and_grad(
        T.loss_fn, to_device(cpu_params, "cuda"), gb["tokens"],
        gb["labels"], cfg2)
    loss_err = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    names = [k for k, _ in flatten_with_paths(cpu_params)]
    grad_err = {k: rel_norm_err(g.cpu(), c) for k, g, c in
                zip(names, card_grads, cpu_grads)}
    worst = max(grad_err, key=grad_err.get)
    require(loss_err <= TRAIN_CPU_TOL and grad_err[worst] <= TRAIN_CPU_TOL,
            f"training route card != CPU: loss rel err {loss_err:.3g}, "
            f"gradients {grad_err}")
    del card_grads, cpu_grads
    stepped = {}
    for dev in ("cuda", "cpu"):   # the CPU step updates cpu_params in place
        p = to_device(cpu_params, dev)
        stepped[dev], _, _ = lm_train_step(
            p, adamw.init_state(p), cb if dev == "cpu" else gb, cfg2, opt)
    param_err = {k: rel_norm_err(a.cpu(), c) for k, a, c in zip(
        names, leaves(stepped["cuda"]), leaves(stepped["cpu"]))}
    worst_p = max(param_err, key=param_err.get)
    require(param_err[worst_p] <= TRAIN_CPU_TOL,
            f"params after one lm_train_step: card != CPU {param_err}")
    log(f"[train] card == CPU, full width, 2 layers, f32, B={TRAIN_CPU_B} "
        f"S={TRAIN_CPU_S}: loss rel err {loss_err:.3g}; worst gradient "
        f"leaf {worst} {grad_err[worst]:.3g}; params after one "
        f"lm_train_step: worst {worst_p} {param_err[worst_p]:.3g} "
        f"(||card - cpu|| / ||cpu||, bar {TRAIN_CPU_TOL}; CPU "
        f"value_and_grad {cpu_s:.2f} s)")
    del cpu_params, stepped
    torch.cuda.empty_cache()

    # -- (c) resume: the 2-layer cut in bf16 through train_lm --------------
    cut_id = f"{LM_ARCH}-2-layers"
    base.register(dataclasses.replace(
        spec, arch_id=cut_id,
        make_config=lambda: dataclasses.replace(cfg, n_layers=2)))
    saved, restored = {}, {}
    manager = train_mod.CheckpointManager

    class Recorded(manager):
        """Keeps a card copy of each saved state and compares each
        restored state with it."""

        def save(self, step, state, extra=None, blocking=False):
            saved[step] = SH.gather(state, "cuda")
            super().save(step, state, extra, blocking)

        def restore(self, like, step=None, sharding_tree=None):
            state, at, extra = super().restore(like, step, sharding_tree)
            restored[at] = all(same_bits(a, b) for a, b in
                               zip(leaves(SH.gather(state, "cuda")),
                                   leaves(saved[at])))
            return state, at, extra

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    train_mod.CheckpointManager = Recorded
    try:
        run = dict(smoke=False, quiet=True, device="cuda")
        t = time.perf_counter()
        whole = train_mod.train_lm(cut_id, steps=RESUME_STEPS, **run)
        part = train_mod.train_lm(cut_id, steps=2, ckpt_dir=tmp,
                                  ckpt_every=2, **run)
        save_s = time.perf_counter() - t
        npz = os.path.join(tmp, "step_2", "arrays.npz")
        with zipfile.ZipFile(npz) as z:
            members = z.namelist()
        require(members == CKPT_MEMBERS,
                f"checkpoint members {members} are not the reference's "
                f"{CKPT_MEMBERS}")
        gb_disk = os.path.getsize(npz) / 1e9
        t = time.perf_counter()
        resumed = train_mod.train_lm(cut_id, steps=RESUME_STEPS,
                                     ckpt_dir=tmp, ckpt_every=10 ** 9,
                                     resume=True, **run)
        resume_s = time.perf_counter() - t
    finally:
        train_mod.CheckpointManager = manager
        shutil.rmtree(tmp, ignore_errors=True)
        del base._REGISTRY[cut_id]
    require(resumed.restored_from == 2 and restored == {2: True},
            f"the restored state is not the saved one bit for bit "
            f"(restored from {resumed.restored_from}: {restored})")
    require(np.allclose(part.losses, whole.losses[:2], rtol=1e-4, atol=0),
            "the 2-step run's losses differ from the whole run's")
    require(np.allclose(resumed.losses, whole.losses[2:], rtol=1e-4,
                        atol=0),
            f"resumed losses {resumed.losses} != uninterrupted "
            f"{whole.losses[2:]}")
    log(f"[train] resume, 2 layers, bf16 (train_lm, B=8, S=64): "
        f"{len(members)} npz members keyed as the reference's, "
        f"{gb_disk:.2f} GB at step 2; restored bit for bit; losses "
        f"{resumed.losses} == uninterrupted {whole.losses[2:]} (rtol 1e-4); "
        f"whole + saving run {save_s:.2f} s, resumed run {resume_s:.2f} s")
    return {"steps": steps, "prefill_launches": prefill_launches,
            "train_launches": train_counts["flash_attention"],
            "traced_busy_ms": busy_ms, "traced_wall_ms": wall_ms}


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


SHARDS = 4               # phase 10: build shards and peel slabs
STAR_LEAVES = 70_000     # phase 10 (d): the star of the compress fault


def phase_sharded(g, main, eager_digest: str, eager_build_s: float,
                  seed: int):
    """Phase 10: the sharded lane on the smoke graph.

    (a) ``build_problem(g, 2, 3, build="sharded", shards=SHARDS)``, its
    digest equal to phase 2's eager build; (b) ``decompose`` on the
    sharded backend and build over ``Mesh(("cuda:0",) * SHARDS)``, equal
    to phase 3 (core, rounds, uf_parent, uf_L, cuts at three levels) with
    segment-sum launches == SHARDS x rounds and no megakernel launch; (c)
    the same on ``make_host_mesh()``; (d) ``compress=True`` on (b)'s mesh,
    equal to (b), and the star at (1,2) over two slabs; (e) approx on
    (b)'s mesh == the dense approx run; (f) a Router pool of two POOL_N
    graphs on (b)'s mesh.  Returns the segment sum's sharded launches and
    its time at one slab's plan."""
    from repro_torch import NucleusConfig, decompose
    from repro_torch.core import build_problem, canonicalize_labels
    from repro_torch.core.distributed import _partition
    from repro_torch.core.incidence import problem_digest
    from repro_torch.graph.container import Graph
    from repro_torch.graph.generators import community_power_law
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.segment_sum import (segment_sum,
                                                 segment_sum_plain)
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.serve import Request, Router
    forest = ("core", "uf_parent", "uf_L")

    # (a) the sharded build
    sp, sp_s = timed(lambda: build_problem(g, 2, 3, build="sharded",
                                           shards=SHARDS))
    st = sp.build_stats
    require(problem_digest(sp) == eager_digest,
            "the sharded build differs from phase 2's eager build")
    log(f"[sharded] build_problem(g, 2, 3, build='sharded', shards="
        f"{SHARDS}): digest equal to the eager build; build_s={sp_s:.2f} "
        f"(eager {eager_build_s:.2f}); shards={st['n_shards']} "
        f"chunks_per_shard={st['chunks_per_shard']} chunk_size="
        f"{st['chunk_size']} skew={st['skew']:.4f} exchange_bytes="
        f"{st['exchange_bytes']}")
    del sp
    torch.cuda.empty_cache()

    # (b) the sharded backend and build on SHARDS slabs of one card
    mesh = Mesh(("cuda:0",) * SHARDS)
    cfg = NucleusConfig(backend="sharded", build="sharded",
                        build_shards=SHARDS, mesh=mesh)
    reset_launch_counts()
    dec, dec_s = timed(lambda: decompose(g, cfg))
    counts = dict(launch_counts)
    p = dec.problem

    def equal_to_main(d, what):
        require(d.rounds == main["rounds"], f"{what}: rounds {d.rounds} != "
                f"phase 3's {main['rounds']}")
        same_arrays(d, main, forest, what)

    equal_to_main(dec, "sharded decompose")
    for c, want in main["cuts"].items():
        require(np.array_equal(canonicalize_labels(dec.cut(c)), want),
                f"sharded decompose: cut({c}) differs from phase 3's")
    require(counts["segment_sum"] == SHARDS * dec.rounds and
            counts["peel_round"] == 0,
            f"sharded launches {counts} over {dec.rounds} rounds")
    log(f"[sharded] decompose(g, backend='sharded', build='sharded', mesh="
        f"{mesh}): rounds={dec.rounds}, segment-sum launches "
        f"{counts['segment_sum']} = {SHARDS} x rounds, no megakernel; "
        f"core, uf_parent, uf_L and cuts at {sorted(main['cuts'])} equal "
        f"to phase 3; decompose_s={dec_s:.2f} (phase 3 "
        f"{main['decompose_s']:.2f}); {dec.peel_stats}")
    sharded_launches = counts["segment_sum"]

    # the segment sum at one slab's plan (slab 0 of the mesh)
    rids, sids = _partition(p, mesh)[0].plans[0]
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    dead = (torch.rand(p.n_s, generator=gen, device="cuda") < 0.3).to(
        torch.int32)
    data = torch.index_select(dead, 0, sids)[:, None]
    require(torch.equal(segment_sum(data, rids, p.n_r),
                        segment_sum_plain(data, rids, p.n_r)),
            "segment_sum differs from its plain version at a slab's plan")
    slab_ms = cuda_ms(lambda: segment_sum(data, rids, p.n_r), 20)
    slab_plain = cuda_ms(lambda: segment_sum_plain(data, rids, p.n_r), 5)
    slab_lib = cuda_ms(lambda: torch.zeros((p.n_r, 1), dtype=torch.int32,
                                           device="cuda").index_add_(
                                               0, rids, data), 5)
    E = int(rids.shape[0])
    slab_bound = 1e3 * 4 * (E + E + p.n_r) / HBM_BYTES_PER_S
    log(f"[sharded] segment_sum at slab 0's plan (E={E} of "
        f"{int(p.mem_sids.shape[0])}, n_r={p.n_r}): equal to plain; "
        f"kernel_ms={slab_ms:.4f} plain_ms={slab_plain:.4f} "
        f"library_ms={slab_lib:.4f} bound_ms={slab_bound:.4f}")
    del data, dead

    # (c) the host mesh: every visible card
    host = make_host_mesh()
    reset_launch_counts()
    dh, dh_s = timed(lambda: decompose(p, NucleusConfig(backend="sharded")))
    counts = dict(launch_counts)
    equal_to_main(dh, "sharded decompose on make_host_mesh()")
    require(counts["segment_sum"] == len(host) * dh.rounds and
            counts["peel_round"] == 0,
            f"host-mesh launches {counts} over {dh.rounds} rounds")
    ran = dh.peel_stats
    require(ran["collective"] == ("nccl" if len(host) > 1 else "local"),
            f"host mesh {host}: {ran}")
    log(f"[sharded] make_host_mesh() = {host}: "
        f"{'one slab, no collective' if len(host) == 1 else 'NCCL'} ran "
        f"({ran}); equal to phase 3; decompose_s={dh_s:.2f}")
    del dh

    # (d) compress=True: the same arrays, and the star of the fault
    dc, dc_s = timed(lambda: decompose(p, dataclasses.replace(
        cfg, compress=True)))
    equal_to_main(dc, "sharded decompose with compress=True")
    log(f"[sharded] compress=True on {mesh}: arrays equal to (b); drain "
        f"steps {dc.peel_stats['drain_steps']}; decompose_s={dc_s:.2f}")
    del dc
    leaves = torch.arange(1, STAR_LEAVES + 1, dtype=torch.int32,
                          device="cuda")
    star = Graph(n=STAR_LEAVES + 1, edges=torch.stack(
        [torch.zeros_like(leaves), leaves], dim=1))
    ds = decompose(star, NucleusConfig(
        r=1, s=2, backend="sharded", compress=True,
        mesh=Mesh(("cuda:0",) * 2)))
    require(int(ds.core[0]) == 1 and int(ds.core.max()) == 1 and
            ds.peel_stats["drain_steps"] > 0,
            f"star: hub core {int(ds.core[0])}, {ds.peel_stats}")
    log(f"[sharded] star of {STAR_LEAVES} leaves at (1,2), compress=True "
        f"over 2 slabs: hub core 1, drain steps "
        f"{ds.peel_stats['drain_steps']}")

    # (e) approx: equal to the dense approx run on the card
    da = decompose(p, dataclasses.replace(cfg, method="approx"))
    want = decompose(p, NucleusConfig(method="approx"))
    require(da.rounds == want.rounds, "approx: rounds differ")
    same_arrays(da, want, forest + ("peel_value",), "sharded approx")
    log(f"[sharded] approx on {mesh}: core, peel_value, uf_parent, uf_L "
        f"equal to the dense approx run (rounds {da.rounds})")
    del da, want, dec, p
    torch.cuda.empty_cache()

    # (f) a Router pool on the sharded backend
    router = Router()
    router.pool(NucleusConfig(backend="sharded", mesh=mesh))
    for i in (0, len(POOL_CONFIGS)):  # phase 9's two (2,3) graphs
        gi = community_power_law(POOL_N + POOL_STEP * i, seed=i,
                                 device="cuda")
        art = router.route(Request(graph=gi, backend="sharded"))
        want = decompose(gi, NucleusConfig())
        require(art.rounds == want.rounds, f"pool graph {i}: rounds differ")
        same_arrays(art, want, forest, f"pool graph {i} vs decompose")
    pool = router.report()["pools"][0]
    buckets = [b for b in pool["buckets"] if "shards" in b]
    require(pool["stats"]["warm"] == 1 and len(buckets) == 1 and
            buckets[0]["shards"] == SHARDS,
            f"sharded pool: {pool['stats']} {pool['buckets']}")
    log(f"[sharded] Router pool of 2 graphs of ~{POOL_N} vertices on "
        f"{mesh}: 1 warm hit, bucket {buckets[0]}, each artifact equal to "
        f"decompose")
    return {"sharded_launches": sharded_launches, "sharded_slab_ms": slab_ms,
            "sharded_slab_plain_ms": slab_plain,
            "sharded_slab_library_ms": slab_lib,
            "sharded_slab_bound_ms": slab_bound,
            "sharded_path": "decompose(g, NucleusConfig(backend='sharded', "
                            "build='sharded', build_shards=4, mesh=Mesh(("
                            "'cuda:0',) * 4)))"}


# phase 13: the recsys (din) and GNN families at their published widths
DIN_TRAIN_STEPS = 3      # train_din steps at train_batch's 65,536 rows
DIN_SERVE_BATCHES = {"serve_p99": 8, "serve_bulk": 2}  # serve_din batches
DIN_CPU_ROWS = 512       # card == CPU: forward scores and loss
DIN_CPU_TOL = 1e-4       # ||card - cpu|| / ||cpu||, f32
GNN_ARCHS = ("gin-tu", "egnn", "dimenet", "mace")
GNN_PROBES = (1 / 1024, 1 / 512)  # ogb_products: two probes' shares of
                         # its nodes and edges, for a line through their peaks
GNN_BUDGET = 64e9        # bytes a train step may peak at on the 80 GB card
GNN_CPU_TOL = 1e-3       # card == CPU per gradient leaf, f32, atomics


def timed_call(fn, *args):
    """(fn(*args), synced seconds, peak GB of the call)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t,
            torch.cuda.max_memory_allocated() / 1e9)


def phase_din(seed: int):
    """Phase 13 (a): din at its published width (10^6/10^4/10^5 x 18
    tables, seq 100).  train_batch: DIN_TRAIN_STEPS ``train_din`` steps of
    65,536 rows, each ``din_train_step`` timed (finite losses, every leaf
    changed by the first step); serve_p99 and serve_bulk through
    ``serve_din`` and one timed ``din_serve_step`` each; retrieval_cand:
    ``din_retrieval_step`` over 1,000,448 padded candidates (chunked),
    its first DIN_CPU_ROWS scores equal to ``forward``'s; card == CPU on
    a DIN_CPU_ROWS-row batch (scores and loss)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.din import n_candidates_padded
    from repro_torch.data import RecsysStream, RecsysStreamConfig
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as train_mod
    from repro_torch.models import din as D
    from repro_torch.tree import flatten_with_paths, tree_map

    spec = get_arch("din")
    cfg = spec.make_config()
    out = {}

    def stream(rows, s=seed):
        return RecsysStream(RecsysStreamConfig(
            n_items=cfg.n_items, n_cates=cfg.n_cates,
            n_users=cfg.n_user_feats, seq_len=cfg.seq_len, batch=rows,
            seed=s))

    # -- train_batch: train_din, its steps timed by a wrapper ---------------
    B = spec.shape("train_batch").dims["batch"]
    steps = []
    plain_step = S.din_train_step

    def step(params, opt_state, b, c, opt):
        first = ([(k, p.clone()) for k, p in flatten_with_paths(params)]
                 if not steps else None)
        (params, opt_state, m), s, peak = timed_call(
            plain_step, params, opt_state, b, c, opt)
        m = {k: float(v) for k, v in m.items()}
        steps.append({"s": s, "rows_s": B / s, "peak_gb": peak, **m})
        log(f"[din] train_batch step {len(steps) - 1} (B={B}): {s:.3f} s, "
            f"{B / s:.0f} rows/s, loss {m['loss']:.5f}, grad_norm "
            f"{m['grad_norm']:.4g}, peak {peak:.2f} GB")
        if first is not None:
            now = dict(flatten_with_paths(params))
            same = [k for k, p in first if torch.equal(now[k], p)]
            require(not same, f"din leaves unchanged by step 0: {same}")
        return params, opt_state, m
    S.din_train_step = step
    try:
        t = time.perf_counter()
        run = train_mod.train_din(steps=DIN_TRAIN_STEPS, smoke=False,
                                  batch=B, quiet=True, device=None)
        wall = time.perf_counter() - t
    finally:
        S.din_train_step = plain_step
    require(len(steps) == DIN_TRAIN_STEPS and np.isfinite(run.losses).all(),
            f"train_din: losses {run.losses}")
    log(f"[din] train_din(smoke=False, batch={B}): {DIN_TRAIN_STEPS} steps "
        f"in {wall:.2f} s with the host's RecsysStream batches; losses "
        f"{run.losses}")
    out["train_batch"] = steps

    # -- serve_p99, serve_bulk: serve_din, and one timed serve step ---------
    params = D.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    for name, n_batches in DIN_SERVE_BATCHES.items():
        rows = spec.shape(name).dims["batch"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        scores = serve_mod.serve_din(n_batches=n_batches, batch=rows,
                                     smoke=False, quiet=True)
        wall = time.perf_counter() - t
        require(scores.shape == (n_batches * rows,)
                and np.isfinite(scores).all()
                and ((scores >= 0) & (scores <= 1)).all(),
                f"serve_din {name}: scores out of range")
        b = {k: torch.from_numpy(v).cuda()
             for k, v in stream(rows).batch(0).items() if k != "label"}
        got, s, peak = timed_call(S.din_serve_step, params, b, cfg)
        log(f"[din] {name} (B={rows}): serve_din {n_batches} batches "
            f"{wall:.2f} s ({n_batches * rows / wall:.0f} req/s with the "
            f"host's batches); din_serve_step {s * 1e3:.2f} ms "
            f"({rows / s:.0f} rows/s), peak {peak:.2f} GB")
        out[name] = {"serve_din_s": wall, "step_s": s, "rows_s": rows / s,
                     "peak_gb": peak}
        del b, got

    # -- retrieval_cand: one user against 1,000,448 candidates -------------
    NC = n_candidates_padded(spec.shape("retrieval_cand"))
    rng = np.random.default_rng(seed + 13)
    hist = rng.integers(0, cfg.n_items, cfg.seq_len).astype(np.int32)
    hist[cfg.seq_len * 3 // 4:] = -1
    cands = rng.integers(0, cfg.n_items, NC).astype(np.int32)
    rb = {"hist_items": hist,
          "hist_cates": np.where(hist >= 0, hist % cfg.n_cates,
                                 -1).astype(np.int32),
          "user_id": np.asarray(rng.integers(0, cfg.n_user_feats),
                                np.int32),
          "cand_items": cands, "cand_cates": (cands % cfg.n_cates).astype(
              np.int32)}
    rb = {k: torch.from_numpy(v).cuda() for k, v in rb.items()}
    scores, s, peak = timed_call(S.din_retrieval_step, params, rb, cfg)
    require(scores.shape == (NC,) and bool(torch.isfinite(scores).all()),
            "retrieval scores")
    k = DIN_CPU_ROWS
    fb = {"hist_items": rb["hist_items"].expand(k, -1),
          "hist_cates": rb["hist_cates"].expand(k, -1),
          "cand_item": rb["cand_items"][:k], "cand_cate": rb["cand_cates"][:k],
          "user_id": rb["user_id"].expand(k)}
    fwd_err = rel_norm_err(scores[:k], D.forward(params, fb, cfg))
    require(fwd_err <= DIN_CPU_TOL,
            f"retrieval scores vs forward: {fwd_err:.3g}")
    log(f"[din] retrieval_cand ({NC} candidates, chunks of "
        f"{D.RETRIEVAL_CHUNK}): {s:.3f} s ({NC / s:.0f} candidates/s), "
        f"peak {peak:.2f} GB; first {k} scores vs forward {fwd_err:.3g}")
    out["retrieval_cand"] = {"s": s, "rows_s": NC / s, "peak_gb": peak,
                             "vs_forward": fwd_err}
    del scores, rb, fb

    # -- card == CPU at full width ------------------------------------------
    b = stream(DIN_CPU_ROWS, seed + 1).batch(0)
    res = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else tree_map(lambda x: x.cpu(), params)
        bt = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        res[dev] = (D.forward(p, bt, cfg).cpu(),
                    D.loss_fn(p, bt, bt["label"], cfg).cpu())
    errs = [rel_norm_err(g, w) for g, w in zip(res["cuda"], res["cpu"])]
    require(max(errs) <= DIN_CPU_TOL, f"din card vs CPU: {errs}")
    log(f"[din] card == CPU at full width, {DIN_CPU_ROWS} rows (f32, TF32 "
        f"off): scores {errs[0]:.3g}, loss {errs[1]:.3g} "
        f"(||d|| / ||cpu||, bar {DIN_CPU_TOL})")
    out["cpu_err"] = max(errs)
    del params
    torch.cuda.empty_cache()
    return out


def gnn_cell_batch(arch, cell, seed: int, frac: float = 1.0, block=None):
    """(batch dict on the card, n_graphs, node_level, E) of one GNN cell:
    seeded synthetic arrays at the cell's dims (nodes and edges times
    ``frac`` for a cut), ``block`` the minibatch_lg stream's batch."""
    from repro_torch.configs.gnn_shapes import (is_node_level, needs_pos,
                                                needs_triplets)
    from repro_torch.data import synthetic_molecules
    from repro_torch.models.gnn_common import build_triplets

    d = cell.dims
    node_level = is_node_level(cell)
    if cell.name == "molecule":
        m = synthetic_molecules(d["batch"], d["n_nodes"], d["n_edges"],
                                d["d_feat"], seed=seed,
                                triplet_cap=d["triplet_cap"])
        N, E = m["nodes"].shape[0], m["edge_src"].shape[0]
        b = {"nodes": m["nodes"], "edge_src": m["edge_src"],
             "edge_dst": m["edge_dst"], "node_mask": np.ones(N, bool),
             "edge_mask": np.ones(E, bool), "graph_id": m["graph_id"],
             "pos": m["pos"], "energy": m["energy"][:, None]}
        b["triplet_kj"], b["triplet_ji"], b["triplet_mask"] = m["triplets"]
        n_graphs = m["n_graphs"]
    elif block is not None:
        b = dict(block)
        N = b["nodes"].shape[0]
        b["graph_id"] = np.arange(N, dtype=np.int32)
        n_graphs = N
    else:
        N = max(2, int(round(d["n_nodes"] * frac)))
        E = max(1, int(round(d["n_edges"] * frac)))
        g = torch.Generator(device="cuda").manual_seed(seed)
        b = {"nodes": torch.randn((N, d["d_feat"]), generator=g,
                                  device="cuda"),
             "edge_src": torch.randint(0, N, (E,), generator=g,
                                       device="cuda", dtype=torch.int32),
             "edge_dst": torch.randint(0, N, (E,), generator=g,
                                       device="cuda", dtype=torch.int32),
             "node_mask": torch.ones(N, dtype=torch.bool, device="cuda"),
             "edge_mask": torch.ones(E, dtype=torch.bool, device="cuda"),
             "graph_id": torch.arange(N, dtype=torch.int32, device="cuda"),
             "pos": torch.randn((N, 3), generator=g, device="cuda"),
             "labels": torch.randint(0, d["n_classes"], (N,), generator=g,
                                     device="cuda", dtype=torch.int32),
             "label_mask": torch.ones(N, device="cuda")}
        n_graphs = N
    if needs_triplets(arch) and "triplet_kj" not in b:
        src, dst, em = (np.asarray(b[k].cpu() if torch.is_tensor(b[k])
                                   else b[k])
                        for k in ("edge_src", "edge_dst", "edge_mask"))
        kj, ji, _ = build_triplets(src, dst, N, cap_per_edge=d["triplet_cap"])
        b.update(triplet_kj=kj, triplet_ji=ji, triplet_mask=em[kj] & em[ji])
    if not needs_pos(arch):
        b.pop("pos", None)
    if not needs_triplets(arch):
        for k in ("triplet_kj", "triplet_ji", "triplet_mask"):
            b.pop(k, None)
    b = {k: (v if torch.is_tensor(v) else torch.from_numpy(
        np.asarray(v))).cuda() for k, v in b.items()}
    return b, n_graphs, node_level, int(b["edge_src"].shape[0])


def gnn_unreached(arch: str, cfg) -> list:
    """Key paths of the parameters ``gnn_loss`` cannot reach, so their
    gradient is zero, in the reference as in the port: egnn's last
    coordinate head (no loss reads the coordinates); mace's first layer's
    vector and tensor mixes (they act on the zero initial v and t) and
    its last layer's v and t updates with their gate and ACE weights (no
    loss reads the last v and t).  ``tests/test_torch_gnn.py`` holds this
    list to ``jax.grad``'s zero leaves at the smoke configs."""
    if arch == "egnn":
        last = f"['layers']/[{cfg.n_layers - 1}]"
        return [f"{last}/['phi_x']/['{k}']" for k in ("b0", "b1", "w0", "w1")]
    if arch == "mace":
        last = f"['layers']/[{cfg.n_layers - 1}]"
        keys = ([f"['layers']/[0]/['{k}']"
                 for k in ("mix_t", "mix_v", "res_t", "res_v")] +
                [f"{last}/['{k}']" for k in
                 ("b1", "b2", "res_t", "res_v", "upd_t", "upd_v")] +
                [f"{last}/['gate']/['{k}']" for k in ("b0", "w0")])
        return sorted(set(keys))
    return []


def gnn_step(arch, cfg, b, n_graphs, node_level, seed: int, what: str):
    """Two ``gnn_train_step``s from seeded parameters, with no weight
    decay so that a leaf moves only by its gradient.  The first (set-up
    included) must give exactly ``gnn_unreached``'s leaves a zero
    gradient (moment mu all zero) and leave them unchanged, and change
    every other leaf; the second is the warm step that is timed.  Both
    losses finite.  Returns the record."""
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten_with_paths

    params = S._GNN[arch].init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                            weight_decay=0.0)
    first = [(k, p.clone()) for k, p in flatten_with_paths(params)]
    state = adamw.init_state(params)
    args = (b, cfg, arch, n_graphs, node_level, opt)
    (params, state, m), s0, peak0 = timed_call(S.gnn_train_step, params,
                                               state, *args)
    now = dict(flatten_with_paths(params))
    zero = sorted(k for k, mu in flatten_with_paths(state.mu)
                  if not bool(mu.any()))
    same = sorted(k for k, p in first if torch.equal(now[k], p))
    want = gnn_unreached(arch, cfg)
    require(zero == want and same == want,
            f"{what}: zero-gradient leaves {zero} and unchanged leaves "
            f"{same}, where the loss cannot reach {want}")
    del first, now
    (params, state, m2), s, peak = timed_call(S.gnn_train_step, params,
                                              state, *args)
    losses = [float(m["loss"]), float(m2["loss"])]
    norms = [float(m["grad_norm"]), float(m2["grad_norm"])]
    require(all(map(math.isfinite, losses + norms)),
            f"{what}: losses {losses}, grad_norms {norms}")
    return {"s": s, "first_s": s0, "peak_gb": max(peak0, peak),
            "loss": losses[0], "unreached": want}


def phase_gnn(seed: int):
    """Phase 13 (b): gin-tu, egnn, dimenet and mace at their published
    widths (``cfg_for_cell``: the cell's d_in and classes) on the four
    cells, two ``gnn_train_step``s each (``gnn_step``): molecule (128 molecules of
    ``synthetic_molecules``, triplet cap 8), full_graph_sm (cora's 2,708
    nodes, 10,556 edges, 1,433 features), minibatch_lg (a 1,024-seed 15-10
    block of ``GraphMinibatchStream`` over a random base graph of
    reddit's 232,965 vertices and 114,615,892 edges, uncut) and ogb_products (2,449,029 nodes,
    61,859,140 edges): two probes at GNN_PROBES of its nodes and edges
    reckon the full cell's peak along a line, and the step runs on the
    largest cut under GNN_BUDGET (uncut where it fits).  Then card == CPU per arch on the
    molecule cell (loss and every gradient leaf)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_shapes import cfg_for_cell
    from repro_torch.data import GraphMinibatchStream
    from repro_torch.graph import make_graph
    from repro_torch.launch import steps as S
    from repro_torch.tree import tree_map

    cells = {c.name: c for c in get_arch(GNN_ARCHS[0]).shapes}
    out = {a: {} for a in GNN_ARCHS}

    # minibatch_lg's block: one stream batch over the uncut base graph
    d = cells["minibatch_lg"].dims
    t = time.perf_counter()
    rng = np.random.default_rng(seed + 21)
    base = make_graph(d["base_nodes"], rng.integers(
        0, d["base_nodes"], (d["base_edges"], 2)), device="cuda")
    t_graph = time.perf_counter() - t
    stream = GraphMinibatchStream(base, fanouts=list(d["fanout"]),
                                  batch_nodes=d["batch_nodes"],
                                  d_feat=d["d_feat"],
                                  n_classes=d["n_classes"], seed=seed,
                                  with_pos=True)
    t_csr = time.perf_counter() - t - t_graph
    block = stream.batch(0)
    live = (int(block["node_mask"].sum()), int(block["edge_mask"].sum()))
    log(f"[gnn] minibatch_lg base graph: {d['base_nodes']} vertices, "
        f"{base.m} edges after make_graph's dedup of {d['base_edges']} "
        f"drawn, uncut ({t_graph:.2f} s to draw and build, "
        f"{t_csr:.2f} s for the sampler's CSR); block of {live[0]} "
        f"live nodes / {live[1]} live edges in the padded "
        f"{stream.cap_nodes} x {stream.cap_edges}; "
        f"{time.perf_counter() - t:.2f} s in all")
    del base, stream

    for arch in GNN_ARCHS:
        spec = get_arch(arch)
        for name in ("molecule", "full_graph_sm", "minibatch_lg",
                     "ogb_products"):
            cell = cells[name]
            cfg = cfg_for_cell(spec, cell)
            frac, note = 1.0, "uncut"
            if name == "ogb_products":
                peaks = []
                for f in GNN_PROBES:
                    b, ng, nl, E = gnn_cell_batch(arch, cell, seed, f)
                    peaks.append(gnn_step(arch, cfg, b, ng, nl, seed,
                                          f"{arch} {name} probe")["peak_gb"])
                    del b
                    torch.cuda.empty_cache()
                # peak = fixed + slope * share, through the two probes
                slope = (peaks[1] - peaks[0]) / (GNN_PROBES[1] -
                                                 GNN_PROBES[0])
                fixed = peaks[0] - slope * GNN_PROBES[0]
                full_gb = fixed + slope
                if slope > 0:
                    frac = min(1.0, (GNN_BUDGET / 1e9 - fixed) / slope)
                note = (f"peak reckoned {full_gb:.1f} GB uncut (probes at "
                        f"{GNN_PROBES[0]:.4g} and {GNN_PROBES[1]:.4g} of "
                        f"it: {peaks[0]:.3f} and {peaks[1]:.3f} GB); " +
                        ("uncut" if frac == 1.0 else
                         f"cut to {frac:.4f} of its nodes and edges to "
                         f"stay under {GNN_BUDGET / 1e9:.0f} GB"))
            b, ng, nl, E = gnn_cell_batch(
                arch, cell, seed, frac,
                block if name == "minibatch_lg" else None)
            rec = gnn_step(arch, cfg, b, ng, nl, seed, f"{arch} {name}")
            rec.update(frac=frac, edges=E, nodes=int(b["nodes"].shape[0]),
                       edges_s=E / rec["s"])
            if "triplet_kj" in b:
                rec["triplets"] = int(b["triplet_kj"].shape[0])
            log(f"[gnn] {arch} {name}: {rec['nodes']} nodes, {E} edges"
                + (f", {rec['triplets']} triplets" if "triplets" in rec
                   else "") +
                f"; warm step {rec['s']:.3f} s (first {rec['first_s']:.3f} "
                f"s), {rec['edges_s']:.4g} edges/s, peak "
                f"{rec['peak_gb']:.2f} GB, loss {rec['loss']:.5g}; "
                f"{note}" + (f"; zero-gradient leaves {rec['unreached']}"
                             if rec["unreached"] else ""))
            out[arch][name] = rec
            del b
            torch.cuda.empty_cache()

    # card == CPU on the molecule cell, full width, f32
    for arch in GNN_ARCHS:
        cell = cells["molecule"]
        cfg = cfg_for_cell(get_arch(arch), cell)
        b, ng, nl, _ = gnn_cell_batch(arch, cell, seed)
        params = S._GNN[arch].init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(seed), device="cuda")
        res = {}
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda x: x.to(dev), params)
            bt = {k: v.to(dev) for k, v in b.items()}
            loss, grads = S.value_and_grad(S.gnn_loss, p, bt, cfg, arch, ng,
                                           nl)
            res[dev] = [loss] + grads
        errs = [rel_norm_err(g.cpu(), w)
                for g, w in zip(res["cuda"], res["cpu"])]
        require(max(errs) <= GNN_CPU_TOL,
                f"{arch} card vs CPU: loss {errs[0]:.3g}, worst leaf "
                f"{max(errs[1:]):.3g}")
        log(f"[gnn] {arch} card == CPU on molecule (f32, TF32 off): loss "
            f"{errs[0]:.3g}, worst of {len(errs) - 1} gradient leaves "
            f"{max(errs[1:]):.3g} (||d|| / ||cpu||, bar {GNN_CPU_TOL})")
        out[arch]["cpu_err"] = max(errs)
        del params, b, res
        torch.cuda.empty_cache()
    return out


# phase 14: sharded LM training of minicpm-2b and the elastic restore
SHARD_MESH = (2, 2)      # ("data", "model"): four slots, one card or four
SHARD_B = 2              # train_4k's global batch of 256 cut to 2 (a row
SHARD_STEPS = 3          # a data index); sharded steps timed, the last warm
SHARD_CHECK_S = 256      # (b): the full width at 2 layers in f32
SHARD_LOSS_TOL = 1e-4    # (b): the reference's sharded-step bars: loss
SHARD_PARAM_TOL = 5e-4   # rel, params abs outside Adam's eps regime
EPS_REGIME = 1e-5        # sqrt(nu_hat) below this: Adam's eps regime
REMESH = ((4, 1), (1, 4), (1, 1))  # (c): meshes the (2, 2) save restores on
DM = ("data", "model")


def shard_bytes(sharded, slot: int) -> int:
    """Bytes slot ``slot`` holds of a list of sharded tensors."""
    return sum(st.shards[slot].numel() * st.shards[slot].element_size()
               for st in sharded)


def spec_share_bytes(sharded) -> int:
    """A slot's bytes as the specs reckon them: each tensor's bytes over
    the product of the axis sizes its spec uses."""
    total = 0
    for st in sharded:
        parts = math.prod(st.mesh.shape[a] for e in st.spec if e is not None
                          for a in ((e,) if isinstance(e, str) else e))
        total += st.shape.numel() * st.dtype.itemsize // parts
    return total


def same_replicas(sharded) -> bool:
    """Slots that hold one slice of a tensor hold equal bits."""
    for st in sharded:
        first = {}
        for j, shard in enumerate(st.shards):
            key = tuple((x.start, x.stop) for x in st.index(j))
            if not same_bits(first.setdefault(key, shard), shard):
                return False
    return True


def tree_clone(x):
    return {k: tree_clone(v) for k, v in x.items()} if isinstance(x, dict) \
        else x.clone()


def phase_sharded_train(seed: int):
    """Phase 14: sharded LM training of minicpm-2b and the elastic
    re-mesh restore.  (a) At its published width (bf16, remat) on a
    ("data", "model") = (2, 2) mesh over the card's slots (the distinct
    cards, repeated in order): parameters placed by ``lm_param_rules``,
    SHARD_STEPS ``lm_train_step_sharded`` at B = 2, S = 4,096, each timed
    (synced) with tok/s and peak GB; every slot's shard bytes equal the
    specs' share; finite losses; every leaf's slot-0 shard changed by the
    first step.  (b) The full width at 2 layers in f32: the (2, 2) step
    against the one-device ``lm_train_step`` from the same weights and
    batch (loss rel 1e-4; params 5e-4 outside Adam's eps regime, lr
    inside), bit for bit against ``lm_train_step_microbatched`` of 2 row
    groups, replicated slices bit-identical across slots.  (c) The 2-layer
    cut in bf16 through ``train_lm``: a (2, 2) run saves at step 2, its
    checkpoint restores with ``sharding_tree`` onto (4, 1), (1, 4) and
    (1, 1) bit for bit, and a run resumed on (1, 1) gives the losses of
    an uninterrupted (2, 2) run (rtol 1e-4).  (d) ``setup_platform``'s
    record.  No kernel lies on this path."""
    import shutil
    import tempfile
    import zipfile
    from repro_torch import device as device_policy
    from repro_torch.configs import base, get_arch
    from repro_torch.data import TokenStream, TokenStreamConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.platform import setup_platform
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten_with_paths, leaves

    spec = get_arch(LM_ARCH)
    cfg = spec.make_config()
    seq = spec.shape("train_4k").dims["seq_len"]
    n_params = cfg.param_count()
    opt = adamw.AdamWConfig(lr=TRAIN_LR, schedule="wsd", warmup_steps=1,
                            total_steps=SHARD_STEPS)
    gc.collect()    # earlier phases' cyclic garbage may hold card memory
    torch.cuda.empty_cache()
    mesh = make_mesh(SHARD_MESH, DM)
    log(f"[sharded-train] mesh {mesh}; {torch.cuda.memory_allocated() / 1e9:.2f}"
        f" GB allocated before the phase")

    # -- (a) full width on (2, 2) -----------------------------------------
    t = time.perf_counter()
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    shardings = S.lm_state_shardings(params, cfg, mesh)
    params = SH.device_put(params, shardings[0])
    state = S.init_sharded_state(params)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    place_s = time.perf_counter() - t
    slot_bytes = [shard_bytes(leaves((params, state)), i)
                  for i in range(mesh.size)]
    share = spec_share_bytes(leaves((params, state)))
    require(all(b == share for b in slot_bytes),
            f"slot bytes {slot_bytes} != the specs' share {share}")
    specs = {k: tuple(st.spec) for k, st in
             flatten_with_paths(params, plain=True)}
    log(f"[sharded-train] {LM_ARCH} full width, {n_params} params, bf16, "
        f"remat, placed by lm_param_rules in {place_s:.2f} s: {specs}; "
        f"each slot holds {share / 1e9:.3f} GB of params + moments "
        f"(= the specs' share), {mesh.size} slots "
        f"{sum(slot_bytes) / 1e9:.3f} GB")
    stream = TokenStream(TokenStreamConfig(vocab=cfg.vocab, seq_len=seq,
                                           global_batch=SHARD_B, seed=seed))
    first = [st.shards[0].clone() for st in leaves(params)]
    steps = []
    for i in range(SHARD_STEPS):
        b = {k: torch.from_numpy(v).cuda()
             for k, v in stream.batch(i).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        params, state, m = S.lm_train_step_sharded(params, state, b, cfg,
                                                   opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        m = {k: float(v) for k, v in m.items()}
        ntok = b["tokens"].numel()
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps.append({"step": i, "s": wall, "tok_s": ntok / wall,
                      "peak_gb": peak, **m})
        log(f"[sharded-train] step {i} ((2, 2), B={SHARD_B}, S={seq}): "
            f"{wall:.3f} s, {ntok / wall:.0f} tok/s "
            f"({6 * n_params * ntok / wall / 1e12:.1f} TFLOP/s by 6ND), "
            f"loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, lr "
            f"{m['lr']:.3g}, peak {peak:.2f} GB")
        require(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
                f"sharded step {i}: loss or grad_norm not finite")
        if i == 0:
            same = [k for (k, st), s0 in zip(flatten_with_paths(params),
                                             first)
                    if torch.equal(st.shards[0], s0)]
            require(not same, f"slot-0 shards unchanged by the first "
                    f"sharded step: {same}")
            del first
    warm = steps[-1]
    log(f"[sharded-train] warm step: {warm['s']:.3f} s, "
        f"{warm['tok_s']:.0f} tok/s, peak {warm['peak_gb']:.2f} GB "
        f"(one-device B=1 in phase 12)")
    del params, state, b
    torch.cuda.empty_cache()

    # -- (b) 2 layers, f32: (2, 2) vs one device --------------------------
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    base_p = T.init_params(cfg2, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    toks = torch.randint(0, cfg2.vocab, (SHARD_B, SHARD_CHECK_S + 1),
                         generator=torch.Generator().manual_seed(seed))
    b = {"tokens": toks[:, :-1].cuda(), "labels": toks[:, 1:].cuda()}
    sp = SH.device_put(base_p, S.lm_state_shardings(base_p, cfg2, mesh)[0])
    sp, ss, sm = S.lm_train_step_sharded(sp, S.init_sharded_state(sp), b,
                                         cfg2, opt)
    got = SH.gather((sp, ss), "cuda")
    replicas = same_replicas(leaves((sp, ss)))
    del sp, ss
    one = tree_clone(base_p)
    one_p, one_s, om = S.lm_train_step(one, adamw.init_state(one), b, cfg2,
                                       opt)
    loss_err = abs(float(sm["loss"]) - float(om["loss"])) / abs(
        float(om["loss"]))
    bc2 = 1 - opt.b2 ** int(one_s.step)
    lr = float(om["lr"])
    worst_out, worst_in = 0.0, 0.0
    for g, w, nu in zip(leaves(got[0]), leaves(one_p), leaves(one_s.nu)):
        regime = torch.sqrt(nu / bc2) < EPS_REGIME
        d = (g - w).abs()
        worst_out = max(worst_out, float(d[~regime].max()) if
                        bool((~regime).any()) else 0.0)
        worst_in = max(worst_in, float(d[regime].max()) if
                       bool(regime.any()) else 0.0)
    require(loss_err <= SHARD_LOSS_TOL and worst_out <= SHARD_PARAM_TOL and
            worst_in <= lr,
            f"sharded step != one-device step: loss rel {loss_err:.3g}, "
            f"params {worst_out:.3g} outside the eps regime, {worst_in:.3g} "
            f"inside (lr {lr:.3g})")
    del one, one_p, one_s
    mp = tree_clone(base_p)
    mp, ms, mm = S.lm_train_step_microbatched(mp, adamw.init_state(mp), b,
                                              cfg2, opt, SHARD_MESH[0])
    micro_bits = all(same_bits(a, c) for a, c in zip(leaves(got),
                                                     leaves((mp, ms))))
    require(micro_bits and same_bits(sm["loss"], mm["loss"]),
            "the sharded step differs from lm_train_step_microbatched of "
            "|data| row groups")
    require(replicas, "slots holding one slice hold different bits")
    log(f"[sharded-train] (2, 2) vs one device, full width, 2 layers, f32, "
        f"B={SHARD_B} S={SHARD_CHECK_S}: loss rel err {loss_err:.3g} (bar "
        f"{SHARD_LOSS_TOL}), params max abs err {worst_out:.3g} outside "
        f"Adam's eps regime (bar {SHARD_PARAM_TOL}), {worst_in:.3g} inside "
        f"(bar lr {lr:.3g}); bit-identical to lm_train_step_microbatched "
        f"of {SHARD_MESH[0]} row groups; replicated slices bit-identical "
        f"across slots")
    del got, mp, ms, base_p, b
    torch.cuda.empty_cache()

    # -- (c) the elastic restore: 2-layer cut, bf16, train_lm --------------
    cut_id = f"{LM_ARCH}-2-layers"
    base.register(dataclasses.replace(
        spec, arch_id=cut_id,
        make_config=lambda: dataclasses.replace(cfg, n_layers=2)))
    saved, remesh = {}, {}
    manager = train_mod.CheckpointManager

    class Recorded(manager):
        """Keeps a card copy of each saved (logical) state, and times each
        restore and holds it to the saved state bit for bit."""

        def save(self, step, state, extra=None, blocking=False):
            saved[step] = SH.gather(state, "cuda")
            super().save(step, state, extra, blocking)

        def restore(self, like, step=None, sharding_tree=None):
            t = time.perf_counter()
            state, at, extra = super().restore(like, step, sharding_tree)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            flat = leaves(state)
            mesh = flat[0].mesh
            ok = all(st.mesh == mesh and same_bits(st.gather("cuda"), w)
                     for st, w in zip(flat, leaves(saved[at])))
            remesh[mesh.axis_sizes] = (ok, dt, shard_bytes(flat, 0))
            return state, at, extra

    tmp = tempfile.mkdtemp(prefix="chip_smoke_remesh_")
    train_mod.CheckpointManager = Recorded
    try:
        run = dict(smoke=False, quiet=True)
        t = time.perf_counter()
        whole = train_mod.train_lm(cut_id, steps=RESUME_STEPS,
                                   mesh=make_mesh(SHARD_MESH, DM), **run)
        part = train_mod.train_lm(cut_id, steps=2, ckpt_dir=tmp,
                                  ckpt_every=2,
                                  mesh=make_mesh(SHARD_MESH, DM), **run)
        save_s = time.perf_counter() - t
        with zipfile.ZipFile(os.path.join(tmp, "step_2",
                                          "arrays.npz")) as z:
            members = z.namelist()
        require(members == CKPT_MEMBERS,
                f"checkpoint members {members} are not the reference's")
        # onto (4, 1) and (1, 4) here; onto (1, 1) in the resumed run
        like = saved[2]
        ccfg = get_arch(cut_id).make_config()
        for sizes in REMESH[:-1]:
            state, _, _ = Recorded(tmp).restore(
                like, sharding_tree=S.lm_state_shardings(
                    like[0], ccfg, make_mesh(sizes, DM)))
            del state
            torch.cuda.empty_cache()
        del like
        t = time.perf_counter()
        resumed = train_mod.train_lm(cut_id, steps=RESUME_STEPS,
                                     ckpt_dir=tmp, ckpt_every=10 ** 9,
                                     resume=True, microbatches=SHARD_MESH[0],
                                     mesh=make_mesh(REMESH[-1], DM), **run)
        resume_s = time.perf_counter() - t
    finally:
        train_mod.CheckpointManager = manager
        shutil.rmtree(tmp, ignore_errors=True)
        del base._REGISTRY[cut_id]
        saved.clear()
    require(resumed.restored_from == 2, "the (1, 1) run did not resume")
    require(sorted(remesh) == sorted(REMESH) and
            all(v[0] for v in remesh.values()),
            f"restores not bit for bit the saved state: "
            f"{ {k: v[0] for k, v in remesh.items()} }")
    require(np.allclose(part.losses, whole.losses[:2], rtol=1e-4, atol=0),
            "the saving run's losses differ from the whole run's")
    require(np.allclose(resumed.losses, whole.losses[2:], rtol=1e-4,
                        atol=0),
            f"resumed (1, 1) losses {resumed.losses} != uninterrupted "
            f"(2, 2) {whole.losses[2:]}")
    log(f"[sharded-train] elastic restore, 2 layers, bf16 (train_lm, B=8, "
        f"S=64): a (2, 2) run saved at step 2 ({len(members)} members, the "
        f"reference's keys; whole + saving run {save_s:.2f} s); restored "
        f"bit for bit onto " + ", ".join(
            f"{k} in {v[1]:.2f} s ({v[2] / 1e9:.3f} GB in slot 0)"
            for k, v in remesh.items()) +
        f"; the (1, 1) run resumed with {SHARD_MESH[0]} microbatches: "
        f"losses {resumed.losses} == uninterrupted (2, 2) "
        f"{whole.losses[2:]} (rtol 1e-4; {resume_s:.2f} s)")

    # -- (d) setup_platform's record -----------------------------------------
    records = [setup_platform()]
    try:
        records.append(setup_platform("gpu", cpu_devices=2))
    finally:
        device_policy.set_platform(None)
        device_policy.set_cpu_slots(1)
    require(records[0] == dict.fromkeys(records[0]),
            f"setup_platform() applied {records[0]}")
    log(f"[platform] setup_platform() -> {records[0]}; "
        f"setup_platform('gpu', cpu_devices=2) -> {records[1]}")
    return {"steps": steps, "slot_bytes": share, "loss_err": loss_err,
            "param_err": worst_out}


TOOL_MESH = (2, 2)       # phase 15 (c): the dry run's mesh, phase 14's


def phase_tooling(slot_bytes: int):
    """Phase 15: the port's tooling on the card.  (a) ``calibrate_planner
    --quick`` into a temporary profile: a ``cuda`` entry with an int
    ``tiny_nr`` and a bool ``kernel_default``, which ``resolve_plan``
    then names (``planner_profile['cuda']``) among its reasons; and the
    committed file's ``cuda`` entry is the one the default path loads.
    (b) ``check_build_budget`` on the card passes: both digests, the
    accounted bytes and the device peak delta printed.  (c) The dry run of
    minicpm-2b's train_4k on a device-less (2, 2) mesh: its per-slot
    parameter + moment bytes equal phase 14's measured slot bytes, byte
    for byte, and its FLOPs per token are within 5 % of the analytic 6ND
    + attention count.  (d) The megakernel's launches in (a) equal the
    rounds the calibration's races ran (the counter is reset before (a),
    so they are apart from the main path's)."""
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.core import backends as B
    from repro_torch.core import planner_profile as PP
    from repro_torch.core.api import NucleusConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.tools import calibrate_planner as CP
    from repro_torch.tools import check_build_budget as CB

    # -- (a) + (d) the calibration ------------------------------------------
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "planner_profile.json")
        reset_launch_counts()
        res = CP.calibrate("cuda", quick=True, out=out,
                           log=lambda m: log(f"[tooling] {m}"))
        counts = dict(launch_counts)
        with open(out) as f:
            entry = json.load(f)["profiles"]["cuda"]
        PP.reset_cache()
        plan = B.resolve_plan(NucleusConfig(backend="auto"), n_r=1000,
                              n_s=1000, n_sub=3, device_kind="cuda",
                              profile_path=out)
    PP.reset_cache()
    cal_s = time.perf_counter() - t
    require(type(entry["tiny_nr"]) is int and
            type(entry["kernel_default"]) is bool,
            f"the calibration's cuda entry is malformed: {entry}")
    require(any("planner_profile['cuda']" in r for r in plan.reasons),
            f"resolve_plan did not read the calibrated entry: "
            f"{plan.reasons}")
    with open(PP.PROFILE_PATH) as f:
        committed = json.load(f)["profiles"]["cuda"]
    loaded, source = PP.profile_entry("cuda", "cuda")
    require(loaded == committed and source == "planner_profile['cuda']",
            "the default path does not load the committed cuda entry")
    require(counts["peel_round"] == res["kernel_rounds"] > 0,
            f"megakernel launches {counts['peel_round']} in the "
            f"calibration != the rounds its races ran "
            f"{res['kernel_rounds']}")
    require(counts["segment_sum"] == counts["tricount"] ==
            counts["flash_attention"] == 0,
            f"the calibration launched another kernel: {counts}")
    log(f"[tooling] (a) calibrate_planner --quick: tiny_nr="
        f"{entry['tiny_nr']} kernel_default={entry['kernel_default']} in "
        f"{cal_s:.2f} s; the committed entry (tiny_nr="
        f"{committed['tiny_nr']}, kernel_default="
        f"{committed['kernel_default']}, measured on "
        f"{committed['measured']['power_limit']}) is the default path's")
    log(f"[tooling] (d) megakernel launches in the calibration "
        f"{counts['peel_round']} == the rounds its races ran "
        f"{res['kernel_rounds']}")

    # -- (b) the build-budget gate ------------------------------------------
    t = time.perf_counter()
    gate = CB.gate("cuda", log=lambda m: log(f"[tooling] {m}"))
    gate_s = time.perf_counter() - t
    require(not gate["failures"], f"the build gate failed: "
            f"{gate['failures']}")
    ch = gate["chunked"]
    log(f"[tooling] (b) check_build_budget on the card in {gate_s:.2f} s: "
        f"eager digest {gate['eager']['digest']}, chunked digest "
        f"{ch['digest']}, accounted {ch['accounted_bytes']} B, device peak "
        f"delta {ch['peak_bytes']} B (eager {gate['eager']['peak_bytes']} "
        f"B), budget {CB.BUDGET} B")

    # -- (c) the dry run against phase 14 ------------------------------------
    t = time.perf_counter()
    rec = D.run_cell(LM_ARCH, "train_4k",
                     mesh=AbstractMesh(TOOL_MESH, DM))
    dry_s = time.perf_counter() - t
    kinds = rec["memory"]["argument_bytes_by_kind"]
    dry_slot = kinds["params"] + kinds["opt_state"]
    require(dry_slot == slot_bytes, f"the dry run's slot bytes {dry_slot} "
            f"!= phase 14's measured {slot_bytes}")
    spec = get_arch(LM_ARCH)
    cfg = spec.make_config()
    dims = spec.shape("train_4k").dims
    per_tok = rec["cost"]["model_flops"] / (dims["global_batch"] *
                                            dims["seq_len"])
    want = D.lm_train_flops_per_token(cfg, dims["seq_len"])
    require(abs(per_tok / want - 1) < 0.05, f"the dry run's FLOPs per "
            f"token {per_tok:.4g} are not within 5 % of {want:.4g}")
    log(f"[tooling] (c) dry run of {LM_ARCH} train_4k on {TOOL_MESH} in "
        f"{dry_s:.2f} s: {dry_slot} B of params + moments a slot == phase "
        f"14's {slot_bytes} B; model FLOPs per token {per_tok:.6g} vs "
        f"6ND + attention {want:.6g} (ratio {per_tok / want:.5f}; 6ND alone "
        f"{6 * cfg.param_count():.6g}); with remat's recompute "
        f"{rec['cost']['flops_total'] / (dims['global_batch'] * dims['seq_len']):.6g}; "
        f"temp {rec['memory']['temp_bytes']} B over a slot's "
        f"{dims['global_batch'] // rec['row_groups']} rows; transfers "
        f"{rec['collectives']}")
    return {"calibrate_s": cal_s, "gate_s": gate_s, "dryrun_s": dry_s,
            "kernel_rounds": res["kernel_rounds"]}


# phase 16: the reference's examples as the port's entry points, and the
# Erdos-Renyi graphs of the reference's benchmark suite and at smoke scale
ER2K = (2_000, 16_000, 2)          # (n, m_target, seed): the suite's er2k
ER_BIG = (1_000_000, 10_000_000, 2)  # mean degree 20, ~1,300 triangles
EXAMPLE_KERNELS = ("peel_round", "segment_sum", "flash_attention")


def run_example(name: str, argv, **kw):
    """(figures, wall s, launches) of ``repro_torch.examples.<name>``'s
    ``main(argv, **kw)``; the launch counts are reset before the call."""
    import importlib
    from repro_torch.kernels import launch_counts, reset_launch_counts
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    reset_launch_counts()
    out, s = timed(lambda: mod.main(argv, **kw))
    counts = {k: launch_counts[k] for k in EXAMPLE_KERNELS}
    return out, s, counts


def er_decompose(g, cfg, what: str):
    """``decompose(g, cfg)`` on the card, its core checked by the support
    condition; logs its seconds and peak memory and returns (rounds,
    launches)."""
    from repro_torch import decompose
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    dec, s = timed(lambda: decompose(g, cfg))
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    p = dec.problem
    require(exact_core_support_ok(p, torch.as_tensor(dec.core,
                                                     device="cuda")),
            f"{what}: an r-clique of core k lies in < k s-cliques of core "
            f">= k")
    log(f"[examples] {what}: n_r={p.n_r} n_s={p.n_s} rounds={dec.rounds} "
        f"core max {int(dec.core.max())} decompose_s={s:.3f} peak "
        f"{peak:.2f} GB launches={counts}")
    return dec.rounds, counts


def phase_examples():
    """Phase 16: (a) the six examples of ``repro_torch.examples`` on the
    card, each through its ``main`` at the reference's default arguments:
    quickstart's and approx_vs_exact's cores and rounds equal to the same
    calls on the CPU, graph_pipeline's curated edge set equal to the
    CPU's, elastic_restart's drift 0.0; each one's wall seconds and
    kernel launches logged.  (b) er2k (``erdos_renyi_sparse(2000, 16000,
    seed=2)``) at (1,2), (2,3) and (3,4), core, rounds and every cut equal
    to the CPU's; ``erdos_renyi_sparse(10^6, 10^7, seed=2)`` through
    ``decompose`` at (2,3) (megakernel launches == rounds) and (1,2)
    (segment-sum launches == rounds), each core checked by the support
    condition.  The examples and graphs are seeded by their own
    arguments, as the reference's are.  Returns the megakernel launches
    at (2,3) and the segment-sum launches at (1,2)."""
    import tempfile
    from repro_torch import NucleusConfig, decompose
    from repro_torch.examples import graph_pipeline
    from repro_torch.graph.generators import erdos_renyi_sparse

    # -- (a) the six examples ------------------------------------------------
    def report(name, s, counts, extra=""):
        log(f"[examples] {name}: {s:.2f} s on the card, launches {counts}"
            f"{extra}")

    for name in ("quickstart", "approx_vs_exact"):
        card, s, counts = run_example(name, [])
        cpu, cpu_s, _ = run_example(name, ["--device", "cpu"])
        runs = [("", card, cpu)]
        if name == "approx_vs_exact":
            runs = [("exact", card["exact"], cpu["exact"])] + [
                (f"delta={d}", card["approx"][d], cpu["approx"][d])
                for d in card["approx"]]
        for what, a, b in runs:
            require(np.array_equal(a["core"], b["core"]) and
                    a["rounds"] == b["rounds"],
                    f"{name} {what}: core or rounds differ between card and "
                    f"CPU")
        report(name, s, counts, f"; cores and rounds equal to the CPU's "
               f"({cpu_s:.2f} s)")
    card, s, counts = run_example("graph_pipeline", [])
    g_cpu, _ = graph_pipeline.make_task(device="cpu")
    require(np.array_equal(card["curated_edges"], graph_pipeline.curate(
        g_cpu)[0].edges.numpy()),
            "graph_pipeline: the curated edge set differs between card and "
            "CPU")
    report("graph_pipeline", s, counts, f"; curated edges "
           f"({card['m_curated']}) equal to the CPU's; acc raw "
           f"{card['acc_raw']:.3f} curated {card['acc_curated']:.3f}")
    with tempfile.TemporaryDirectory() as tmp:
        card, s, counts = run_example("elastic_restart", [], tmp_dir=tmp)
        require(card["drift"] == 0.0, f"elastic_restart: drift "
                f"{card['drift']} != 0.0")
        report("elastic_restart", s, counts, f"; drift {card['drift']}")
        card, s, counts = run_example(
            "train_lm", ["--ckpt-dir", os.path.join(tmp, "train_lm")])
        require(card["steps_done"] == 300 and
                bool(np.isfinite(card["losses"]).all()),
                "train_lm: not 300 finite steps")
        report("train_lm", s, counts, f"; loss {card['losses'][0]:.3f} -> "
               f"{card['losses'][-1]:.3f}")
    card, s, counts = run_example("serve_lm", [])
    report("serve_lm", s, counts)

    # -- (b) the Erdos-Renyi graphs ------------------------------------------
    n, m, sd = ER2K
    er2k = {dev: erdos_renyi_sparse(n, m, seed=sd, device=dev)
            for dev in ("cuda", "cpu")}
    for r, s_ in ((1, 2), (2, 3), (3, 4)):
        cfg = NucleusConfig(r=r, s=s_)
        card, card_s = timed(lambda: decompose(er2k["cuda"], cfg))
        cpu = decompose(er2k["cpu"], cfg, device="cpu")
        require(np.array_equal(card.core, cpu.core) and
                card.rounds == cpu.rounds,
                f"er2k ({r},{s_}): core or rounds differ")
        levels = sorted({int(c) for c in cpu.core if c > 0})
        for c in levels:
            require(np.array_equal(card.cut(c), cpu.cut(c)),
                    f"er2k ({r},{s_}): cut({c}) differs")
        log(f"[examples] er2k ({r},{s_}): n={n} m={er2k['cpu'].m} "
            f"n_r={cpu.n_r} n_s={cpu.problem.n_s} rounds={cpu.rounds} "
            f"card_s={card_s:.3f}: core, rounds and {len(levels)} cuts "
            f"equal to the CPU's")
    del er2k

    n, m, sd = ER_BIG
    g, build_s = timed(lambda: erdos_renyi_sparse(n, m, seed=sd,
                                                  device="cuda"))
    log(f"[examples] erdos_renyi_sparse({n}, {m}, seed={sd}) on the card: "
        f"m={g.m} in {build_s:.2f} s")
    rounds23, c23 = er_decompose(g, NucleusConfig(), "ER (2,3)")
    require(c23["peel_round"] == rounds23 and c23["segment_sum"] == 0,
            f"ER (2,3): launches {c23} over {rounds23} rounds")
    rounds12, c12 = er_decompose(g, NucleusConfig(r=1, s=2), "ER (1,2)")
    require(c12["segment_sum"] == rounds12 and c12["peel_round"] == 0,
            f"ER (1,2): launches {c12} over {rounds12} rounds")
    del g
    torch.cuda.empty_cache()
    return c23["peel_round"], c12["segment_sum"]


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
    del lane12
    phase_t = log_phase(9, phase_t)

    # -- phase 10: the sharded lane -------------------------------------------
    rows[1].update(phase_sharded(g, phase3, eager_digest, build_s,
                                 args.seed))
    del phase3
    phase_t = log_phase(10, phase_t)

    # -- phase 11: MoE and MLA inference ------------------------------------
    moe, timing = phase_moe(args.seed)
    rows[3]["moe_mla"] = {a: {"launches": r["flash_launches"][0],
                              "prefill_s": r["prefill_s"]}
                          for a, r in moe.items()}
    rows[3].update(timing)
    # the kernel's errors over every shape it was held to its twin at
    for f in ("max_abs_err", "max_row_rel_err"):
        rows[3][f] = max([rows[3][f], rows[3]["d128"][f]] +
                         [x[f] for x in timing.values()] +
                         [r["layer0_" + f] for r in moe.values()])
    phase_t = log_phase(11, phase_t)

    # -- phase 12: LM training ----------------------------------------------
    train = phase_train(args.seed)
    rows[3]["train"] = {"launches": train["train_launches"],
                        "prefill_launches": train["prefill_launches"],
                        "path": f"lm_train_step({LM_ARCH}, B={TRAIN_B}, "
                                f"S=4096): the online scan"}
    phase_t = log_phase(12, phase_t)

    # -- phase 13: the recsys and GNN families ------------------------------
    before = dict(launch_counts)
    phase_din(args.seed)
    phase_gnn(args.seed)
    require(dict(launch_counts) == before,
            "a kernel launched on the recsys/GNN path, which runs none")
    phase_t = log_phase(13, phase_t)

    # -- phase 14: sharded LM training and the elastic restore ---------------
    del g, bare, counts, order_t, ba, d_gpu, d_cpu
    torch.cuda.empty_cache()
    before = dict(launch_counts)
    shard = phase_sharded_train(args.seed)
    require(dict(launch_counts) == before,
            "a kernel launched on the sharded training path, which runs "
            "none")
    rows[3]["sharded_train"] = {
        "launches": 0, "warm_step_s": shard["steps"][-1]["s"],
        "path": f"lm_train_step_sharded({LM_ARCH}, mesh {SHARD_MESH}, "
                f"B={SHARD_B}, S=4096): the online scan"}
    phase_t = log_phase(14, phase_t)

    # -- phase 15: the tooling on the card ------------------------------------
    phase_tooling(shard["slot_bytes"])
    phase_t = log_phase(15, phase_t)

    # -- phase 16: the examples and the Erdos-Renyi graphs -------------------
    rows[0]["er_sparse_launches"], rows[1]["er_sparse_launches"] = \
        phase_examples()
    phase_t = log_phase(16, phase_t)

    # -- phase 17: the result lines -----------------------------------------
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
