"""Flash-attention kernel variants side by side on the card.

``python -m repro_torch.tools.flash_variants A.cu B.cu ... [--shapes
"1,32,8,4096,160;1,32,8,32768,160"] [--rounds 2] [--iters 10]``

Each source is a whole copy of ``kernels/csrc/flash_attention.cu`` that
exports ``repro_flash_attention`` with the same signature: a design kept
outside the package (a git-ignored ``build/`` directory, so an experiment
never enters the checked-in source) or an earlier commit's file (``git
show REV:src/repro_torch/kernels/csrc/flash_attention.cu``).  ``-`` names
the checked-in source.  Each is built by ``nvcc`` into its own library under
``build/flash_variants/`` (ptxas's registers and spills of its kernels
printed), held to the plain twin at the kernel's block and tile edges in
bf16 (``EDGE_CASES``: the per-row bar 1e-2, and a q x 1.03 control must
fail it), then timed causal in bf16 at each shape with CUDA events, the
variants in turns (A B .. B A, ``--rounds`` times), beside SDPA and the
bound: 4·D·H·S(S+1)/2 flops at the bf16 tensor-core rate.  The last line
is one JSON object of every time, with the card's name and power limit.
Needs a card: raises without one.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels.flash_attention import flash_attention_plain
from .calibrate_planner import power_limit_line

BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
ROW_TOL = 1e-2             # bf16: max over rows of ||got - want|| / ||want||
CONTROL_SCALE = 1.03
# (B, H, Hkv, Sq, Sk, D, causal): Sq and Sk one off the 128-row blocks and
# 128-key tiles (192-row blocks at D = 64), Sq < Sk, Sq > Sk, B > 1 with GQA
EDGE_CASES = (
    (1, 4, 4, 127, 127, 64, True), (1, 4, 4, 257, 257, 64, False),
    (3, 8, 2, 257, 257, 64, True), (1, 4, 2, 255, 255, 128, True),
    (2, 6, 3, 255, 255, 128, False), (1, 24, 8, 700, 2000, 128, True),
    (1, 4, 4, 127, 127, 160, True), (1, 4, 2, 129, 129, 160, True),
    (1, 2, 2, 129, 257, 160, True), (1, 2, 2, 255, 127, 160, False),
    (3, 8, 2, 257, 257, 160, True), (1, 32, 8, 2048, 2048, 160, True),
)
SHAPES = "1,32,8,4096,160;1,32,8,32768,160"
OUT_DIR = _build.BUILD_DIR.parent / "flash_variants"


def build(src: Path, name: str) -> tuple:
    """nvcc src into OUT_DIR/lib<name>.so; returns (path, ptxas lines of
    the entry functions: names, registers, spills)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / f"lib{name}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-shared", str(src), "-o", str(out)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc {src} failed:\n{r.stdout}{r.stderr}")
    keep = ("Compiling entry", "spill", "Used")
    return out, [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                 if any(k in ln for k in keep)]


@functools.lru_cache(maxsize=None)
def load(path: Path):
    """The variant library's entry point, typed as ``_build`` types it."""
    fn = ctypes.CDLL(str(path)).repro_flash_attention
    fn.argtypes = _build.SIGNATURES["repro_flash_attention"]
    fn.restype = ctypes.c_int
    return fn


def call(fn, q, k, v, causal: bool) -> torch.Tensor:
    """One launch of a variant's entry point on bf16 (B, H, S, D) views."""
    B, H, Sq, D = q.shape
    out = torch.empty_like(q)
    strides = [int(s) for x in (q, k, v, out) for s in x.stride()[:3]]
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0,
                B, H, k.shape[1], Sq, k.shape[2], D, int(causal), *strides,
                torch.cuda.current_stream().cuda_stream)
    _build.check(status, "repro_flash_attention")
    return out


def inputs(gen, B, H, Hkv, Sq, Sk, D):
    """q, k, v as the models hand them over: (B, S, H, D) viewed as
    (B, H, S, D), bf16."""
    def make(S, heads):
        return torch.randn((B, S, heads, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16) \
            .transpose(1, 2)
    return make(Sq, H), make(Sk, Hkv), make(Sk, Hkv)


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30))
                 .max())


def check_edges(fns: dict, gen, log) -> None:
    """Every variant within ROW_TOL of the twin at EDGE_CASES, its control
    outside it; raises at the first that is not."""
    for case in EDGE_CASES:
        q, k, v = inputs(gen, *case[:6])
        want = flash_attention_plain(q, k, v, case[6])
        errs = {name: (row_rel_err(call(fn, q, k, v, case[6]), want),
                       row_rel_err(call(fn, q * CONTROL_SCALE, k, v, case[6]),
                                   want))
                for name, fn in fns.items()}
        log(f"[edges] {case}: " + ", ".join(
            f"{n} {r:.3g} (control {c:.3g})" for n, (r, c) in errs.items()))
        bad = [n for n, (r, c) in errs.items() if not r <= ROW_TOL < c]
        if bad:
            raise AssertionError(f"{bad} fail the bar at {case}: {errs}")


def events_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms a call of fn() over iters calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_shape(fns: dict, gen, shape, rounds: int, iters: int) -> dict:
    B, H, Hkv, S, D = shape
    q, k, v = inputs(gen, B, H, Hkv, S, S, D)
    order = (list(fns) + list(fns)[::-1]) * rounds
    ms = {name: [] for name in fns}
    for name in order:
        ms[name].append(events_ms(lambda: call(fns[name], q, k, v, True),
                                  iters))
    sdpa = events_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=H != Hkv), iters)
    bound = 1e3 * 4.0 * D * H * B * S * (S + 1) / 2 / BF16_FLOPS_PER_S
    return {"shape": list(shape), "ms": ms, "sdpa_ms": sdpa,
            "bound_ms": bound}


def main(argv=None, log=print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+",
                    help="flash_attention.cu variants; '-' = checked-in")
    ap.add_argument("--shapes", default=SHAPES,
                    help="B,H,Hkv,S,D;... timed causal in bf16")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("flash_variants: no CUDA device; the variants "
                           "run on the card")
    srcs = {}
    for i, s in enumerate(args.sources):
        path = _build.CSRC / "flash_attention.cu" if s == "-" else Path(s)
        srcs[f"{i}-{'checked-in' if s == '-' else path.stem}"] = path
    with ThreadPoolExecutor(len(srcs)) as ex:
        built = dict(zip(srcs, ex.map(build, srcs.values(), srcs)))
    for name, (_, lines) in built.items():
        log(f"[build {name}] {srcs[name]}")
        for ln in lines:
            log(f"  {ln}")
    fns = {name: load(path) for name, (path, _) in built.items()}
    smi = power_limit_line()
    log(f"[device] {smi}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    check_edges(fns, gen, log)
    rows = []
    for spec in args.shapes.split(";"):
        row = time_shape(fns, gen, tuple(int(x) for x in spec.split(",")),
                         args.rounds, args.iters)
        rows.append(row)
        best = max(row["bound_ms"] / min(v) for v in row["ms"].values())
        log(f"[time] {tuple(row['shape'])} bf16 causal: " + ", ".join(
            f"{n} {' '.join(f'{x:.4f}' for x in v)} ms"
            for n, v in row["ms"].items()) +
            f"; SDPA {row['sdpa_ms']:.4f} ms; bound {row['bound_ms']:.4f} "
            f"ms (the best variant at {best:.1%} of it)")
    res = {"device": smi, "sources": {n: str(p) for n, p in srcs.items()},
           "rows": rows}
    log(json.dumps(res))
    return res


if __name__ == "__main__":
    try:
        main()
    except (RuntimeError, AssertionError) as e:
        print(e, file=sys.stderr)
        sys.exit(1)
