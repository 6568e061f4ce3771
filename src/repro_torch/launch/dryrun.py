"""The dry run: what every (arch x shape x production mesh) cell costs a
device, before any hardware exists (counterpart of
``repro.launch.dryrun``).

``python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--mesh
single|multi|both] [--tag T] [--list] [--force] [--out-dir D]`` writes one
JSON record a cell under ``--out-dir`` (by default the git-ignored
``build/dryrun/``; never ``benchmarks/artifacts/``, whose records are the
TPU's).  The reference lowers each cell with XLA and reads
``memory_analysis()``, ``cost_analysis()`` and the collectives of the
compiled HLO.  The port has no compiler to ask, so it reckons the same
quantities from its own specs and runs its own steps on ``meta`` tensors,
where nothing is allocated:

  * ``memory.argument_bytes``: one slot's bytes of the step's arguments,
    summed exactly from the ``tree_specs`` shares (each tensor's bytes
    over the product of the mesh axes its spec uses; the rule tables
    applied by fullmatch, as the port applies them) - parameters, AdamW
    moments (float32, placed as their parameters) and the step, the batch
    by its spec, a decode cell's cache.  ``argument_bytes_by_kind`` splits
    it; ``output_bytes`` likewise for the step's results.
  * ``memory.temp_bytes``: the peak of the bytes the step's own ops hold
    alive at once (``StepMeter``, a ``TorchDispatchMode`` that follows each
    storage an op creates until it is freed) less what is still alive at
    the end (the outputs), over one slot's rows: the LM and din steps run
    on the rows of one group of the batch spec, a GNN step on the whole
    graph (the port has no sharded GNN step).  A ``core`` cell records
    null and the reason: its peel is not run here (its rounds depend on
    the data).
  * ``cost``: ``torch.utils.flop_counter``'s formulas over every op of
    that step run on ``meta`` at full width; the layers are a Python
    loop, so every layer counts (the reference's ``_extrapolate_lm_cost``
    works around XLA counting a scan body once and has no counterpart).
    ``flops_total`` is the cell's whole step, ``flops`` its share over the
    row groups the batch spec cuts it into (``row_groups``);
    ``model_flops`` leaves out the forward recomputed by
    ``torch.utils.checkpoint`` in the backward pass.  The flash kernel has no op to count on ``meta``: its causal
    work, 4·D·H·S(S+1)/2 flops a layer and row, is added as
    ``flash_flops``.
  * ``collectives``: the bytes the port's own sharded step moves between
    slots per step, summed over the slots, reckoned from the specs (the
    reference's HLO parser ``collective_bytes`` has no counterpart).  An
    LM train cell moves what ``launch.steps.lm_train_step_sharded`` moves:
    ``param_gather`` (each data index gathers the full parameters onto its
    first slot, each distinct slice from the first slot that holds it),
    ``grad_reduce`` (every other data index's gradients, in the
    parameters' dtypes, onto slot 0, where they add into float32) and
    ``grad_scatter`` (the float32 mean gradient's slices to every other
    slot).  A ``core`` cell moves its slabs (``ceil(n_s / k)`` x C int32
    a slot) and the (n_r,) int32 decrement exchange of
    ``core.distributed`` a slot and round, times the cell's rounds bound.
    The port has no sharded step for the other kinds, so they record none.

Cells with a ``skip_reason`` return ``status: "skipped"``.  ``depth`` cuts
an LM or GNN arch's layers (the tests' sweep); a record says its depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import weakref
from typing import Any, Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..configs import ArchSpec, ShapeCell, all_archs, get_arch
from ..configs.gnn_shapes import cfg_for_cell
from ..configs.din import n_candidates_padded
from ..configs.nucleus import max_rounds_bound
from ..distributed import sharding as SH
from ..models import din as DIN
from ..models import transformer as T
from ..optim import adamw
from ..tree import leaves
from . import steps as S
from .mesh import AbstractMesh, make_production_mesh

ARTIFACT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "..", "..", "build", "dryrun")
INT32 = 4
F32 = 4


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


# ---------------------------------------------------------------------------
# shares of a spec
# ---------------------------------------------------------------------------

def share_bytes(x: torch.Tensor, spec: SH.P, mesh: AbstractMesh) -> int:
    """One slot's bytes of ``x`` placed by ``spec``."""
    return x.numel() * x.element_size() // SH.spec_parts(spec, mesh)


def tree_share_bytes(tree: Any, spec_tree: Any, mesh: AbstractMesh,
                     dtype: Optional[torch.dtype] = None) -> int:
    """One slot's bytes of a tree placed by ``spec_tree`` (each leaf in
    ``dtype`` when given: the float32 moments of a parameter tree)."""
    total = 0
    for x, sp in zip(leaves(tree), leaves(spec_tree)):
        size = x.element_size() if dtype is None else \
            torch.empty((), dtype=dtype).element_size()
        total += x.numel() * size // SH.spec_parts(sp, mesh)
    return total


def lm_train_transfers(params: Any, p_spec: Any,
                       mesh: AbstractMesh) -> Dict[str, int]:
    """Bytes ``lm_train_step_sharded`` moves between slots in one step
    (``n_micro`` = 1), summed over the slots, by kind (module
    docstring)."""
    if mesh.size == 1:
        return {"param_gather": 0, "grad_reduce": 0, "grad_scatter": 0}
    firsts = SH.first_slots(mesh)
    gather = reduce = scatter = 0
    for x, sp in zip(leaves(params), leaves(p_spec)):
        nbytes = x.numel() * x.element_size()
        used = set(SH.spec_axes(sp))
        share = nbytes // SH.spec_parts(sp, mesh)
        for f in firsts:
            c = mesh.coords(f)
            # f is the first holder of its own slice iff it sits at 0 on
            # every axis the spec does not use; then that slice stays
            own = all(c[a] == 0 for a in mesh.axis_names if a not in used)
            gather += nbytes - (share if own else 0)
        reduce += (len(firsts) - 1) * nbytes
        scatter += (mesh.size - 1) * (x.numel() * F32 //
                                      SH.spec_parts(sp, mesh))
    return {"param_gather": gather, "grad_reduce": reduce,
            "grad_scatter": scatter}


# ---------------------------------------------------------------------------
# the meter: live bytes and flops of a step on meta
# ---------------------------------------------------------------------------

class StepMeter(TorchDispatchMode):
    """Counts, over the ops run under it: the flops of every op
    ``torch.utils.flop_counter`` has a formula for (``flops``; of those,
    ``recompute_flops`` ran with grad enabled inside a backward pass: the
    forward ``torch.utils.checkpoint`` recomputes), and the bytes of the
    storages the ops create while they live (``now``, ``peak``).  Tensors
    made before the meter started (arguments) are never counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.recompute_flops = 0
        self.now = 0
        self.peak = 0
        self.end = 0                # bytes alive when the step returned
        self._live: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.now -= self._live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            n = int(fn(*args, **kwargs, out_val=out))
            self.flops += n
            if torch._C._current_graph_task_id() != -1 and \
                    torch.is_grad_enabled():
                self.recompute_flops += n
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st._cdata
                if key not in self._live:
                    self._live[key] = st.nbytes()
                    self.now += st.nbytes()
                    weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.now)
        return out


def _rows(x: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
    return x.narrow(dim, 0, n) if x.shape[dim] != n else x


def _groups(spec: SH.P, mesh: AbstractMesh) -> int:
    """Row groups ``spec`` (a ``safe_spec``) cuts a leading dim into."""
    return SH.spec_parts(SH.P(spec[0]), mesh) if len(spec) else 1


def metered(step) -> StepMeter:
    """``step()`` under a fresh meter; ``meter.end`` is the bytes its ops
    left alive (the outputs)."""
    meter = StepMeter()
    with meter:
        out = step()
    meter.end = meter.now
    del out
    return meter


# ---------------------------------------------------------------------------
# per family
# ---------------------------------------------------------------------------

def _opt_bytes(params, p_spec, mesh) -> int:
    """One slot's AdamW state: float32 moments placed as their params,
    the int32 step on every slot."""
    return 2 * tree_share_bytes(params, p_spec, mesh, torch.float32) + INT32


def _lm_cell(spec: ArchSpec, cell: ShapeCell,
             mesh: AbstractMesh) -> Dict[str, Any]:
    cfg = spec.make_config()
    params = T.init_params(cfg, device="meta")
    p_spec = SH.tree_specs(params, SH.lm_param_rules(
        mesh, moe=cfg.moe is not None), mesh)
    specs = spec.input_specs(cfg, cell)
    dp = SH.data_axes(mesh)
    p_bytes = tree_share_bytes(params, p_spec, mesh)
    args = {"params": p_bytes}
    outs: Dict[str, int] = {}
    coll: Dict[str, int] = {}
    flash = 0
    if cell.kind in ("train", "prefill"):
        batch = specs["batch"]
        B = batch["tokens"].shape[0]
        b_spec = SH.safe_spec(batch["tokens"].shape, [dp, None], mesh)
        groups = _groups(b_spec, mesh)
        rows = {k: _rows(v, B // groups) for k, v in batch.items()}
        args["batch"] = sum(share_bytes(v, b_spec, mesh)
                            for v in batch.values())
        if cell.kind == "train":
            opt = adamw.init_state(params)
            args["opt_state"] = _opt_bytes(params, p_spec, mesh)
            meter = metered(lambda: S.lm_train_step(
                params, opt, rows, cfg, adamw.AdamWConfig()))
            outs = {"params": p_bytes, "opt_state": args["opt_state"],
                    "metrics": 3 * F32}
            coll = lm_train_transfers(params, p_spec, mesh)
        else:
            with torch.no_grad():
                meter = metered(lambda: S.lm_prefill_step(params, rows, cfg))
            n = B // groups
            Sq = batch["tokens"].shape[1]
            flash = cfg.n_layers * 4 * cfg.head_dim * cfg.n_heads * n * \
                Sq * (Sq + 1) // 2
            outs = {"next_tokens": n * 8}
    else:                                           # decode
        tok = specs["tokens"]
        B = tok.shape[0]
        t_spec = SH.safe_spec(tok.shape, [dp, None], mesh)
        c_spec = [SH.safe_spec(c.shape, list(sp), mesh) for c, sp in zip(
            specs["cache"], SH.lm_cache_spec(mesh, cfg.n_kv_heads,
                                             cfg.mla is not None))]
        groups = _groups(t_spec, mesh)
        n = B // groups
        cache = tuple(_rows(c, n, 1) for c in specs["cache"])
        cache_bytes = sum(share_bytes(c, sp, mesh)
                          for c, sp in zip(specs["cache"], c_spec))
        args.update({"tokens": share_bytes(tok, t_spec, mesh),
                     "cache": cache_bytes, "cache_len": INT32})
        last = specs["cache"][0].shape[2] - 1   # the last slot of the cache
        with torch.no_grad():
            meter = metered(lambda: S.lm_decode_step(
                params, _rows(tok, n), cache, last, cfg))
        outs = {"next_tokens": n * 8, "cache": cache_bytes}
    return {"args": args, "outs": outs, "meter": meter, "groups": groups,
            "collectives": coll, "flash_flops": flash,
            "depth": cfg.n_layers}


def _gnn_cell(spec: ArchSpec, cell: ShapeCell,
              mesh: AbstractMesh) -> Dict[str, Any]:
    cfg = cfg_for_cell(spec, cell)
    arch = spec.arch_id
    params = S._GNN[arch].init_params(cfg, device="meta")
    p_spec = SH.tree_specs(params, SH.gnn_rules(mesh), mesh)
    specs = spec.input_specs(cfg, cell)
    batch = specs["batch"]
    b_tmpl = SH.gnn_batch_specs(mesh,
                                cell.dims.get("n_nodes", 0) >= 1_000_000)
    b_spec = {k: SH.safe_spec(v.shape, list(b_tmpl.get(k, SH.P())), mesh)
              for k, v in batch.items()}
    opt = adamw.init_state(params)
    p_bytes = tree_share_bytes(params, p_spec, mesh)
    args = {"params": p_bytes,
            "opt_state": _opt_bytes(params, p_spec, mesh),
            "batch": sum(share_bytes(v, b_spec[k], mesh)
                         for k, v in batch.items())}
    meter = metered(lambda: S.gnn_train_step(
        params, opt, batch, cfg, arch, specs["n_graphs"],
        specs["node_level"], adamw.AdamWConfig()))
    groups = _groups(b_spec["edge_src"], mesh)
    return {"args": args, "meter": meter, "groups": groups,
            "outs": {"params": p_bytes, "opt_state": args["opt_state"],
                     "metrics": 3 * F32},
            "collectives": {}, "flash_flops": 0, "whole": True,
            "depth": getattr(cfg, _depth_field(cfg))}


def _din_cell(spec: ArchSpec, cell: ShapeCell,
              mesh: AbstractMesh) -> Dict[str, Any]:
    cfg = spec.make_config()
    params = DIN.init_params(cfg, device="meta")
    p_spec = SH.tree_specs(params, SH.din_rules(mesh), mesh)
    batch = spec.input_specs(cfg, cell)["batch"]
    p_bytes = tree_share_bytes(params, p_spec, mesh)
    args = {"params": p_bytes}
    if cell.kind == "retrieval":
        all_ax = tuple(mesh.axis_names)
        b_spec = {k: SH.safe_spec(v.shape, [all_ax] if k.startswith("cand")
                                  else [], mesh) for k, v in batch.items()}
        NC = n_candidates_padded(cell)
        groups = _groups(b_spec["cand_items"], mesh)
        rows = {k: _rows(v, NC // groups) if k.startswith("cand") else v
                for k, v in batch.items()}
        with torch.no_grad():
            meter = metered(lambda: S.din_retrieval_step(params, rows, cfg))
        outs = {"scores": NC // groups * F32}
    else:
        dp = SH.data_axes(mesh)
        b_spec = {k: SH.safe_spec(v.shape, [dp], mesh)
                  for k, v in batch.items()}
        B = cell.dims["batch"]
        groups = _groups(b_spec["cand_item"], mesh)
        rows = {k: _rows(v, B // groups) for k, v in batch.items()}
        if cell.kind == "train":
            opt = adamw.init_state(params)
            args["opt_state"] = _opt_bytes(params, p_spec, mesh)
            meter = metered(lambda: S.din_train_step(
                params, opt, rows, cfg, adamw.AdamWConfig()))
            outs = {"params": p_bytes, "opt_state": args["opt_state"],
                    "metrics": 3 * F32}
        else:
            with torch.no_grad():
                meter = metered(lambda: S.din_serve_step(params, rows, cfg))
            outs = {"ctr": B // groups * F32}
    args["batch"] = sum(share_bytes(v, b_spec[k], mesh)
                        for k, v in batch.items())
    return {"args": args, "outs": outs, "meter": meter, "groups": groups,
            "collectives": {}, "flash_flops": 0}


def _core_cell(spec: ArchSpec, cell: ShapeCell,
               mesh: AbstractMesh) -> Dict[str, Any]:
    d = cell.dims
    k = mesh.size
    slab = -(-d["n_s"] // k)
    rounds = max_rounds_bound(spec.make_config(), cell)
    return {
        "args": {"inc_rid": slab * d["C"] * INT32, "deg0": d["n_r"] * INT32},
        "outs": {"core": d["n_r"] * INT32, "order_round": d["n_r"] * INT32},
        "meter": None, "groups": k, "flash_flops": 0,
        "collectives": {"slab": k * slab * d["C"] * INT32,
                        "round_exchange": k * rounds * d["n_r"] * INT32},
        "rounds_bound": rounds,
    }


def _depth_field(cfg) -> Optional[str]:
    """The config's layer count: ``n_layers`` or dimenet's ``n_blocks``."""
    for f in ("n_layers", "n_blocks"):
        if hasattr(cfg, f):
            return f
    return None


def config_spec(spec: ArchSpec, smoke: bool = False,
                depth: Optional[int] = None) -> ArchSpec:
    """``spec`` whose ``make_config`` gives the smoke config (``smoke``,
    the tests) and/or cuts the layers to ``depth`` (an LM or GNN arch)."""
    if not smoke and depth is None:
        return spec
    base = spec.make_smoke_config if smoke else spec.make_config

    def make():
        cfg = base()
        field = _depth_field(cfg) if depth is not None else None
        return dataclasses.replace(cfg, **{field: depth}) if field else cfg
    return dataclasses.replace(spec, make_config=make)


_FAMILY = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _din_cell,
           "core": _core_cell}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
             tag: str = "", *, mesh: Optional[AbstractMesh] = None,
             depth: Optional[int] = None) -> Dict[str, Any]:
    """The record of one cell on ``make_production_mesh(multi_pod=)`` (or
    on ``mesh``, any mesh: a device-less one, or a ``NamedMesh`` whose
    devices are not used); ``depth`` cuts an LM or GNN arch's layers (the
    tests' sweep)."""
    spec = config_spec(get_arch(arch_id), depth=depth)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
        name = mesh_name(multi_pod)
    else:
        name = "x".join(str(n) for n in mesh.axis_sizes)
    return cell_record(spec, spec.shape(shape_name), mesh, name, tag)


def cell_record(spec: ArchSpec, cell: ShapeCell, mesh: AbstractMesh,
                mesh_label: str, tag: str = "") -> Dict[str, Any]:
    """``run_cell``'s record of ``cell`` of ``spec`` on ``mesh``."""
    result: Dict[str, Any] = {"arch": spec.arch_id, "shape": cell.name,
                              "mesh": mesh_label, "kind": cell.kind,
                              "tag": tag}
    if cell.skip_reason:
        result.update(status="skipped", skip_reason=cell.skip_reason)
        return result
    t0 = time.perf_counter()
    r = _FAMILY[spec.family](spec, cell, mesh)
    meter = r["meter"]
    if meter is None:
        temp, cost = None, {"flops": None, "flops_total": None,
                            "model_flops": None}
        result["temp_bytes_reason"] = result["flops_reason"] = (
            "the peel is not run on meta: its rounds and link work depend "
            "on the data")
    else:
        temp = meter.peak - meter.end
        # the meter ran one row group's step (LM, din) or the whole step
        # (GNN: the port has no sharded GNN step)
        times = 1 if r.get("whole") else r["groups"]
        total = (meter.flops + r["flash_flops"]) * times
        recompute = meter.recompute_flops * times
        cost = {"flops": total // r["groups"], "flops_total": total,
                "model_flops": total - recompute,
                "recompute_flops": recompute,
                "flash_flops": r["flash_flops"] * times}
    coll = r["collectives"]
    result.update({
        "status": "ok",
        "seconds": time.perf_counter() - t0,
        "memory": {
            "argument_bytes": sum(r["args"].values()),
            "argument_bytes_by_kind": r["args"],
            "output_bytes": sum(r["outs"].values()),
            "output_bytes_by_kind": r["outs"],
            "temp_bytes": temp,
            "code_bytes": None,
        },
        "cost": cost,
        "row_groups": r["groups"],
        "collectives": coll,
        "collective_bytes_total": int(sum(coll.values())),
        "n_devices": mesh.size,
    })
    if "rounds_bound" in r:
        result["rounds_bound"] = r["rounds_bound"]
    if "depth" in r:
        result["depth"] = r["depth"]
    if not coll:
        result["collectives_note"] = (
            "the port has no sharded step for this kind of cell: nothing "
            "moves between slots")
    return result


def lm_train_flops_per_token(cfg, seq_len: int) -> int:
    """The analytic count of a dense LM arch's train step, per token:
    6 x the parameters a token's products read (all but an untied input
    embedding, which is a gather) plus the online scan's attention,
    12·L·H·D·S (its forward 4·H·D·S a layer over the full S: the scan
    masks future keys, it does not skip them), forward and backward."""
    n = cfg.param_count()
    if not cfg.tie_embeddings:
        n -= cfg.vocab * cfg.d_model
    return 6 * n + 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq_len


def artifact_path(out_dir: str, arch_id: str, shape_name: str,
                  multi_pod: bool, tag: str = "") -> str:
    suffix = f"-{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch_id}--{shape_name}--"
                                 f"{mesh_name(multi_pod)}{suffix}.json")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--tag", default="")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=os.path.normpath(ARTIFACT_DIR))
    args = ap.parse_args(argv)

    if args.list:
        for aid, spec in sorted(all_archs().items()):
            for c in spec.shapes:
                skip = "  [skip]" if c.skip_reason else ""
                print(f"{aid:24s} {c.name:16s} {c.kind}{skip}")
        return 0
    os.makedirs(args.out_dir, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}
    archs = [args.arch] if args.arch else sorted(all_archs())
    failed = 0
    for aid in archs:
        spec = get_arch(aid)
        shapes = [args.shape] if args.shape else [c.name for c in
                                                  spec.shapes]
        for sname in shapes:
            for mp in meshes[args.mesh]:
                path = artifact_path(args.out_dir, aid, sname, mp, args.tag)
                if os.path.exists(path) and not args.force:
                    try:
                        with open(path) as f:
                            prev = json.load(f).get("status")
                    except (OSError, ValueError):
                        prev = None
                    if prev in ("ok", "skipped"):
                        print(f"SKIP (cached) {path}")
                        continue
                print(f"== {aid} x {sname} x {mesh_name(mp)} ==",
                      flush=True)
                try:
                    res = run_cell(aid, sname, mp, args.tag)
                except Exception as e:  # recorded: a failed cell is a record
                    res = {"arch": aid, "shape": sname,
                           "mesh": mesh_name(mp), "status": "error",
                           "error": repr(e)[:2000], "tag": args.tag}
                    failed += 1
                with open(path, "w") as f:
                    json.dump(res, f, indent=2)
                print(json.dumps({k: res.get(k) for k in (
                    "status", "seconds", "collective_bytes_total",
                    "error")}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
