"""repro_torch.launch.dryrun: the per-slot bytes it reckons equal what
``distributed.sharding.device_put`` places on CPU meshes; the transfers it
reckons for ``lm_train_step_sharded`` equal the bytes the step's copies
move in one CPU step; its FLOPs on ``meta`` equal the analytic count at
smoke width within 5 %; every cell of every arch on the production mesh
ends ``ok`` or ``skipped``, on ``meta`` only; and its CLI writes its
records where it is told, never into ``benchmarks/``.

The bytes and transfers are exact (tolerance 0); the FLOP bar is 5 %, the
count's share that ops without a formula (elementwise work) may take.
"""
import dataclasses
import json
import os

import pytest
import torch

from repro_torch.configs import ShapeCell, all_archs, get_arch
from repro_torch.configs.gnn_shapes import cfg_for_cell
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (AbstractMesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models import din as DIN
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import leaves

# one intra-op thread: the suite runs its workers on shared cores
torch.set_num_threads(1)

DM = ("data", "model")
# the LM cells at a 64-token sequence: the bytes do not depend on it, and
# the smoke configs' 32-token attention chunks would make the meta step
# walk 128 chunks a layer at train_4k's 4,096
SHORT = {"train_4k": ShapeCell("train_4k", "train",
                               {"seq_len": 64, "global_batch": 256}),
         "prefill_32k": ShapeCell("prefill_32k", "prefill",
                                  {"seq_len": 64, "global_batch": 32})}
CELLS = (("minicpm-2b", "train_4k"), ("minicpm-2b", "prefill_32k"),
         ("deepseek-v2-lite-16b", "train_4k"), ("din", "train_batch"),
         ("din", "retrieval_cand"), ("gin-tu", "full_graph_sm"))


def smoke_cell(arch, shape):
    spec = D.config_spec(get_arch(arch), smoke=True)
    return spec, SHORT.get(shape) if spec.family == "lm" else \
        spec.shape(shape)


def slot_bytes(tree, slot):
    return sum(x.shards[slot].numel() * x.shards[slot].element_size()
               for x in leaves(tree))


def placed(arch, shape, mesh):
    """Each kind of the step's arguments placed on ``mesh`` for real (the
    smoke config's weights, the cell's batch as zeros), by the sharding
    module: {kind: the tree of sharded tensors}."""
    spec, cell = smoke_cell(arch, shape)
    dp = SH.data_axes(mesh)
    if spec.family == "gnn":
        cfg = cfg_for_cell(spec, cell)
        params = S._GNN[arch].init_params(cfg, device="cpu")
        rules = SH.gnn_rules(mesh)
    elif spec.family == "recsys":
        cfg = spec.make_config()
        params = DIN.init_params(cfg, device="cpu")
        rules = SH.din_rules(mesh)
    else:
        cfg = spec.make_config()
        params = T.init_params(cfg, device="cpu")
        rules = SH.lm_param_rules(mesh, moe=cfg.moe is not None)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in spec.input_specs(cfg, cell)["batch"].items()}
    if spec.family == "gnn":
        tmpl = SH.gnn_batch_specs(mesh, False)
        b_spec = {k: SH.safe_spec(v.shape, list(tmpl.get(k, SH.P())), mesh)
                  for k, v in batch.items()}
    elif cell.kind == "retrieval":
        b_spec = {k: SH.safe_spec(v.shape, [tuple(mesh.axis_names)]
                                  if k.startswith("cand") else [], mesh)
                  for k, v in batch.items()}
    elif spec.family == "recsys":
        b_spec = {k: SH.safe_spec(v.shape, [dp], mesh)
                  for k, v in batch.items()}
    else:
        b_spec = {k: SH.safe_spec(v.shape, [dp, None], mesh)
                  for k, v in batch.items()}
    p = SH.device_put(params, SH.shard_tree(
        SH.tree_specs(params, rules, mesh), mesh))
    out = {"params": p, "batch": SH.device_put(batch, SH.shard_tree(
        b_spec, mesh))}
    if cell.kind == "train":
        out["opt_state"] = S.init_sharded_state(p)
    return out


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=str)
@pytest.mark.parametrize("arch,cell", CELLS)
def test_slot_bytes_equal_device_put(arch, cell, shape):
    mesh = make_mesh(shape, DM, "cpu")
    spec, c = smoke_cell(arch, cell)
    rec = D.cell_record(spec, c, mesh, str(shape))
    assert rec["status"] == "ok"
    want = rec["memory"]["argument_bytes_by_kind"]
    for kind, tree in placed(arch, cell, mesh).items():
        got = {slot_bytes(tree, i) for i in range(mesh.size)}
        assert got == {want[kind]}, (kind, got, want[kind])
    assert rec["memory"]["argument_bytes"] == sum(want.values())


def test_transfers_equal_the_sharded_steps_copies(monkeypatch):
    """One CPU step of ``lm_train_step_sharded`` on (2, 2): the bytes its
    gathers, its gradient reduction and its gradient scatter move between
    slots, counted at the sharding module's and the step's copies."""
    mesh = make_mesh((2, 2), DM, "cpu")
    cfg = get_arch("minicpm-2b").make_smoke_config()
    params = T.init_params(cfg, device="cpu")
    p_sh, _ = S.lm_state_shardings(params, cfg, mesh)
    sp = SH.device_put(params, p_sh)
    state = S.init_sharded_state(sp)
    firsts = [i for i in range(mesh.size) if mesh.coords(i)["model"] == 0]
    moved = {"param_gather": 0, "grad_reduce": 0, "grad_scatter": 0}
    gather, vg, apply = SH.gather, S.value_and_grad, adamw.apply_updates
    calls = {"gather": 0, "vg": 0, "apply": 0}

    def counting_gather(tree, device):
        dest = firsts[calls["gather"]]
        calls["gather"] += 1
        for x in leaves(tree):
            seen = set()
            for i, shard in enumerate(x.shards):
                key = tuple((s.start, s.stop) for s in x.index(i))
                if key not in seen:
                    seen.add(key)
                    if i != dest:
                        moved["param_gather"] += \
                            shard.numel() * shard.element_size()
        return gather(tree, device)

    def counting_vg(*args):
        loss, grads = vg(*args)
        if firsts[calls["vg"]] != 0:
            moved["grad_reduce"] += sum(g.numel() * g.element_size()
                                        for g in grads)
        calls["vg"] += 1
        return loss, grads

    def counting_apply(params, grads, *args, **kw):
        if calls["apply"] != 0:
            moved["grad_scatter"] += sum(g.numel() * g.element_size()
                                         for g in grads)
        calls["apply"] += 1
        return apply(params, grads, *args, **kw)

    monkeypatch.setattr(SH, "gather", counting_gather)
    monkeypatch.setattr(S, "value_and_grad", counting_vg)
    monkeypatch.setattr(adamw, "apply_updates", counting_apply)
    gen = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (2, 16), generator=gen,
                        dtype=torch.int32)
    S.lm_train_step_sharded(sp, state, {"tokens": tok, "labels": tok}, cfg,
                            adamw.AdamWConfig())
    assert calls == {"gather": 2, "vg": 2, "apply": 4}
    p_spec = SH.tree_specs(params, SH.lm_param_rules(mesh, moe=False), mesh)
    want = D.lm_train_transfers(T.init_params(cfg, device="meta"), p_spec,
                                AbstractMesh((2, 2), DM))
    assert moved == want and all(v > 0 for v in want.values())


def test_flops_on_meta_match_the_analytic_count():
    spec = D.config_spec(get_arch("minicpm-2b"), smoke=True)
    cfg = spec.make_config()
    cell = ShapeCell("train_256", "train", {"seq_len": 256,
                                            "global_batch": 4})
    rec = D.cell_record(spec, cell, AbstractMesh((2, 1), DM), "2x1")
    cost = rec["cost"]
    tokens = 4 * 256
    want = D.lm_train_flops_per_token(cfg, 256)
    assert abs(cost["model_flops"] / tokens / want - 1) < 0.05
    assert cost["flops_total"] == 2 * cost["flops"]
    assert cost["recompute_flops"] == 0          # the smoke config: no remat
    remat = dataclasses.replace(spec, make_config=lambda: dataclasses.replace(
        cfg, remat=True))
    again = D.cell_record(remat, cell, AbstractMesh((2, 1), DM), "2x1")
    assert again["cost"]["model_flops"] == cost["model_flops"]
    assert again["cost"]["recompute_flops"] > 0
    assert again["cost"]["flops_total"] == cost["flops_total"] + \
        again["cost"]["recompute_flops"]
    # recomputing the layers keeps fewer activations alive
    assert 0 < again["memory"]["temp_bytes"] < rec["memory"]["temp_bytes"]


def test_every_cell_ends_ok_or_skipped_on_meta():
    """Every arch's every cell on ``make_production_mesh()``, its layers cut
    to one: nothing is drawn or allocated (``meta``)."""
    mesh = make_production_mesh()
    statuses = {}
    for arch, spec in sorted(all_archs().items()):
        for cell in spec.shapes:
            rec = D.run_cell(arch, cell.name, False, depth=1)
            statuses[(arch, cell.name)] = rec["status"]
            assert rec["n_devices" if rec["status"] == "ok" else
                       "skip_reason"], rec
            if rec["status"] == "ok" and spec.family != "core":
                assert rec["cost"]["flops"] > 0
                assert rec["memory"]["argument_bytes"] > 0
    assert set(statuses.values()) == {"ok", "skipped"}
    assert [k for k, v in statuses.items() if v == "skipped"] == [
        (a, "long_500k") for a, s in sorted(all_archs().items())
        if s.family == "lm"]
    assert mesh.size == 256


def test_config_spec_cuts_depth_and_takes_the_smoke_config():
    dime = get_arch("dimenet")
    assert D.config_spec(dime) is dime
    assert D.config_spec(dime, depth=2).make_config().n_blocks == 2
    smoke = D.config_spec(dime, smoke=True, depth=1).make_config()
    assert smoke == dataclasses.replace(dime.make_smoke_config(), n_blocks=1)
    rec = D.run_cell("gin-tu", "molecule", depth=1,
                     mesh=AbstractMesh((2, 2), DM))
    assert rec["mesh"] == "2x2" and rec["depth"] == 1


def test_cli_writes_records_under_out_dir(tmp_path, capsys):
    out = tmp_path / "dry"
    assert D.main(["--arch", "nucleus", "--shape", "orkut_12", "--mesh",
                   "both", "--out-dir", str(out)]) == 0
    names = sorted(os.listdir(out))
    assert names == ["nucleus--orkut_12--pod16x16.json",
                     "nucleus--orkut_12--pod2x16x16.json"]
    rec = json.loads((out / names[1]).read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 512
    assert rec["memory"]["temp_bytes"] is None and rec["temp_bytes_reason"]
    d = get_arch("nucleus").shape("orkut_12").dims
    assert rec["memory"]["argument_bytes"] == \
        4 * (-(-d["n_s"] // 512) * d["C"] + d["n_r"])
    assert rec["collectives"]["round_exchange"] == \
        512 * rec["rounds_bound"] * d["n_r"] * 4
    assert D.main(["--arch", "nucleus", "--shape", "orkut_12",
                   "--out-dir", str(out)]) == 0
    assert "SKIP (cached)" in capsys.readouterr().out
    assert "benchmarks" not in os.path.normpath(D.ARTIFACT_DIR).split(
        os.sep)
