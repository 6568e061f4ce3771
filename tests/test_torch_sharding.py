"""The sharding rules, the named mesh, the sharded LM train step, the
elastic re-mesh restore and ``setup_platform`` of the port against the
reference, on the CPU.

Specs are compared on device-less meshes (``jax.sharding.AbstractMesh``
on the reference's side, ``launch.mesh.AbstractMesh`` on the port's) at
full-width shapes: ``jax.eval_shape`` of the reference's ``init_params``,
the port's ``init_params`` on the ``meta`` device (no weight is drawn).
The sharded step runs on CPU slots (``make_mesh(shape, names, "cpu")``)
at the smoke configs, from the numpy weights of
``test_torch_transformer.j_params``; the reference's steps are the
jit-once wrappers of ``test_torch_train``.
"""
import os
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

import repro.distributed.sharding as JSH
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_arch as j_get_arch
from repro.models import din as JDIN
from repro.models import dimenet as JDIME
from repro.models import egnn as JEGNN
from repro.models import gin as JGIN
from repro.models import mace as JMACE
from repro.models import transformer as JT
from repro_torch import device as tdevice
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as S
from repro_torch.launch.platform import setup_platform
from repro_torch.launch.train import train_lm
from repro_torch.models import dimenet, din, egnn, gin, mace
from repro_torch.models import transformer as T
from repro_torch.tree import flatten_with_paths, leaves
from test_torch_train import (OPT, assert_step_close, batch, j_train_micro,
                              j_train_step, np_state, on_torch, pair,
                              port_opt)

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

LM_ARCHS = ("minicpm-2b", "minitron-4b", "stablelm-12b",
            "moonshot-v1-16b-a3b", "deepseek-v2-lite-16b")
GNN = {"gin-tu": (gin, JGIN), "egnn": (egnn, JEGNN),
       "dimenet": (dimenet, JDIME), "mace": (mace, JMACE)}
DM = ("data", "model")
MESHES = [((1, 1), DM), ((2, 1), DM), ((4, 2), DM), ((2, 4), DM),
          ((3, 1), DM), ((16, 16), DM), ((2, 16, 16), ("pod",) + DM)]


def meshes(sizes, names):
    return JAbstractMesh(sizes, names), M.AbstractMesh(sizes, names)


def ref_shapes(init, cfg):
    return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))


def same_spec(got, want):
    return tuple(got) == tuple(want)


def template_spec(path, shape, rules, mesh):
    """The reference's ``safe_spec`` of the reference table's entry whose
    pattern fullmatches ``path``, padded as its ``tree_specs`` pads."""
    tmpl = next((t for pat, t in rules.items() if re.fullmatch(pat, path)),
                [])
    tmpl = list(tmpl)[:len(shape)] + [None] * (len(shape) - len(tmpl))
    return JSH.safe_spec(shape, tmpl, mesh)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,names", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_specs_match_reference(sizes, names):
    """Every LM arch at full width (both ``moe_ep_data`` for the MoE
    archs): each leaf's spec is the reference's ``safe_spec`` of the
    table entry that fullmatches its plain path.  din and the four GNN
    archs at full width, ``lm_batch_spec``, ``lm_cache_spec``,
    ``gnn_batch_specs`` and ``din_batch_spec`` equal the reference's
    outright."""
    jm, tm = meshes(sizes, names)
    for arch in LM_ARCHS:
        cfg = get_arch(arch).make_config()
        shapes = T.init_params(cfg, device="meta")
        jshapes = ref_shapes(JT.init_params, j_get_arch(arch).make_config())
        assert [(k, tuple(v.shape)) for k, v in flatten_with_paths(shapes)] \
            == [(k, v.shape) for k, v in flatten_with_paths(jshapes)], arch
        for ep in ((False, True) if cfg.moe else (False,)):
            got = SH.tree_specs(shapes, SH.lm_param_rules(
                tm, moe=cfg.moe is not None, moe_ep_data=ep), tm)
            rules = JSH.lm_param_rules(jm, moe=cfg.moe is not None,
                                       moe_ep_data=ep)
            for (path, leaf), (_, spec) in zip(
                    flatten_with_paths(shapes, plain=True),
                    flatten_with_paths(got)):
                assert isinstance(spec, SH.P)
                want = template_spec(path, tuple(leaf.shape), rules, jm)
                assert same_spec(spec, want), (arch, ep, path, spec, want)
        for mla in (False, True):
            for g, w in zip(SH.lm_cache_spec(tm, cfg.n_kv_heads, mla),
                            JSH.lm_cache_spec(jm, cfg.n_kv_heads, mla)):
                assert same_spec(g, w)
    assert same_spec(SH.lm_batch_spec(tm), JSH.lm_batch_spec(jm))
    assert same_spec(SH.din_batch_spec(tm), JSH.din_batch_spec(jm))
    for nodes in (False, True):
        got, want = SH.gnn_batch_specs(tm, nodes), JSH.gnn_batch_specs(
            jm, nodes)
        assert got.keys() == want.keys()
        assert all(same_spec(got[k], want[k]) for k in want)
    trees = [(din.init_params(get_arch("din").make_config(), device="meta"),
              ref_shapes(JDIN.init_params, j_get_arch("din").make_config()),
              SH.din_rules(tm), JSH.din_rules(jm))]
    for arch, (mod, jmod) in GNN.items():
        trees.append((
            mod.init_params(get_arch(arch).make_config(), device="meta"),
            ref_shapes(jmod.init_params, j_get_arch(arch).make_config()),
            SH.gnn_rules(tm), JSH.gnn_rules(jm)))
    for shapes, jshapes, rules, jrules in trees:
        got = flatten_with_paths(SH.tree_specs(shapes, rules, tm))
        want = flatten_with_paths(JSH.tree_specs(jshapes, jrules, jm))
        assert [k for k, _ in got] == [k for k, _ in want]
        assert all(same_spec(g, w) for (_, g), (_, w) in zip(got, want))


def test_reference_rules_miss_the_layers_and_shadow_unembed():
    """The reference's fault, pinned on its own ``tree_specs``: its keys
    read ``['layers']/['wq']``, so no ``layers/`` rule matches and every
    layer leaf is replicated, and ``embed`` is found inside ``unembed``,
    which gets ``('model', None)``.  The port applies the table as
    written: FSDP x TP on the layers, ``unembed`` on (data, model)."""
    jm, tm = meshes((4, 2), DM)
    for arch in ("minicpm-2b", "moonshot-v1-16b-a3b",
                 "deepseek-v2-lite-16b"):
        jc = j_get_arch(arch).make_smoke_config()
        specs = JSH.tree_specs(ref_shapes(JT.init_params, jc),
                               JSH.lm_param_rules(jm, jc.moe is not None),
                               jm)
        for name, spec in specs["layers"].items():
            assert all(e is None for e in spec), (arch, name, spec)
        assert tuple(specs["unembed"]) == ("model", None)
        got = SH.tree_specs(T.init_params(get_arch(arch).make_smoke_config(),
                                          device="meta"),
                            SH.lm_param_rules(tm, jc.moe is not None), tm)
        assert tuple(got["unembed"]) == ("data", "model")
        assert tuple(got["layers"]["wq"]) == (None, "data", "model")


def test_specs_drop_axes_that_do_not_divide():
    tm = M.AbstractMesh((3, 2), DM)
    assert tuple(SH.safe_spec((6, 5), ["data", "model"], tm)) == \
        ("data", None)
    assert tuple(SH.safe_spec((12,), [("data", "model")], tm)) == \
        (("data", "model"),)
    assert tuple(SH.P(("data",), ())) == ("data", None)
    assert SH.tree_specs({"w": torch.empty(4, 4, device="meta")},
                         {r"w": ["model"]}, tm)["w"] == SH.P("model", None)


# ---------------------------------------------------------------------------
# the named mesh and placement
# ---------------------------------------------------------------------------

def test_named_mesh():
    """Row-major slots; devices repeat in order; a CPU mesh only when
    asked; the production meshes are shapes alone."""
    m = M.make_mesh((2, 3), DM, ["cpu"])
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert m.slots == (torch.device("cpu"),) * 6
    assert [m.coords(i) for i in (0, 1, 3, 5)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 2}]
    assert M.make_mesh((2, 2), DM, "cpu") == M.make_mesh((2, 2), DM,
                                                         ["cpu", "cpu"])
    assert M.make_named_host_mesh(device="cpu").shape == {"data": 1,
                                                          "model": 1}
    assert M.make_production_mesh().shape == {"data": 16, "model": 16}
    assert M.make_production_mesh(multi_pod=True).axis_names == (
        "pod", "data", "model")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            M.make_mesh((2, 2), DM)
        with pytest.raises(RuntimeError, match="CUDA"):
            M.make_named_host_mesh()
    with pytest.raises(ValueError):
        M.AbstractMesh((2, 2), ("data", "data"))
    with pytest.raises(ValueError):
        M.NamedMesh((2,), ("data",), ("cpu",))


@pytest.mark.parametrize("sizes,names", [
    ((2, 2), DM), ((4, 1), DM), ((1, 4), DM), ((1, 1), DM),
    ((2, 2, 2), ("pod",) + DM)])
def test_device_put_gather_round_trip(sizes, names):
    """``gather(device_put(x))`` is x bit for bit, bf16, f32, int and 0-d
    leaves, specs over one axis, two axes and none; each shard is its
    slot's slice; slots sharing a slice hold equal copies, in separate
    storage; a one-slot mesh keeps the tensor itself."""
    mesh = M.make_mesh(sizes, names, "cpu")
    g = torch.Generator().manual_seed(3)
    x = {"a": torch.randn(8, 12, generator=g).to(torch.bfloat16),
         "b": [torch.randn(4, 8, 8, generator=g), torch.tensor(7)],
         "c": torch.arange(16, dtype=torch.int32)}
    data = SH.data_axes(mesh)
    specs = {"a": SH.P("model", data), "b": [SH.P(None, data, "model"),
                                             SH.P()],
             "c": SH.P(tuple(names))}
    put = SH.device_put(x, SH.shard_tree(specs, mesh))
    back = SH.gather(put, "cpu")
    for (k, a), b in zip(flatten_with_paths(x), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8)
                                                  if a.dim() else a,
                                                  b.view(torch.uint8)
                                                  if b.dim() else b), k
    for st, full in zip(leaves(put), leaves(x)):
        assert len(st.shards) == mesh.size
        for i, shard in enumerate(st.shards):
            assert torch.equal(shard, full[st.index(i)])
        ptrs = {s.data_ptr() for s in st.shards if s.numel()}
        if mesh.size == 1:
            assert st.shards[0] is full
        else:
            assert len(ptrs) == mesh.size
    with pytest.raises(ValueError):
        SH.device_put(torch.zeros(3), SH.NamedSharding(
            M.make_mesh((2, 1), DM, "cpu"), SH.P("data")))


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def placed(tp, tc, mesh):
    params = SH.device_put(tp, S.lm_state_shardings(tp, tc, mesh)[0])
    return params, S.init_sharded_state(params)


def port_state(jp, tc, js=None):
    tp = T.params_from_reference(jp, tc, device="cpu")
    return tp, T.opt_state_from_reference(np_state(jp) if js is None else js,
                                          tp)


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v2-lite-16b"])
def test_sharded_step_matches_one_device(arch):
    """The sharded step on (2, 2), (4, 1) and (1, 4) CPU meshes, gathered,
    against both packages' one-device steps fed the same weights and
    batch (``assert_step_close``: loss rtol 1e-5, params atol lr/1000
    outside Adam's eps regime and lr inside it).  The batch splits over
    the data axes, so the step accumulates |data| row groups as
    ``lm_train_step_microbatched`` does, and equals it bit for bit, over
    two steps.  For the dense arch that is the full batch's step within
    rounding; the MoE arch's capacity, and so its drops, is per row group
    (a departure kept on purpose), so its bar there is the reference's
    microbatched step.  Slots holding one slice stay bit-identical."""
    jc, tc, jp, _ = pair(arch)
    b = [batch(tc.vocab, 30 + i, rows=4) for i in range(2)]
    jb = jax.tree.map(jax.numpy.asarray, b[0])
    meshes = ((2, 2), (4, 1), (1, 4))

    def reference(n_data):
        if n_data == 1 or tc.moe is None:
            return j_train_step(jp, np_state(jp), jb, jc, OPT)
        return j_train_micro(jp, np_state(jp), jb, jc, OPT, n_data)
    # the reference's programs compile on threads (XLA releases the
    # interpreter lock) while the port's steps run
    with ThreadPoolExecutor(3) as pool:
        wants = {n: pool.submit(reference, n)
                 for n in sorted({m[0] for m in meshes})}
        for sizes in meshes:
            check_sharded_step(tc, jp, b, sizes, wants[sizes[0]],
                               f"{arch} {sizes}")


def check_sharded_step(tc, jp, b, sizes, want, what):
    """Two sharded steps on a CPU mesh of ``sizes``: the first against the
    reference's step (``want``, a future), both bit for bit against the
    port's one-device step over |data| row groups; replicas equal."""
    n_data = sizes[0]
    params, state = placed(port_state(jp, tc)[0], tc,
                           M.make_mesh(sizes, DM, "cpu"))
    one_p, one_s = port_state(jp, tc)
    for i, bi in enumerate(b):
        params, state, m = S.lm_train_step_sharded(
            params, state, on_torch(bi), tc, port_opt(OPT))
        got = SH.gather((params, state), "cpu")
        if i == 0:
            assert_step_close((got[0], got[1], m), want.result(), what)
        if n_data > 1:
            one_p, one_s, om = S.lm_train_step_microbatched(
                one_p, one_s, on_torch(bi), tc, port_opt(OPT), n_data)
        else:
            one_p, one_s, om = S.lm_train_step(
                one_p, one_s, on_torch(bi), tc, port_opt(OPT))
        assert torch.equal(m["loss"], om["loss"])
        assert all(torch.equal(a, c) for a, c in zip(
            leaves(got), leaves((one_p, one_s))))
    for st in leaves((params, state)):
        by_slice = {}
        for j, shard in enumerate(st.shards):
            key = tuple((x.start, x.stop) for x in st.index(j))
            assert torch.equal(by_slice.setdefault(key, shard), shard)


def test_one_slot_mesh_runs_the_one_device_step():
    """On (1, 1) the shards are the tensors themselves and the step is
    ``lm_train_step`` on them: the same objects, updated in place, equal
    to a plain step bit for bit."""
    _, tc, jp, _ = pair("minicpm-2b")
    tp, _ = port_state(jp, tc)
    params, state = placed(tp, tc, M.make_mesh((1, 1), DM, "cpu"))
    assert all(st.shards[0] is x for st, x in zip(leaves(params),
                                                  leaves(tp)))
    b = on_torch(batch(tc.vocab, 40))
    params, state, m = S.lm_train_step_sharded(params, state, b, tc,
                                               port_opt(OPT))
    one_p, one_s = port_state(jp, tc)
    one_p, one_s, om = S.lm_train_step(one_p, one_s, b, tc, port_opt(OPT))
    assert all(st.shards[0] is x for st, x in zip(leaves(params),
                                                  leaves(tp)))
    assert all(torch.equal(a, c) for a, c in zip(
        leaves(SH.local((params, state), 0)), leaves((one_p, one_s))))
    assert torch.equal(m["loss"], om["loss"])


# ---------------------------------------------------------------------------
# the elastic re-mesh restore and train_lm over a mesh
# ---------------------------------------------------------------------------

def test_reference_checkpoint_restores_onto_any_mesh(tmp_path):
    """A checkpoint the reference wrote restores onto (2, 2) and (1, 4)
    with ``sharding_tree``: every leaf placed by its spec and, gathered,
    the saved array bit for bit.  A (2, 2) save restores onto (4, 1) bit
    for bit."""
    jc, tc, jp, _ = pair("minicpm-2b")
    js = np_state(jp)
    js = js._replace(step=np.asarray(5, np.int32),
                     mu=jax.tree.map(lambda a: a + 0.25, js.mu))
    JCheckpointManager(str(tmp_path / "ref")).save(
        5, (jp, js), extra={"data_step": 5}, blocking=True)
    want = leaves((T.params_from_reference(jp, tc, device="cpu"),
                   T.opt_state_from_reference(js, T.params_from_reference(
                       jp, tc, device="cpu"))))
    states = {}
    for sizes in ((2, 2), (1, 4)):
        mesh = M.make_mesh(sizes, DM, "cpu")
        like = placed(T.init_params(tc, device="cpu"), tc, mesh)
        sh = S.lm_state_shardings(like[0], tc, mesh)
        state, step, extra = CheckpointManager(str(tmp_path / "ref")).restore(
            like, sharding_tree=sh)
        assert step == 5 and extra == {"data_step": 5}
        for st, w, s in zip(leaves(state), want, leaves(sh)):
            assert isinstance(st, SH.ShardedTensor) and st.sharding == s
            assert torch.equal(st.gather("cpu"), w)
        states[sizes] = state
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(6, states[(2, 2)], blocking=True)
    mesh = M.make_mesh((4, 1), DM, "cpu")
    back, _, _ = mgr.restore(like, sharding_tree=S.lm_state_shardings(
        like[0], tc, mesh))
    for st, w in zip(leaves(back), want):
        assert st.mesh == mesh and torch.equal(st.gather("cpu"), w)


def test_train_lm_over_a_mesh_and_resume_elsewhere(tmp_path):
    """``train_lm`` on a (2, 2) CPU mesh (B = 8: four rows a data index)
    gives the losses of a (1, 1) run with two microbatches bit for bit; a
    (2, 2) run saving at step 2 resumes on (1, 4) and on (1, 1), and
    each resumed run's losses equal the uninterrupted (2, 2) run's."""
    kw = dict(steps=4, quiet=True, microbatches=1)
    mesh22 = M.make_mesh((2, 2), DM, "cpu")
    whole = train_lm("minicpm-2b", mesh=mesh22, **kw)
    micro = train_lm("minicpm-2b", mesh=M.make_mesh((1, 1), DM, "cpu"),
                     **{**kw, "microbatches": 2})
    assert whole.losses == micro.losses
    ckpt = str(tmp_path / "ck")
    train_lm("minicpm-2b", mesh=mesh22, ckpt_dir=ckpt, ckpt_every=2,
             **{**kw, "steps": 2})
    for sizes, n_micro in (((1, 4), 1), ((1, 1), 2)):
        resumed = train_lm("minicpm-2b", mesh=M.make_mesh(sizes, DM, "cpu"),
                           ckpt_dir=ckpt, ckpt_every=10 ** 9, resume=True,
                           **{**kw, "microbatches": n_micro})
        assert resumed.restored_from == 2
        np.testing.assert_allclose(resumed.losses, whole.losses[2:],
                                   rtol=1e-6)
    default = train_lm("minicpm-2b", device="cpu", **{**kw, "steps": 1})
    assert default.losses == train_lm(
        "minicpm-2b", mesh=M.make_mesh((1, 1), DM, "cpu"),
        **{**kw, "steps": 1}).losses


# ---------------------------------------------------------------------------
# setup_platform
# ---------------------------------------------------------------------------

@pytest.fixture
def policy(monkeypatch):
    """The device policy restored after the test."""
    monkeypatch.setattr(tdevice, "_platform", None)
    monkeypatch.setattr(tdevice, "_cpu_slots", 1)


def test_setup_platform(policy):
    """The reference's record (every key None when nothing is asked), its
    clamp warning, the CPU platform as the default device, CPU slots for
    a host mesh, and a raise for each knob torch has no counterpart
    for."""
    assert setup_platform() == {"platform": None, "cpu_devices": None,
                                "enable_x64": None, "xla_flags": None}
    with pytest.warns(RuntimeWarning, match="cores"):
        applied = setup_platform(cpu_devices=1_000_000)
    assert applied["cpu_devices"] == (os.cpu_count() or 1)
    applied = setup_platform("cpu", cpu_devices=2)
    assert applied == {"platform": "cpu", "cpu_devices": 2,
                       "enable_x64": None, "xla_flags": None}
    assert tdevice.resolve_device(None) == torch.device("cpu")
    assert M.make_named_host_mesh(model_parallel=2).shape == {
        "data": 1, "model": 2}
    assert len(M.make_host_mesh("cpu")) == 2
    for bad in (dict(enable_x64=True), dict(extra_xla_flags=["--x=1"]),
                dict(platform="tpu"), dict(cpu_devices=0)):
        with pytest.raises(ValueError):
            setup_platform(**bad)
