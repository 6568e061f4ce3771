"""LM training of the port (``loss_fn`` and its gradient, the train steps,
AdamW, checkpoints, the token stream, the runtime guards, ``train_lm``)
against the reference, on the CPU.

The same numpy inputs go through both: parameters at the reference's
shapes and scales (``test_torch_transformer.j_params``) carried across by
``params_from_reference``, the optimizer state by
``opt_state_from_reference``.  The reference's loss, gradient and steps
are jitted once per config and shape.  Everything is float32 at smoke
widths unless a test says otherwise; tolerances are stated per test.
"""
import dataclasses
import os
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_arch as j_get_arch
from repro.data import (RecsysStream as JRecsysStream,
                        RecsysStreamConfig as JRecsysStreamConfig,
                        TokenStream as JTokenStream,
                        TokenStreamConfig as JTokenStreamConfig)
from repro.distributed import ElasticPlan as JElasticPlan
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import (RecsysStream, RecsysStreamConfig, TokenStream,
                              TokenStreamConfig)
from repro_torch.distributed import (ElasticPlan, PreemptionGuard,
                                     StragglerMonitor)
from repro_torch.kernels import launch_counts
from repro_torch.launch import steps as S
from repro_torch.launch.train import train_lm
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.tree import flatten_with_paths, unflatten
from test_torch_transformer import _port_config as port_config
from test_torch_transformer import j_params, t

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

ARCHS = ("minicpm-2b", "deepseek-v2-lite-16b")   # dense MHA; MoE + MLA
B, SEQ = 2, 40      # 40 > the smoke configs' attn_chunk 32: a ragged chunk
OPT = JA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)

# the reference's functions compiled once per config and shape
j_value_and_grad = jax.jit(jax.value_and_grad(JT.loss_fn), static_argnums=3)
j_train_micro = jax.jit(JS.lm_train_step_microbatched,
                        static_argnums=(3, 4, 5))
j_clip = jax.jit(JA.clip_by_global_norm, static_argnums=1)
j_init_compression = jax.jit(JA.init_compression, static_argnums=1)
j_compress = jax.jit(JA.compress_grads, static_argnums=2)
j_decompress = jax.jit(JA.decompress_grads)


def port_opt(cfg):
    return A.AdamWConfig(**dataclasses.asdict(cfg))


def batch(vocab, seed, rows=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (rows, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def on_torch(b):
    return {k: t(v) for k, v in b.items()}


def np_state(params):
    """The reference's ``init_state`` in numpy (no per-shape compile)."""
    zeros = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), params)
    return JA.AdamWState(step=np.zeros((), np.int32), mu=zeros,
                         nu=jax.tree.map(np.copy, zeros))


def by_path(tree):
    return {k: v for k, v in flatten_with_paths(tree)}


def assert_tree_close(got, want, rtol, atol, what):
    """Leaf for leaf by key path; returns the worst leaf's max relative
    error (|got - want| / max|want|)."""
    g, w = by_path(got), by_path(jax.device_get(want))
    assert sorted(g) == sorted(w), what
    worst = (-1.0, "")
    for k, a in w.items():
        a = np.asarray(a, np.float32)
        b = g[k].detach().float().numpy()
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")
        err = float(np.abs(b - a).max() / max(np.abs(a).max(), 1e-30))
        worst = max(worst, (err, k))
    return worst


def pair(arch, **kw):
    jc = dataclasses.replace(j_get_arch(arch).make_smoke_config(), **kw)
    tc = port_config(jc)
    jp = j_params(jc)
    return jc, tc, jp, T.params_from_reference(jp, tc, device="cpu")


# ---------------------------------------------------------------------------
# loss and gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_reference(arch):
    """``loss_fn`` equals the reference's to rtol 1e-5 and every gradient
    leaf ``jax.grad``'s to rtol 1e-4, atol 1e-6, with attention's
    projections among them (the training route's scan is differentiable
    on the CPU as on the card; no flash launch).  ``remat=True`` gives
    the same gradients bit for bit."""
    jc, tc, jp, tp = pair(arch)
    b = batch(tc.vocab, 1)
    jl, jg = j_value_and_grad(jp, jnp.asarray(b["tokens"]),
                              jnp.asarray(b["labels"]), jc)
    before = dict(launch_counts)
    loss, grads = S.value_and_grad(T.loss_fn, tp, t(b["tokens"]),
                                   t(b["labels"]), tc)
    assert dict(launch_counts) == before
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    got = unflatten(tp, grads)
    worst = assert_tree_close(got, jg, 1e-4, 1e-6, f"{arch} grad")
    print(f"{arch}: worst gradient leaf {worst[1]} max rel err "
          f"{worst[0]:.3g}")
    for name in (("wq", "w_dkv", "w_uk", "w_uv") if tc.mla else
                 ("wq", "wk", "wv")):
        assert float(got["layers"][name].abs().max()) > 0, name
    _, remat = S.value_and_grad(T.loss_fn, tp, t(b["tokens"]),
                                t(b["labels"]),
                                dataclasses.replace(tc, remat=True))
    assert all(torch.equal(a, c) for a, c in zip(grads, remat))


def test_value_and_grad_leaves_params_untouched():
    """The step differentiates detached views: the caller's leaves get no
    ``requires_grad`` and no ``.grad``."""
    _, tc, _, tp = pair("minicpm-2b")
    S.value_and_grad(T.loss_fn, tp, *on_torch(batch(tc.vocab, 2)).values(),
                     tc)
    for _, p in flatten_with_paths(tp):
        assert not p.requires_grad and p.grad is None


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

EPS_REGIME = 1e-5   # sqrt(nu_hat) below 1000·eps: Adam's eps regime
j_apply = jax.jit(JA.apply_updates, static_argnums=3)


def j_train_step(params, opt_state, b, cfg, opt_cfg):
    """The reference's ``lm_train_step``, run as its two jitted halves
    (``value_and_grad(loss_fn)``, then ``apply_updates``), which the other
    tests of this file compile at the same shapes."""
    loss, grads = j_value_and_grad(params, b["tokens"], b["labels"], cfg)
    params, opt_state, metrics = j_apply(params, grads, opt_state, opt_cfg)
    return params, opt_state, {"loss": loss, **metrics}


def assert_step_close(got, want, what):
    """One train step's (params, opt_state, metrics) against the
    reference's.  Loss, grad_norm and lr to rtol 1e-5; mu and nu (linear
    in the gradient) to rtol 1e-5, atol 1e-7 and 1e-10 (a tenth of the
    gradient test's atol, and its square's scale).  Params to rtol 1e-5
    and atol lr/1000: Adam divides the step by sqrt(nu_hat) + eps, so a
    gradient's f32 rounding moves it by lr·dg/sqrt(nu_hat) (measured at
    the second step: 5e-7 at lr 1e-2).  In Adam's eps regime
    (sqrt(nu_hat) < 1e-5) that reaches a few percent of a step (5e-9 in a
    2.4e-8 gradient moved an element by 1.9e-4 at lr 5e-3), so there the
    bar is one step, |dp| <= lr.  ``test_adamw_updates_match_reference``
    holds the optimizer itself to rtol 1e-5 on equal gradients."""
    (tp, ts, tm), (jp, js, jm) = got, want
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=f"{what} {k}")
    assert int(ts.step) == int(js.step)
    assert_tree_close(ts.mu, js.mu, 1e-5, 1e-7, f"{what} mu")
    assert_tree_close(ts.nu, js.nu, 1e-5, 1e-10, f"{what} nu")
    lr, bc2 = float(jm["lr"]), 1 - OPT.b2 ** int(js.step)
    nu = by_path(jax.device_get(js.nu))
    for k, w in by_path(jax.device_get(jp)).items():
        w = np.asarray(w, np.float32)
        g = by_path(tp)[k].float().numpy()
        regime = np.sqrt(np.asarray(nu[k]) / bc2) < EPS_REGIME
        np.testing.assert_allclose(g[~regime], w[~regime], rtol=1e-5,
                                   atol=lr / 1000, err_msg=f"{what} {k}")
        assert np.abs(g[regime] - w[regime]).max(initial=0) <= lr, k


def test_adamw_updates_match_reference():
    """``apply_updates`` fed the reference's gradients for three steps in a
    row (warmup then cosine, clipping on): params, mu, nu, grad_norm and
    lr to rtol 1e-5, atol 1e-7, each side carrying its own state."""
    jc, tc, jp, tp = pair("minicpm-2b")
    js = np_state(jp)
    ts = T.opt_state_from_reference(js, tp)
    for step in range(3):
        b = batch(tc.vocab, 1)       # the gradient test's shapes: one compile
        _, jg = j_value_and_grad(jp, jnp.asarray(b["tokens"]),
                                 jnp.asarray(b["labels"]), jc)
        grads = jax.tree.map(lambda g: torch.from_numpy(np.array(g)), jg)
        tp, ts, tm = A.apply_updates(tp, grads, ts, port_opt(OPT))
        jp, js, jm = j_apply(jp, jg, js, OPT)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
        assert int(ts.step) == step + 1
        for name, a, w in (("params", tp, jp), ("mu", ts.mu, js.mu),
                           ("nu", ts.nu, js.nu)):
            assert_tree_close(a, w, 1e-5, 1e-7, f"step {step} {name}")


def test_three_train_steps_match_reference():
    """Three ``lm_train_step``s in a row (warmup then cosine, clipping
    on).  Each step, from the reference's state, gives the reference's
    params, mu, nu, loss, grad_norm and lr (``assert_step_close``); the
    port's own three-step run keeps the reference's losses to rtol 1e-5."""
    jc, tc, jp, tp = pair("minicpm-2b")
    js = np_state(jp)
    free, free_state = tp, T.opt_state_from_reference(js, tp)
    for step in range(3):
        b = batch(tc.vocab, 10 + step)    # the gradient test's shapes
        tp = T.params_from_reference(jax.device_get(jp), tc, device="cpu")
        got = S.lm_train_step(tp, T.opt_state_from_reference(
            jax.device_get(js), tp), on_torch(b), tc, port_opt(OPT))
        jp, js, jm = j_train_step(jp, js, jax.tree.map(jnp.asarray, b), jc,
                                  OPT)
        assert_step_close(got, (jp, js, jm), f"step {step}")
        free, free_state, fm = S.lm_train_step(free, free_state, on_torch(b),
                                               tc, port_opt(OPT))
        np.testing.assert_allclose(float(fm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)


def test_microbatched_step_matches_reference_and_full_batch():
    """``lm_train_step_microbatched(n_micro=2)`` equals the reference's
    (``assert_step_close``), and its gradient, read from mu after one step
    (mu = 0.1·g), equals the full batch's within float32 rounding."""
    jc, tc, jp, tp = pair("minicpm-2b")
    b = batch(tc.vocab, 20, rows=4)
    js = np_state(jp)
    want = j_train_micro(jp, js, jax.tree.map(jnp.asarray, b), jc, OPT, 2)
    got = S.lm_train_step_microbatched(
        tp, T.opt_state_from_reference(js, tp), on_torch(b), tc,
        port_opt(OPT), 2)
    assert_step_close(got, want, "micro")
    full = T.params_from_reference(jp, tc, device="cpu")
    _, fs, fm = S.lm_train_step(full, T.opt_state_from_reference(js, full),
                                on_torch(b), tc, port_opt(OPT))
    np.testing.assert_allclose(float(got[2]["loss"]), float(fm["loss"]),
                               rtol=1e-6)
    for k, a in by_path(fs.mu).items():
        torch.testing.assert_close(by_path(got[1].mu)[k], a, rtol=1e-5,
                                   atol=1e-9, msg=k)


# ---------------------------------------------------------------------------
# AdamW parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sched", ["constant", "cosine", "wsd"])
def test_schedule_lr_matches_reference(sched):
    cfg = JA.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100,
                         schedule=sched, min_lr_frac=0.1)
    for s in (0, 1, 10, 55, 91, 100):
        got = A.schedule_lr(port_opt(cfg), torch.tensor(s, dtype=torch.int32))
        want = JA.schedule_lr(cfg, jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-12, err_msg=str(s))
    with pytest.raises(ValueError):
        A.schedule_lr(A.AdamWConfig(schedule="linear"), 1)


def test_clip_and_compression_match_reference():
    """``clip_by_global_norm`` (a bf16 leaf scaled in bf16), and
    ``compress_grads``/``decompress_grads`` fed the reference's right
    factors: equal ``approx`` and error feedback (P and Q themselves may
    differ by QR's column signs).  ``init_compression`` draws a (n, rank)
    factor per matrix leaf and none for 1-D."""
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((12, 3, 4)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32) * 5,
         "c": rng.standard_normal((6, 5)).astype(ml_dtypes.bfloat16)}
    tg = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
          g.items()}
    tg["c"] = tg["c"].to(torch.bfloat16)
    jg = jax.tree.map(jnp.asarray, g)
    got, gn = A.clip_by_global_norm(tg, 1.0)
    want, wn = j_clip(jg, 1.0)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    assert got["c"].dtype == torch.bfloat16
    assert_tree_close(got, want, 1e-6, 1e-7, "clipped")

    g32 = {k: g[k] for k in ("a", "b")}
    jstate = j_init_compression(g32, 2, jax.random.PRNGKey(0))
    tstate = A.init_compression({k: t(v) for k, v in g32.items()}, 2,
                                torch.Generator().manual_seed(0))
    assert tstate.q["b"] is None and tuple(tstate.q["a"].shape) == (12, 2)
    tstate = A.CompressionState(
        error=tstate.error,
        q={"a": t(np.asarray(jstate.q["a"])), "b": None})
    for _ in range(2):       # the second round starts from the feedback
        jpay, jstate = j_compress(g32, jstate, 2)
        tpay, tstate = A.compress_grads({k: t(v) for k, v in g32.items()},
                                        tstate, 2)
        assert isinstance(tpay["a"], tuple)
        assert_tree_close(A.decompress_grads(tpay, {k: t(v) for k, v in
                                                    g32.items()}),
                          j_decompress(jpay, g32), 1e-4, 1e-5,
                          "approx")
        assert_tree_close(tstate.error, jstate.error, 1e-4, 1e-5, "error")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_state(dtype):
    jc, tc, jp, tp = pair("minicpm-2b", dtype=dtype)
    js = np_state(jp)
    js = js._replace(step=np.asarray(7, np.int32),
                     mu=jax.tree.map(lambda a: a + 0.5, js.mu))
    return jp, js, (tp, T.opt_state_from_reference(js, tp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_files_are_the_references(tmp_path, dtype):
    """For the same (params, opt_state) the port's ``arrays.npz`` holds the
    reference's keys in its order, every member byte for byte (bf16 as
    '<V2' words), and the same ``meta.json``.  The port restores either
    file exactly; the reference restores the port's float32 file, and
    fails on its own bf16 file (``No cast function available``)."""
    jp, js, state = _ckpt_state(getattr(jnp, dtype))
    JCheckpointManager(str(tmp_path / "ref")).save(
        3, (jp, js), extra={"data_step": 3}, blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(
        3, state, extra={"data_step": 3}, blocking=True)
    files = {}
    for side in ("ref", "port"):
        d = tmp_path / side / "step_3"
        with zipfile.ZipFile(d / "arrays.npz") as z:
            files[side] = [(n, z.read(n)) for n in z.namelist()]
        files[side].append(("meta", (d / "meta.json").read_bytes()))
    assert [n for n, _ in files["port"]] == [n for n, _ in files["ref"]]
    assert "[0]/['layers']/['wq'].npy" in dict(files["ref"])
    assert "[1]/.mu/['layers']/['wq'].npy" in dict(files["ref"])
    assert files["port"] == files["ref"]

    like = jax.tree.map(torch.zeros_like, state)
    got, step, extra = CheckpointManager(str(tmp_path / "ref")).restore(like)
    assert step == 3 and extra == {"data_step": 3}
    for (k, a), (_, b) in zip(flatten_with_paths(got),
                              flatten_with_paths(state)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    jmgr = JCheckpointManager(str(tmp_path / "port"))
    if dtype == "float32":
        back, _, _ = jmgr.restore((jp, js))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves((jp, js))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        with pytest.raises(ValueError, match="No cast function"):
            jmgr.restore((jp, js))


def test_checkpoint_restores_onto_like_dtype_and_rejects_missing(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    mgr.save(1, {"w": x.to(torch.bfloat16)}, blocking=True)
    got, _, _ = mgr.restore({"w": torch.zeros(2, 3)})
    assert got["w"].dtype == torch.float32 and torch.equal(got["w"], x)
    with pytest.raises(KeyError, match="missing"):
        mgr.restore({"w": x, "v": x})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"w": x})


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 4), generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.float32)},
            "step": torch.tensor(seed)}


def test_checkpoint_async_retention_atomicity(tmp_path):
    """tests/test_substrate.py's cases: async saves keep the newest
    ``keep``, a leftover ``.tmp`` is never a checkpoint, and a save is
    not touched by in-place updates made right after it."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    s = _state(1)
    for k in [1, 2, 3, 4]:
        saved = s["w"].clone()
        mgr.save(k, s)            # async
        s["w"].add_(1.0)          # after the host copy: not in step k
    mgr.wait()
    assert sorted(mgr.all_steps()) == [3, 4]
    got, step, _ = mgr.restore(_state(0))
    assert step == 4 and torch.equal(got["w"], saved)
    os.makedirs(str(tmp_path / "step_9.tmp"))   # a crash mid-write
    assert mgr.latest_step() == 4


# ---------------------------------------------------------------------------
# data and runtime
# ---------------------------------------------------------------------------

def test_streams_match_reference():
    tcfg = dict(vocab=97, seq_len=16, global_batch=4, seed=3)
    rcfg = dict(n_items=6400, n_cates=50, n_users=1000, seq_len=20,
                batch=64, seed=2)
    for step in (0, 7):
        for got, want in (
                (TokenStream(TokenStreamConfig(**tcfg)).batch(step),
                 JTokenStream(JTokenStreamConfig(**tcfg)).batch(step)),
                (RecsysStream(RecsysStreamConfig(**rcfg)).batch(step),
                 JRecsysStream(JRecsysStreamConfig(**rcfg)).batch(step))):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_runtime_guards():
    """tests/test_substrate.py's straggler and preemption cases."""
    mon = StragglerMonitor(slack=3.0, warmup=3)
    for _ in range(6):
        mon.start_step()
        assert mon.end_step() is None
    mon.start_step()
    import time
    time.sleep(0.05)
    ev = mon.end_step()
    assert ev is not None and ev[0] == 6 and ev[1] > 3 * ev[2]
    g = PreemptionGuard(signals=())
    assert not g.should_stop
    g.request_stop()
    assert g.should_stop
    g.restore()


@pytest.mark.parametrize("n_dev,mp,multi_pod", [
    (512, 16, False), (256, 16, False), (128, 16, False), (384, 16, False),
    (512, 16, True), (48, 8, True), (100, 16, False)])
def test_elastic_plan_matches_reference(n_dev, mp, multi_pod):
    try:
        want = JElasticPlan.plan(n_dev, 256, mp, multi_pod)
    except ValueError:
        with pytest.raises(ValueError):
            ElasticPlan.plan(n_dev, 256, mp, multi_pod)
        return
    assert dataclasses.asdict(ElasticPlan.plan(n_dev, 256, mp, multi_pod)) \
        == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_train_lm_resumes_exactly(tmp_path):
    """tests/test_substrate.py::test_train_restore_resumes_exactly on the
    port: 30 steps checkpointed every 15, then a run resumed from step 15
    (the step-30 checkpoint removed) gives the uninterrupted run's losses
    (rtol 1e-4), and the loss falls."""
    import shutil
    run = dict(smoke=True, quiet=True, ckpt_every=15, device="cpu",
               ckpt_dir=str(tmp_path))
    r1 = train_lm("minicpm-2b", steps=30, **run)
    assert r1.steps_done == 30
    assert sorted(os.listdir(tmp_path)) == ["heartbeat.jsonl", "step_15",
                                            "step_30"]
    shutil.rmtree(tmp_path / "step_30")
    r2 = train_lm("minicpm-2b", steps=30, resume=True, **run)
    assert r2.restored_from == 15 and r2.steps_done == 15
    np.testing.assert_allclose(r1.losses[15:], r2.losses, rtol=1e-4)
    assert np.mean(r1.losses[-5:]) < np.mean(r1.losses[:5]) - 0.5


@pytest.mark.parametrize("arch", ["minitron-4b", "stablelm-12b",
                                  "moonshot-v1-16b-a3b",
                                  "deepseek-v2-lite-16b"])
def test_every_lm_arch_trains_at_its_smoke_config(arch):
    """The other LM archs (GQA, head dim 160, MoE, MoE + MLA) take two
    microbatched steps: finite losses, no flash launch."""
    before = dict(launch_counts)
    run = train_lm(arch, steps=2, batch_override=2, seq_override=40,
                   microbatches=2, quiet=True, device="cpu")
    assert run.steps_done == 2 and np.isfinite(run.losses).all()
    assert dict(launch_counts) == before


def test_train_lm_unported_and_non_lm_archs_raise():
    """train_lm trains the LM archs only: din trains with train_din
    (tests/test_torch_din.py); nucleus and the GNN archs are no LM."""
    with pytest.raises(ValueError, match="train_din"):
        train_lm("din", steps=1, device="cpu")
    for arch in ("nucleus", "mace"):
        with pytest.raises(ValueError, match="no LM"):
            train_lm(arch, steps=1, device="cpu")
