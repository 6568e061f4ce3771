"""repro_torch.examples vs the reference's library calls on the same inputs.

Each example runs through its ``main`` on the CPU at a small size, and its
figures are held to what the reference's own functions give there: the
integer ones (cores, rounds, tree sizes, nuclei, the curated edge set)
bit for bit, the densities to float64 rounding.  The reference's example
scripts are not run (``graph_pipeline``'s is imported for its
``make_task``).  The reference's ``decompose`` is fed the port's incidence
arrays, as in ``test_torch_facade.py``, so no XLA program is compiled for
its eager build, and its side of each example is computed once, on a few
threads, while the port's examples run.  The GIN step of
``graph_pipeline`` is held to the reference by
``test_torch_gnn.py::test_gnn_train_step_matches_reference``; here it
runs three steps.  The reference's ``train_lm`` does not run under this
jax (its sharded embedding gather raises ``ShardingTypeError``, the
``shard_map`` class of ``test_substrate.py``), so the ``train_lm``
example is held to that loop's body: the reference's stream, schedule and
jitted step from the port's seeded parameters.
"""
import importlib.util
import os
from concurrent.futures import ThreadPoolExecutor, wait

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_arch as j_get_arch
from repro.data import TokenStream as JTokenStream
from repro.data import TokenStreamConfig as JTokenStreamConfig
from repro.distributed import ElasticPlan as JElasticPlan
from repro.graph import generators as jgen
from repro.graph.container import make_graph as j_make_graph
from repro.launch.train import _lm_train_step_fn
from repro.optim import adamw as JA

from repro_torch.configs import get_arch
from repro_torch.core import build_problem
from repro_torch.examples import (approx_vs_exact, elastic_restart,
                                  graph_pipeline, quickstart, serve_lm,
                                  train_lm)
from repro_torch.graph import generators as tgen
from repro_torch.launch.serve import serve_lm as port_serve_lm
from repro_torch.launch.train import train_lm as port_train_lm
from repro_torch.models import transformer as T
from test_torch_facade import _once
from test_torch_graph import reference_problem

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = (quickstart, approx_vs_exact, graph_pipeline, elastic_restart,
            serve_lm, train_lm)


def densest(nuclei):
    return sorted((nc.density, len(nc.vertices))
                  for nc in nuclei.values())[::-1][:3]


QUICKSTART = (200, [16, 12, 9, 7], 0.02)  # --n 200's planted_cliques
APPROX_N = 300                            # the BA graph's vertices


def reference_quickstart():
    """The reference's figures of quickstart's graph, once: its generator's
    edges, its own build's n_r and n_s, and its ``decompose`` at the pair
    the port's planner resolves on the CPU (the reference's planner has a
    cpu profile entry and the port's none, so their ``auto`` resolutions
    differ)."""
    def run():
        n, sizes, p = QUICKSTART
        jg = jgen.planted_cliques(n, sizes, p, seed=1)
        own = jcore.build_problem(jg, 2, 3)
        g = tgen.planted_cliques(n, sizes, p, seed=1, device="cpu")
        dec = jcore.decompose(
            reference_problem(build_problem(g, 2, 3, device="cpu")),
            jcore.NucleusConfig(r=2, s=3, backend="dense", hierarchy="fused"))
        core = np.asarray(dec.core)
        levels = sorted({1, int(core.max() // 2), int(core.max())})
        return {"edges": np.asarray(jg.edges), "m": jg.m, "n_r": dec.n_r,
                "n_s": dec.problem.n_s, "own_build": (own.n_r, own.n_s),
                "core": core, "rounds": dec.rounds,
                "leaves": dec.tree.n_leaves,
                "internal": dec.tree.n_internal,
                "nuclei": {c: (len(dec.nuclei(c)), densest(dec.nuclei(c)))
                           for c in levels}}
    return _once(("examples", "quickstart"), run)


def reference_approx():
    """The reference's exact and approx (delta 0.5) peels of
    approx_vs_exact's graph, once.  Its gather loop compiles its ops anew
    every round (~30 s here); its dense engine peels the same rounds to
    the same cores, and the port's gather loop is held to the reference's
    by test_torch_facade.py on the goldens."""
    def run():
        pp = build_problem(tgen.barabasi_albert(APPROX_N, 8, seed=5,
                                                device="cpu"),
                           2, 3, device="cpu")
        jp = reference_problem(pp)
        cfg = jcore.NucleusConfig(r=2, s=3, backend="dense",
                                  hierarchy="none")
        exact = jcore.decompose(jp, cfg)
        approx = jcore.decompose(jp, cfg, method="approx", delta=0.5)
        return {"n_r": pp.n_r, "n_s": pp.n_s,
                "exact": (np.asarray(exact.core), exact.rounds),
                "approx": (np.asarray(approx.core), approx.rounds)}
    return _once(("examples", "approx"), run)


def reference_example(name):
    """A module of the reference's examples/, imported (not run)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}",
        os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_curation():
    """The reference's task (its example's ``make_task``) and its
    curation on the port's incidence arrays of that graph, once."""
    def run():
        jg, labels = reference_example("graph_pipeline").make_task()
        g, _ = graph_pipeline.make_task(device="cpu")
        dec = jcore.decompose(
            reference_problem(build_problem(g, 2, 3, device="cpu")),
            jcore.NucleusConfig(r=2, s=3, backend="dense",
                                hierarchy="two_phase"))
        cut_level = max(2, int(np.asarray(dec.core).max()) // 3)
        nuclei = dec.nuclei(cut_level)
        keep = np.zeros(g.n, bool)
        for nc in nuclei.values():
            keep[nc.vertices] = True
        e = np.asarray(jg.edges)
        g_cur = j_make_graph(g.n, e[keep[e[:, 0]] & keep[e[:, 1]]])
        return {"edges": e, "labels": labels, "cut_level": cut_level,
                "n_nuclei": len(nuclei), "keep": keep,
                "curated_edges": np.asarray(g_cur.edges), "m_curated": g_cur.m}
    return _once(("examples", "curation"), run)


TRAIN_STEPS = 2


def reference_train_losses():
    """The reference's ``train_lm`` loop at the example's defaults
    (minicpm-2b smoke, batch 8 x 64, wsd, 2 microbatches) for
    ``TRAIN_STEPS`` steps, once: its ``TokenStream``, its ``AdamWConfig``
    and its jitted microbatched step, from the port's seeded parameters
    (the port cannot draw ``jax.random``'s)."""
    def run():
        jc = j_get_arch("minicpm-2b").make_smoke_config()
        params = jax.tree.map(
            lambda x: jnp.asarray(x.numpy()),
            T.init_params(get_arch("minicpm-2b").make_smoke_config(),
                          device="cpu"))
        opt_cfg = JA.AdamWConfig(lr=1e-3, warmup_steps=20,
                                 total_steps=TRAIN_STEPS, schedule="wsd")
        state = JA.init_state(params)
        step_fn = _lm_train_step_fn(jc, opt_cfg, 2)
        stream = JTokenStream(JTokenStreamConfig(vocab=jc.vocab, seq_len=64,
                                                 global_batch=8))
        losses = []
        for step in range(TRAIN_STEPS):
            params, state, metrics = step_fn(
                params, state, jax.tree.map(jnp.asarray, stream.batch(step)))
            losses.append(float(metrics["loss"]))
        return losses
    return _once(("examples", "train_lm"), run)


@pytest.fixture(autouse=True, scope="module")
def reference_pool():
    """The reference's side of the three decomposing examples and of
    ``train_lm``, computed
    on a few threads from the module's first test on (XLA's compiles
    release the interpreter lock) while the port's examples run; at the
    end, pending work is dropped and running work waited for."""
    with ThreadPoolExecutor(max_workers=3,
                            thread_name_prefix="reference") as pool:
        futures = [pool.submit(f) for f in (reference_curation,
                                            reference_quickstart,
                                            reference_approx,
                                            reference_train_losses)]
        yield
        for f in futures:
            f.cancel()
        wait(futures)


def test_quickstart_matches_reference():
    got = quickstart.main(["--n", str(QUICKSTART[0]), "--device", "cpu"])
    g = tgen.planted_cliques(*QUICKSTART, seed=1, device="cpu")
    want = reference_quickstart()
    np.testing.assert_array_equal(g.edges.numpy(), want["edges"])
    assert (got["backend"], got["hierarchy"]) == ("dense", "fused")
    assert (got["n"], got["m"], got["n_r"], got["n_s"]) == \
        (QUICKSTART[0], want["m"], want["n_r"], want["n_s"])
    assert (got["n_r"], got["n_s"]) == want["own_build"]
    np.testing.assert_array_equal(got["core"], want["core"])
    assert got["core_max"] == int(want["core"].max())
    assert got["core_mean"] == float(want["core"].mean())
    assert got["rounds"] == want["rounds"]
    assert (got["leaves"], got["internal"]) == \
        (want["leaves"], want["internal"])
    assert sorted(got["nuclei"]) == sorted(want["nuclei"])
    for c, (count, dens) in want["nuclei"].items():
        assert got["nuclei"][c]["count"] == count, c
        for (d, k), (wd, wk) in zip(got["nuclei"][c]["densest"], dens,
                                    strict=True):
            assert k == wk and d == pytest.approx(wd, rel=1e-12), c


def test_approx_vs_exact_matches_reference():
    got = approx_vs_exact.main(["--device", "cpu"], n=APPROX_N)
    want = reference_approx()
    assert (got["n_r"], got["n_s"]) == (want["n_r"], want["n_s"])
    for what, run in (("exact", got["exact"]), ("approx", got["approx"][0.5])):
        np.testing.assert_array_equal(run["core"], want[what][0],
                                      err_msg=what)
        assert run["rounds"] == want[what][1], what
    assert sorted(got["approx"]) == [0.1, 0.5, 1.0]


def test_graph_pipeline_curation_matches_reference():
    got = graph_pipeline.main(["--device", "cpu"], steps=3)
    g, labels = graph_pipeline.make_task(device="cpu")
    want = reference_curation()
    np.testing.assert_array_equal(g.edges.numpy(), want["edges"])
    np.testing.assert_array_equal(labels, want["labels"])
    assert (got["cut_level"], got["n_nuclei"]) == \
        (want["cut_level"], want["n_nuclei"])
    np.testing.assert_array_equal(got["keep"], want["keep"])
    assert got["kept"] == int(want["keep"].sum())
    np.testing.assert_array_equal(got["curated_edges"],
                                  want["curated_edges"])
    assert got["m_curated"] == want["m_curated"]
    for acc in (got["acc_raw"], got["acc_curated"]):
        assert 0.0 <= acc <= 1.0


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """The drill preempted at 22 of 24 steps, past the 20 warmup steps
    (checkpoints at 11 and 22)."""
    return elastic_restart.main(
        ["--device", "cpu"], preempt_at=22, total=24, ckpt_every=11,
        tmp_dir=str(tmp_path_factory.mktemp("elastic")))


def test_elastic_restart_resumes_exactly(elastic):
    """The resumed trajectory is the uninterrupted one, bit for bit."""
    assert elastic["drift"] == 0.0
    assert elastic["restored_from"] == 22
    assert len(elastic["run2_losses"]) == 2
    assert len(elastic["ref_losses"]) == 24
    assert len(elastic["run1_losses"]) == 22
    assert sorted(os.listdir(elastic["ckpt_dir"])) == [
        "heartbeat.jsonl", "step_11", "step_22"]
    assert np.isfinite(elastic["ref_losses"]).all()
    for plan, n_devices in zip(elastic["plans"], (512, 384, 256),
                               strict=True):
        want = JElasticPlan.plan(n_devices, global_batch=256,
                                 model_parallel=16)
        assert (plan.mesh_shape, plan.axis_names, plan.per_device_batch,
                plan.global_batch) == (want.mesh_shape, want.axis_names,
                                       want.per_device_batch,
                                       want.global_batch)


def test_reference_drill_leaves_the_schedule_after_warmup(elastic,
                                                          tmp_path):
    """The reference's drill trains a job of ``preempt_at`` steps first
    (examples/elastic_restart.py: ``train_lm(steps=40)``), whose cosine
    schedule is planned over those steps: its losses leave the
    uninterrupted run's once the 20 warmup steps are over, and so does
    the resumed trajectory (ROADMAP, faults of the reference)."""
    kw = dict(smoke=True, quiet=True, device="cpu",
              ckpt_dir=str(tmp_path), ckpt_every=11)
    whole = elastic["ref_losses"]
    first = port_train_lm("minicpm-2b", steps=22, **kw)
    resumed = port_train_lm("minicpm-2b", steps=24, resume=True, **kw)
    assert resumed.restored_from == 22
    assert first.losses[:21] == whole[:21]
    assert first.losses[21] != whole[21]
    drift = np.max(np.abs(np.asarray(whole[22:]) -
                          np.asarray(resumed.losses)))
    assert drift > 1e-4


def test_serve_lm_example_is_the_launcher():
    got = serve_lm.main(["--requests", "2", "--gen-len", "4", "--device",
                         "cpu"])
    want = port_serve_lm("deepseek-v2-lite-16b", n_requests=2, batch_slots=4,
                         prompt_len=8, gen_len=4, smoke=True, quiet=True,
                         device="cpu")
    assert sorted(got["tokens"]) == sorted(want) == [0, 1]
    for i in want:
        np.testing.assert_array_equal(got["tokens"][i], want[i])
    assert got["first"] == want[0][:10].tolist()


def test_train_lm_example_is_the_launcher(tmp_path):
    """The example's losses are the launcher's, and the reference loop's
    on the same parameters and batches (rtol 1e-5, as
    test_torch_train.py's three steps)."""
    got = train_lm.main(["--steps", str(TRAIN_STEPS), "--ckpt-dir",
                         str(tmp_path / "a"), "--device", "cpu"])
    want = port_train_lm("minicpm-2b", steps=TRAIN_STEPS, smoke=True,
                         ckpt_dir=str(tmp_path / "b"), ckpt_every=100,
                         schedule="wsd", microbatches=2, quiet=True,
                         device="cpu")
    assert got["steps_done"] == TRAIN_STEPS
    assert got["losses"] == want.losses
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], reference_train_losses(),
                               rtol=1e-5)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the default device is the card here")
@pytest.mark.parametrize("module", EXAMPLES,
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_examples_raise_without_a_card(module):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        module.main([])
