"""The sharded nucleus lane on CPU meshes: ``core.distributed``,
``launch.mesh``, ``configs.nucleus``, the planner with several devices and
sharded ``Session``/``Router`` pools.

The reference's sharded backend does not run under this tree's jax
(ROADMAP preamble), so the sharded peel is held to the port's dense path,
itself bit-identical to the reference (tests/test_torch_facade.py), and to
the 24 golden fixtures:

* on meshes of 1, 2, 3, 4 and 8 CPU slabs, exact and approx, fused and
  none: ``core``, ``rounds``, ``uf_parent``, ``uf_L`` and ``peel_value``
  equal the dense ``decompose``'s, and the exact core and cut partitions
  equal the fixture's;
* ``compress=True`` gives the uncompressed arrays, and on a 70,000-leaf
  star at (1,2) the hub's core 1 after drain steps (the reference's int16
  scheme gives 37,233 or 70,002 there);
* the multi-device path (one engine thread per device, collectives at a
  barrier) runs on the CPU with its NCCL call replaced by a sum;
* ``resolve_plan`` with ``n_devices > 1`` equals the reference's on a
  grid; ``configs.nucleus`` equals the reference's; a mesh mixing CPU and
  CUDA devices raises.

Slabs on ``("cpu",) * k`` share one device, so no process is spawned.
"""
import dataclasses
import itertools
import json
import os

import numpy as np
import pytest
import torch

import repro.configs.nucleus as JN
import repro.core.backends as JB
from repro.core.api import NucleusConfig as JConfig
from repro.core.session import shard_bucket_size as j_shard_bucket_size

import repro_torch.configs.nucleus as TN
import repro_torch.core.backends as B
import repro_torch.core.distributed as dist
from repro_torch import NucleusConfig, Session, decompose
from repro_torch.configs import get_arch
from repro_torch.core import build_problem, canonicalize_labels
from repro_torch.core.distributed import sharded_decomposition, slab_bounds
from repro_torch.core.engine import dense_coreness, make_schedule
from repro_torch.distbuild import estimate_eager_build_bytes
from repro_torch.core.incidence import pick_rank
from repro_torch.graph.container import Graph
from repro_torch.graph.generators import community_power_law, golden_suite
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.serve import Request, Router

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

pytestmark = pytest.mark.fast

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FIXTURES = sorted(f for f in os.listdir(GOLDEN) if f.endswith(".json"))
SLABS = (1, 2, 3, 4, 8)
FIELDS = ("core", "uf_parent", "uf_L", "peel_value")


def cpu_mesh(k):
    return Mesh(("cpu",) * k)


def star(leaves):
    ids = torch.arange(1, leaves + 1, dtype=torch.int32)
    return Graph(n=leaves + 1,
                 edges=torch.stack([torch.zeros_like(ids), ids], dim=1))


@pytest.mark.parametrize("fname", FIXTURES)
def test_sharded_equals_dense_and_the_fixture(fname):
    with open(os.path.join(GOLDEN, fname)) as f:
        fx = json.load(f)
    r, s = fx["r"], fx["s"]
    problem = build_problem(golden_suite()[fx["graph"]](device="cpu"), r, s,
                            device="cpu")
    if problem.n_r == 0:
        return
    for method, hierarchy in itertools.product(("exact", "approx"),
                                               ("fused", "none")):
        cfg = NucleusConfig(r=r, s=s, method=method, hierarchy=hierarchy)
        want = decompose(problem, cfg, device="cpu")
        for k in SLABS:
            got = decompose(problem, dataclasses.replace(
                cfg, backend="sharded", mesh=cpu_mesh(k)), device="cpu")
            label = f"{fname} {method}/{hierarchy} {k} slabs"
            assert got.rounds == want.rounds, label
            assert got.peel_stats["slabs"] == k, label
            fields = FIELDS if hierarchy == "fused" else ("core",)
            for f in fields:
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f),
                                              err_msg=f"{label}: {f}")
            if method == "exact":
                np.testing.assert_array_equal(got.core, fx["core"],
                                              err_msg=label)
                if hierarchy == "fused":
                    for c, part in fx["partitions"].items():
                        np.testing.assert_array_equal(
                            canonicalize_labels(got.cut(int(c))), part,
                            err_msg=f"{label}: cut({c})")


def wheel(rim):
    """A hub joined to every vertex of a ring of ``rim`` vertices: at (1,2)
    the rim peels in round 0 and the hub's decrement is ``rim``, which
    saturates the float16 cap on every mesh."""
    ids = torch.arange(1, rim + 1, dtype=torch.int32)
    ring = torch.stack([ids, ids % rim + 1], dim=1)
    ring = torch.sort(ring, dim=1).values
    spokes = torch.stack([torch.zeros_like(ids), ids], dim=1)
    return Graph(n=rim + 1, edges=torch.cat([spokes, ring]))


@pytest.mark.parametrize("k", SLABS)
def test_compress_equals_uncompressed(k):
    """compress=True gives the uncompressed arrays at (1,2) on a wheel,
    whose hub decrement saturates the cap (drain steps > 0), and at (2,3)
    on a power-law graph; without the hierarchy too."""
    cases = ((build_problem(wheel(3_000), 1, 2, device="cpu"), True),
             (build_problem(community_power_law(400, seed=5, device="cpu"),
                            2, 3, device="cpu"), False))
    for problem, saturates in cases:
        for kind in ("exact", "approx"):
            plain = sharded_decomposition(problem, cpu_mesh(k), kind=kind,
                                          hierarchy=True)
            stats = {}
            comp = sharded_decomposition(problem, cpu_mesh(k), kind=kind,
                                         hierarchy=True, compress=True,
                                         stats=stats)
            assert plain[1] == comp[1]
            for a, b in zip(plain[:1] + plain[2:], comp[:1] + comp[2:]):
                np.testing.assert_array_equal(a, b)
            assert (stats["drain_steps"] > 0) == saturates, stats
            bare = sharded_decomposition(problem, cpu_mesh(k), kind=kind,
                                         compress=True)
            np.testing.assert_array_equal(bare[0], plain[0])
            assert bare[1] == plain[1]


@pytest.mark.parametrize("k", (1, 2, 3))
def test_compress_is_exact_on_the_star(k):
    """The reference's fault: on a 70,000-leaf star at (1,2) its int16
    compress gives the hub core 37,233 (one device) or 70,002 (two).  The
    port's drain steps land every residual before the next minimum."""
    problem = build_problem(star(70_000), 1, 2, device="cpu")
    stats = {}
    core, rounds, parent, L, raw = sharded_decomposition(
        problem, cpu_mesh(k), compress=True, hierarchy=True, stats=stats)
    want = sharded_decomposition(problem, cpu_mesh(k), hierarchy=True)
    assert core[0] == 1 and core.max() == 1 and rounds == want[1]
    for a, b in zip((parent, L, raw), want[2:]):
        np.testing.assert_array_equal(a, b)
    # 70,000 / k leaf edges a slab, cap 2048 // k sent per step
    cap = dist.COMPRESS_SUM // k
    per_slab = -(-70_000 // k)
    assert stats["drain_steps"] == -(-(per_slab - cap) // cap)


def split_parts(problem, k):
    """The k slabs of ``Mesh(("cpu",) * k)`` as k parts, as if each lay on
    a device of its own."""
    whole = dist._partition(problem, cpu_mesh(k))[0]
    bounds = slab_bounds(problem.n_s, k)
    parts = []
    for i in range(k):
        part = dist._Part(torch.device("cpu"), [i])
        part.inc = problem.inc_rid[bounds[i]:bounds[i + 1]]
        rids, sids = whole.plans[i]
        part.plans = [(rids, sids - bounds[i])]
        part.deg0 = problem.deg0
        parts.append(part)
    return parts


@pytest.mark.parametrize("compress", [False, True])
def test_device_threads_equal_the_dense_engine(compress, monkeypatch):
    """Several devices: one engine thread each, the reduction and the link
    gather at barriers.  On the CPU the NCCL call is replaced by an
    in-place sum over the deposited tensors; the forest is folded once, on
    the first device."""
    calls = {"n": 0}

    def fake_all_reduce(tensors):
        calls["n"] += 1
        total = sum(t.to(torch.float64) for t in tensors)
        for t in tensors:
            t.copy_(total)
    monkeypatch.setattr(torch.cuda.nccl, "all_reduce", fake_all_reduce)
    for problem in (build_problem(community_power_law(600, seed=6,
                                                      device="cpu"),
                                  2, 3, device="cpu"),
                    build_problem(wheel(3_000), 1, 2, device="cpu")):
        schedule = make_schedule(problem, "exact")
        core, _, rounds, parent, L = dense_coreness(
            problem, schedule, device="cpu", hierarchy=True)
        for k in (2, 3):
            coll = dist._Collective([torch.device("cpu")] * k)
            stats = {"drain_steps": 0}
            cap = dist.COMPRESS_SUM // k if compress else None
            calls["n"] = 0
            out = dist._run_threads(split_parts(problem, k), coll,
                                    (coll, problem.n_r, schedule,
                                     problem.n_r + 2, True, cap, stats))
            assert out[2] == rounds
            for a, b in zip((out[0], out[3], out[4]), (core, parent, L)):
                assert torch.equal(a, b)
            # one reduction a round, plus one a drain step
            assert calls["n"] == rounds + stats["drain_steps"]
            if compress and problem.r == 1:
                assert stats["drain_steps"] > 0


def test_thread_failure_is_raised_not_hung(monkeypatch):
    """A failing collective breaks the barrier; the first real error
    reaches the caller and no thread waits forever."""
    def broken(tensors):
        raise RuntimeError("NCCL error: unhandled system error")
    monkeypatch.setattr(torch.cuda.nccl, "all_reduce", broken)
    problem = build_problem(golden_suite()["planted40"](device="cpu"), 2, 3,
                            device="cpu")
    coll = dist._Collective([torch.device("cpu")] * 2)
    with pytest.raises(RuntimeError, match="NCCL error"):
        dist._run_threads(split_parts(problem, 2), coll,
                          (coll, problem.n_r, make_schedule(problem, "exact"),
                           problem.n_r + 2, True, None, {"drain_steps": 0}))


def test_mesh_values_and_errors(monkeypatch):
    a, b = Mesh(("cpu", "cpu")), Mesh([torch.device("cpu")] * 2)
    assert a == b and hash(a) == hash(b) and len(a) == 2
    assert a.distinct() == (torch.device("cpu"),)
    assert make_host_mesh("cpu") == Mesh(("cpu",))
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        Mesh(("cpu", "cuda:0"))
    with pytest.raises(ValueError, match="at least one device"):
        Mesh(())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_host_mesh()
    # the mesh is a process-local handle: to_dict drops it
    assert "mesh" not in NucleusConfig(backend="sharded",
                                       mesh=a).to_dict()


def test_slab_bounds_are_the_references_pad_bounds():
    """ceil(n_s / k) rows a slab, the unpadded prefix of the reference's
    pad_incidence layout."""
    for n_s, k in ((0, 3), (5, 8), (10, 3), (12, 4), (7, 1)):
        b = slab_bounds(n_s, k)
        rows = -(-n_s // k)
        assert b[0] == 0 and b[-1] == n_s and len(b) == k + 1
        assert all(b[i + 1] - b[i] == min(rows, max(n_s - i * rows, 0))
                   for i in range(k))


def test_configs_nucleus_equals_the_reference():
    spec = get_arch("nucleus")
    assert spec is TN.SPEC and spec.family == JN.SPEC.family == "core"
    assert [dataclasses.astuple(c) for c in TN.SHAPES] == \
        [dataclasses.astuple(c) for c in JN.SHAPES]
    for which in ("make_config", "make_smoke_config"):
        cfg = getattr(TN, which)()
        assert cfg == getattr(JN, which)()
        for tc, jc in zip(TN.SHAPES, JN.SHAPES):
            got, want = TN.make_peel_schedule(cfg, tc), \
                JN.make_peel_schedule(cfg, jc)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert TN.max_rounds_bound(cfg, tc) == \
                JN.max_rounds_bound(cfg, jc)


def test_planner_with_several_devices_matches_the_reference():
    """n_devices > 1 on a grid of builds, budgets, eager estimates and
    incidence sizes: the same (backend, hierarchy) as the reference's."""
    checked = 0
    for (n_devices, build, budget, eager_bytes, n_s, hierarchy,
         kind) in itertools.product(
            (1, 2, 4), ("eager", "chunked", "sharded"),
            (None, 1 << 20), (None, 1 << 10, 1 << 30),
            (1_000, 10_000_000), ("auto", "fused", "none", "replay"),
            ("cpu", "cuda")):
        kw = dict(backend="auto", hierarchy=hierarchy,
                  memory_budget_bytes=budget,
                  build="eager" if budget is None else build)
        facts = dict(n_r=5_000, n_s=n_s, n_sub=3, device_kind=kind,
                     n_devices=n_devices, r=2, s=3, build=build,
                     eager_build_bytes=eager_bytes,
                     profile_path="/nonexistent/profile.json")
        want = JB.resolve_plan(JConfig(**kw), **facts)
        got = B.resolve_plan(NucleusConfig(**kw), **facts)
        assert (got.backend, got.hierarchy) == \
            (want.backend, want.hierarchy), (kw, facts)
        checked += got.backend == "sharded"
    assert checked > 50


def test_auto_picks_the_mesh_and_upgrades_the_build():
    """decompose with backend='auto' over a 2-slab mesh: the planner sees
    2 devices (the sharded backend), and an eager build over the budget
    becomes the sharded build, with the reference's plan reason."""
    g = golden_suite()["planted40"](device="cpu")
    est = estimate_eager_build_bytes(pick_rank(g)[0], 3)
    dec = decompose(g, NucleusConfig(backend="auto", mesh=cpu_mesh(2),
                                     memory_budget_bytes=est - 1),
                    device="cpu")
    assert dec.plan.backend == "sharded"
    assert dec.problem.build_stats["build"] == "sharded"
    assert dec.problem.build_stats["n_shards"] == 1  # the CPU host mesh
    assert any(r.startswith("build 'sharded': 1 shards x")
               for r in dec.plan.reasons)
    want = decompose(g, NucleusConfig(), device="cpu")
    for f in ("core", "uf_parent", "uf_L"):
        np.testing.assert_array_equal(getattr(dec, f), getattr(want, f))


def test_sharded_session_and_router_pools():
    """A sharded pool runs the sharded backend unpadded: equal to
    decompose, its bucket the reference's shard-multiple class with
    ``shards`` = the mesh's length, kept out of the manifest; the router
    reports it as the reference's does."""
    graphs = [golden_suite()[n](device="cpu")
              for n in ("er20", "planted40", "er20")]
    for k in (3, 4):
        sess = Session(NucleusConfig(backend="sharded", mesh=cpu_mesh(k)),
                       device="cpu")
        for g in graphs:
            got = sess.decompose(g)
            want = decompose(g, NucleusConfig(), device="cpu")
            for f in ("core", "uf_parent", "uf_L"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
            key = sess.bucket_key(got.problem)
            assert key[8] == k
            assert key[5] == j_shard_bucket_size(got.problem.n_s, k)
            assert key[7] is None
        assert (sess.stats["cold"], sess.stats["warm"]) == (2, 1)
        assert sess.manifest()["buckets"] == []
    router = Router(device="cpu")
    router.pool(NucleusConfig(backend="sharded", mesh=cpu_mesh(3)))
    for g in graphs[:2] + graphs[:1]:
        router.route(Request(graph=g, backend="sharded"))
    rows = router.report()["pools"][0]["buckets"]
    assert sorted(row["shards"] for row in rows) == [3, 3]
    assert sum(row["count"] for row in rows) == 3
    # build_shards reaches the builder through the request's pool config
    dec = router.route(Request(graph=graphs[1], backend="sharded",
                               build="sharded", build_shards=2))
    assert dec.problem.build_stats["n_shards"] == 2
    assert router.report()["pools"][1]["build"]["n_shards"] == 2
