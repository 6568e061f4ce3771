"""repro_torch's sharded incidence build (``repro_torch.distbuild``) vs the
reference's ``repro.distbuild``, array for array.

* The planner: ``plan_shards`` equals the reference's ``ShardPlan`` field
  for field on every golden graph x shards {1, 2, 3, 8} x two budgets, on
  the same DAG.
* The builder: ``build="sharded"`` at 1/2/4/8 shards equals the
  reference's ``build_problem_sharded`` (its host-numpy builder, fed the
  port's graph and DAG, as tests/test_torch_build_chunked.py feeds its
  chunked builder) and the port's eager build in all five arrays and the
  orientation, and ``build_stats`` has the reference's keys and planning
  values (``peak_intermediate_bytes`` is each package's own meter).
* The reference's fastpath and stray-shard errors, word for word; the
  seed range of ``iter_clique_chunks``; the caller's ``rank``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.incidence as jincidence
from repro.core.incidence import build_problem as j_build_problem
from repro.distbuild import build_problem_sharded as j_build_sharded
from repro.distbuild import plan_shards as j_plan_shards
from repro.graph.cliques import iter_clique_chunks as j_iter_chunks
from repro.graph.container import Digraph as JDigraph, Graph as JGraph

from repro_torch.core.incidence import (INCIDENCE_FIELDS as FIELDS,
                                       build_problem, pick_rank)
from repro_torch.distbuild import ShardPlan, plan_shards
from repro_torch.graph import degree_rank, orient
from repro_torch.graph.cliques import (count_cliques, iter_clique_chunks,
                                       list_cliques)
from repro_torch.graph.generators import golden_suite

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

pytestmark = pytest.mark.fast

GRAPHS = sorted(golden_suite())
RS = [(1, 2), (2, 3), (3, 4)]
# the reference's planning stats (everything but its host meter)
PLAN_STATS = ("build", "n_shards", "chunk_size", "n_chunks",
              "chunks_per_shard", "shard_work", "skew", "exchange_bytes",
              "memory_budget_bytes", "eager_estimate_bytes", "fastpath")


@functools.lru_cache(maxsize=None)
def graph_and_dag(gname):
    """(port graph, port DAG, orientation, reference Graph, reference DAG
    built from the port's arrays)."""
    g = golden_suite()[gname](device="cpu")
    dg, orientation = pick_rank(g)
    jdg = JDigraph(n=dg.n, **{f: jnp.asarray(getattr(dg, f).numpy())
                              for f in ("offsets", "neighbors", "adj",
                                        "outdeg")})
    jg = JGraph(n=g.n, edges=jnp.asarray(g.edges.numpy()))
    return g, dg, orientation, jg, jdg


@pytest.mark.parametrize("budget", [None, 1 << 12])
@pytest.mark.parametrize("gname", GRAPHS)
def test_plan_shards_matches_reference(gname, budget):
    _, dg, _, _, jdg = graph_and_dag(gname)
    for s in (2, 3, 4):
        for n_shards in (1, 2, 3, 8):
            got = plan_shards(dg, s, n_shards, memory_budget_bytes=budget)
            want = j_plan_shards(jdg, s, n_shards,
                                 memory_budget_bytes=budget)
            assert isinstance(got, ShardPlan)
            label = (gname, s, n_shards, budget)
            for f in ("n_shards", "chunk_size", "chunk_bounds",
                      "shard_bounds", "chunk_work"):
                assert getattr(got, f) == getattr(want, f), (label, f)
            assert got.chunks_per_shard() == want.chunks_per_shard()
            assert got.shard_work() == want.shard_work()
            assert got.skew() == want.skew()
            for k in range(n_shards):
                assert got.shard_seed_range(k) == want.shard_seed_range(k)


@pytest.mark.parametrize("r,s", RS, ids=[f"r{r}s{s}" for r, s in RS])
@pytest.mark.parametrize("gname", GRAPHS)
def test_sharded_build_matches_reference_and_eager(gname, r, s,
                                                   monkeypatch):
    g, dg, orientation, jg, jdg = graph_and_dag(gname)
    # the reference's builder orients through this hook: hand it the
    # port's DAG, so both builders expand the same graph
    monkeypatch.setattr(jincidence, "_resolve_digraph",
                        lambda _g, _rank: (jdg, orientation))
    eager = build_problem(g, r, s, device="cpu")
    for n_shards in (1, 2, 4, 8):
        for chunk in (None, 3):
            got = build_problem(g, r, s, build="sharded", shards=n_shards,
                                chunk_size=chunk, device="cpu")
            want = j_build_sharded(jg, r, s, n_shards=n_shards,
                                   chunk_size=chunk)
            label = (gname, r, s, n_shards, chunk)
            assert got.orientation == want.orientation == \
                eager.orientation, label
            for f in FIELDS:
                a = getattr(got, f).numpy()
                np.testing.assert_array_equal(a, np.asarray(getattr(want, f)),
                                              err_msg=f"{label} {f}")
                np.testing.assert_array_equal(a, getattr(eager, f).numpy(),
                                              err_msg=f"{label} {f} eager")
            assert set(got.build_stats) == set(want.build_stats), label
            for k in PLAN_STATS:
                assert got.build_stats[k] == want.build_stats[k], (label, k)


def test_sharded_build_rejects_fastpath_and_stray_shards():
    """The reference's two build-knob errors, word for word."""
    g = golden_suite()["k4"](device="cpu")
    jg = graph_and_dag("k4")[3]
    for kw in (dict(build="sharded", fastpath=True),
               dict(build="chunked", shards=2),
               dict(build="eager", shards=4)):
        with pytest.raises(ValueError) as want:
            j_build_problem(jg, 2, 3, **kw)
        with pytest.raises(ValueError) as got:
            build_problem(g, 2, 3, device="cpu", **kw)
        assert str(got.value) == str(want.value), kw


def test_iter_clique_chunks_seed_range_matches_reference():
    """start/stop walk [start, stop) with chunks anchored at start, as the
    reference's; the ranges of a plan tile the whole-frontier walk."""
    _, dg, _, _, jdg = graph_and_dag("planted40")
    for start, stop, chunk in ((0, None, 7), (5, 23, 4), (13, 13, 3),
                               (30, 1000, 8)):
        got = list(iter_clique_chunks(dg, [2, 3], chunk, start=start,
                                      stop=stop))
        want = list(j_iter_chunks(jdg, [2, 3], chunk, start=start,
                                  stop=stop))
        assert [s0 for s0, _, _ in got] == [s0 for s0, _, _ in want]
        for (_, a, _), (_, b, _) in zip(got, want):
            for t in (2, 3):
                np.testing.assert_array_equal(a[t].numpy(), b[t])
    plan = plan_shards(dg, 3, 3, chunk_size=5)
    whole = torch.cat([lv[3] for _, lv, _ in
                       iter_clique_chunks(dg, [3], 5)])
    parts = [lv[3] for k in range(3)
             for _, lv, _ in iter_clique_chunks(
                 dg, [3], 5, start=plan.shard_seed_range(k)[0],
                 stop=plan.shard_seed_range(k)[1])]
    assert torch.equal(torch.cat(parts), whole)


def test_caller_rank_orients_the_build():
    """``rank=`` is the caller's orientation: ``orientation == "caller"``,
    the arrays of a build over ``orient(g, rank)``, for every builder;
    ``list_cliques``/``count_cliques`` take the same ``rank``."""
    g = golden_suite()["planted40"](device="cpu")
    rank = -degree_rank(g)  # a different order from either candidate's
    base = build_problem(g, 2, 3, rank=rank, device="cpu")
    assert base.orientation == "caller"
    for kw in (dict(build="chunked", chunk_size=4),
               dict(build="sharded", shards=3)):
        other = build_problem(g, 2, 3, rank=rank, device="cpu", **kw)
        assert other.orientation == "caller"
        for f in FIELDS:
            assert torch.equal(getattr(other, f), getattr(base, f)), (kw, f)
    lv = list_cliques(g, [2, 3], rank=rank)
    assert lv.count(3) == count_cliques(g, 3, rank=rank) == base.n_s
    ref = list_cliques(g, [3], dg=orient(g, rank)).levels[3]
    assert torch.equal(lv.levels[3], ref)
