"""repro_torch's warm ``Session`` against the reference's.

* PARITY: ``Session(cfg).decompose(p)`` on the CPU equals the port's
  unpadded ``decompose(p, cfg)`` array for array (core, rounds, trace,
  peel values, forest, tree) and the reference's ``Session`` on the same
  incidence arrays, on the goldens, exact and approx, at (1,2), (2,3) and
  (3,4), and through the megakernel's plain twin (``use_kernel=True``).
* BUCKETS: the helpers hit the reference's boundaries and canonical
  schedules; the same stream gives the reference's warm/cold/fallback
  counts and bucket keys; keys are shape-only; the LRU order and eviction.
* FALLBACK: configs off the dense engine, over the plan budget or with
  ``backend='auto'`` keep the planner's provenance.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import session as jsession
from repro.core.incidence import NucleusProblem as JProblem
from repro.graph.container import Graph as JGraph

from repro_torch import GraphDelta, NucleusConfig, Session, decompose
from repro_torch.core import session as session_mod
from repro_torch.core.incidence import build_problem
from repro_torch.core.schedule import PeelSchedule
from repro_torch.core.session import bucket_size, canonical_schedule
from repro_torch.graph.container import make_graph
from repro_torch.graph.generators import golden_suite, planted_cliques

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

pytestmark = pytest.mark.fast

GRAPHS = golden_suite()
FIELDS = ("r_cliques", "inc_rid", "mem_offsets", "mem_sids", "deg0")
ARRAYS = ("core", "order_round", "peel_value", "uf_parent", "uf_L")


def jproblem(p):
    """The reference's problem on the port problem's incidence arrays."""
    return JProblem(g=JGraph(n=p.g.n, edges=jnp.asarray(p.g.edges.numpy())),
                    r=p.r, s=p.s,
                    **{f: jnp.asarray(getattr(p, f).numpy()) for f in FIELDS},
                    orientation=p.orientation)


def jconfig(cfg):
    d = cfg.to_dict()
    return jcore.NucleusConfig(**{k: v for k, v in d.items()
                                  if k in {f.name for f in dataclasses.fields(
                                      jcore.NucleusConfig)}})


def problem(name_or_graph, r, s):
    g = GRAPHS[name_or_graph](device="cpu") \
        if isinstance(name_or_graph, str) else name_or_graph
    return build_problem(g, r, s, device="cpu")


def assert_same(got, want, label):
    assert got.rounds == want.rounds, label
    assert type(got.rounds) is int, label
    for f in ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f"{label}: {f}"
            continue
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=f"{label}: {f}")
    if want.has_hierarchy:
        np.testing.assert_array_equal(got.tree.parent,
                                      np.asarray(want.tree.parent),
                                      err_msg=f"{label}: tree parent")
        np.testing.assert_array_equal(got.tree.level,
                                      np.asarray(want.tree.level),
                                      err_msg=f"{label}: tree level")


def counts(stats):
    return {k: v for k, v in stats.items() if k != "buckets"}


def key_fields(key):
    """A bucket key with its schedule as a dict (the two packages'
    PeelSchedule classes differ) and without the kernel field."""
    k = list(key)
    k[6] = dataclasses.asdict(k[6])
    del k[7]
    return tuple(k[:7]) + tuple(k[7:])


# ---------------------------------------------------------------------------
# Padding + canonicalization helpers
# ---------------------------------------------------------------------------

def test_bucket_size_boundaries():
    assert bucket_size(0) == 64 and bucket_size(64) == 64
    assert bucket_size(65) == 128 and bucket_size(129) == 256
    assert bucket_size(3, floor=2) == 4
    for n in (0, 1, 63, 64, 65, 127, 128, 129, 1000, 4097):
        for floor in (1, 2, 64, 512):
            assert bucket_size(n, floor) == jsession.bucket_size(n, floor)
            for shards in (1, 3, 8):
                assert session_mod.shard_bucket_size(n, shards, floor) == \
                    jsession.shard_bucket_size(n, shards, floor)


def test_canonical_schedule_matches_reference():
    assert canonical_schedule("exact", 3, 0.1, 10) == \
        canonical_schedule("exact", 3, 0.5, 10_000)
    for n in (2, 10, 100, 1_000, 50_000):
        for delta in (0.1, 0.5):
            for C in (1, 3, 4):
                got = canonical_schedule("approx", C, delta, n)
                want = jsession.canonical_schedule("approx", C, delta, n)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                full = PeelSchedule(kind="approx", s_choose_r=C,
                                    delta=delta, n=n)
                assert got.cap() == full.cap()


def test_same_cap_graphs_share_a_bucket():
    cfg = NucleusConfig(method="approx", delta=1.5, hierarchy="none")
    sess = Session(cfg, device="cpu")
    p1 = problem(planted_cliques(40, [8, 6], 0.05, seed=1, device="cpu"),
                 2, 3)
    p2 = problem(planted_cliques(41, [8, 6], 0.05, seed=2, device="cpu"),
                 2, 3)
    assert p1.g.n != p2.g.n
    assert sess.bucket_key(p1) == sess.bucket_key(p2)


# ---------------------------------------------------------------------------
# Parity: the port's unpadded decompose and the reference's Session
# ---------------------------------------------------------------------------

CASES = (
    [pytest.param(name, 2, 3, "exact", id=name) for name in sorted(GRAPHS)]
    + [pytest.param(name, 2, 3, "approx", id=f"{name}-approx")
       for name in ("two_triangles", "planted40", "er20")]
    + [pytest.param("planted40", r, s, "exact", id=f"planted40-r{r}s{s}")
       for r, s in ((1, 2), (3, 4))])


@pytest.mark.parametrize("name,r,s,method", CASES)
def test_session_matches_decompose_and_reference(name, r, s, method):
    p = problem(name, r, s)
    cfg = NucleusConfig(r=r, s=s, method=method, delta=0.25)
    sess = Session(cfg, device="cpu")
    got = sess.decompose(p)
    assert_same(got, decompose(p, cfg, device="cpu"), f"{name} unpadded")
    jsess = jcore.Session(jconfig(cfg))
    assert_same(got, jsess.decompose(jproblem(p)), f"{name} reference")
    assert counts(sess.stats) == counts(jsess.stats)
    assert [key_fields(k) for k in sess.stats["buckets"]] == \
        [key_fields(k) for k in jsess.stats["buckets"]]


def test_session_accepts_graphs():
    g = planted_cliques(90, [9, 7], 0.04, seed=5, device="cpu")
    cfg = NucleusConfig(hierarchy="none")
    assert_same(Session(cfg, device="cpu").decompose(g),
                decompose(g, cfg, device="cpu"), "from-graph")


def stream(r=2, s=3, k=4):
    return [problem(planted_cliques(100 + 3 * i, [10, 8], 0.03, seed=20 + i,
                                    device="cpu"), r, s) for i in range(k)]


@pytest.mark.parametrize("r,s", [(2, 3), (1, 2)])
def test_same_bucket_stream_is_warm(r, s):
    """Distinct shapes, one shape class: cold once, warm after, the
    reference's counts and keys on the same stream."""
    cfg = NucleusConfig(r=r, s=s)
    sess = Session(cfg, device="cpu")
    jsess = jcore.Session(jconfig(cfg))
    problems = stream(r, s)
    assert len({(p.n_r, p.n_s) for p in problems}) > 1
    decs = sess.decompose_many(problems)
    jdecs = jsess.decompose_many([jproblem(p) for p in problems])
    assert len(sess.stats["buckets"]) == 1
    assert sess.stats["cold"] == 1 and sess.stats["warm"] == 3
    assert counts(sess.stats) == counts(jsess.stats)
    for p, d, jd in zip(problems, decs, jdecs):
        assert_same(d, decompose(p, cfg, device="cpu"), f"n_r={p.n_r}")
        assert_same(d, jd, f"reference n_r={p.n_r}")


def test_kernel_rides_the_warm_path():
    """use_kernel=True (the megakernel's plain twin on CPU tensors): the
    bucket key carries the reference's padded plan length and the arrays
    stay identical to decompose's."""
    cfg = NucleusConfig(use_kernel=True)
    sess = Session(cfg, device="cpu")
    problems = stream(k=3)
    decs = sess.decompose_many(problems)
    assert sess.stats["fallback"] == 0
    assert sess.stats["cold"] == 1 and sess.stats["warm"] == 2
    key = next(iter(sess.stats["buckets"]))
    assert key[7] == session_mod.padded_plan_edges(problems[0])
    for p, d in zip(problems, decs):
        assert_same(d, decompose(p, cfg, device="cpu"), f"kernel n_r={p.n_r}")


@pytest.mark.parametrize("n", [64, 65, 255, 256, 257])
def test_session_parity_at_bucket_boundaries(n):
    """Cycles straddling the bucket floor (64) and the plan's edge floor
    (2n = 512), on the generic engine with the kernel's twin."""
    edges = np.array([[i, (i + 1) % n] for i in range(n)])
    p = build_problem(make_graph(n, edges, device="cpu"), 1, 2,
                      device="cpu")
    cfg = NucleusConfig(r=1, s=2, use_kernel=True)
    assert_same(Session(cfg, device="cpu").decompose(p),
                decompose(p, cfg, device="cpu"), f"cycle{n}")


def test_fallback_backends_still_work():
    p = problem("two_triangles", 2, 3)
    for backend, hierarchy in [("gather", "replay"), ("nh", "two_phase")]:
        cfg = NucleusConfig(backend=backend, hierarchy=hierarchy)
        sess = Session(cfg, device="cpu")
        dec = sess.decompose(p)
        assert sess.stats["fallback"] == 1
        np.testing.assert_array_equal(dec.core,
                                      decompose(p, cfg, device="cpu").core)


@pytest.mark.parametrize("budget", ["one", "between"])
def test_plan_budget_gate_counts_padded_bytes(budget, monkeypatch):
    """The gate races the PADDED plan bytes against the budget: at 1 byte,
    and between the unpadded and padded sizes, the call falls back."""
    p = problem("planted40", 2, 3)
    C = p.n_sub
    unpadded = 4 * p.n_s * C * C
    padded = 4 * bucket_size(p.n_s * C, session_mod.PLAN_EDGE_FLOOR) * C
    assert unpadded < padded
    monkeypatch.setattr(session_mod, "MEGAKERNEL_PLAN_BUDGET_BYTES",
                        1 if budget == "one" else (unpadded + padded) // 2)
    cfg = NucleusConfig(use_kernel=True)
    sess = Session(cfg, device="cpu")
    dec = sess.decompose(p)
    assert sess.stats["fallback"] == 1
    assert_same(dec, decompose(p, cfg, device="cpu"), "over budget")


def test_fallback_preserves_auto_plan_provenance():
    tiny = problem("two_triangles", 2, 3)
    cfg = NucleusConfig(backend="auto", hierarchy="auto")
    sess = Session(cfg, device="cpu")
    dec = sess.decompose(tiny)
    jsess = jcore.Session(jconfig(cfg))
    jdec = jsess.decompose(jproblem(tiny))
    assert sess.stats["fallback"] == 1
    assert counts(sess.stats) == counts(jsess.stats)
    assert dec.plan == decompose(tiny, cfg, device="cpu").plan
    # the reasons name the thresholds, which differ: the port's planner
    # profile has no entries yet (static thresholds), the reference's has
    # a 'cpu' one
    assert {k: v for k, v in dec.plan.to_dict().items() if k != "reasons"} \
        == {k: v for k, v in jdec.plan.to_dict().items() if k != "reasons"}
    assert dec.plan.was_auto and dec.plan.requested_backend == "auto"
    assert "explicitly configured" not in dec.plan_report()


def test_bucket_key_builds_no_plan_arrays(monkeypatch):
    from repro_torch.core import engine
    sess = Session(NucleusConfig(use_kernel=True), device="cpu")
    p = problem("er20", 2, 3)

    def boom(*a, **k):
        raise AssertionError("bucket_key built the megakernel plan")

    monkeypatch.setattr(engine, "_round_plan", boom)
    key = sess.bucket_key(p)
    assert key[7] == session_mod.padded_plan_edges(p)


def test_bucket_hit_lru_order():
    sess = Session(NucleusConfig(), bucket_cap=2, device="cpu")
    assert sess._bucket_hit("a") is False
    assert sess._bucket_hit("b") is False
    assert sess._bucket_hit("a") is True    # refreshes a
    assert sess._bucket_hit("c") is False   # evicts b, the stalest
    assert set(sess.stats["buckets"]) == {"a", "c"}
    assert sess.stats["evictions"] == 1
    assert sess._bucket_hit("b") is False   # re-seen after eviction: cold


def test_bucket_lru_eviction_bounds_stats():
    cfg = NucleusConfig(r=1, s=2, hierarchy="none")
    sess = Session(cfg, bucket_floor=1, bucket_cap=2, device="cpu")
    for name in sorted(GRAPHS):
        sess.decompose(problem(name, 1, 2))
    assert len(sess.stats["buckets"]) <= 2
    assert sess.stats["evictions"] > 0
    assert sess.stats["cold"] + sess.stats["warm"] == \
        sess.stats["decompositions"] - sess.stats["fallback"]


def test_prewarm_registers_buckets_and_refuses_reference_manifests():
    sess = Session(NucleusConfig(use_kernel=True), device="cpu")
    sess.decompose(problem("planted40", 2, 3))
    manifest = sess.manifest()
    assert manifest["format"] == "repro_torch.session-manifest"
    assert manifest["buckets"][0]["e_pad"] is not None
    fresh = Session(NucleusConfig(use_kernel=True), device="cpu")
    assert fresh.prewarm(manifest) == 1
    fresh.decompose(problem("planted40", 2, 3))
    assert fresh.stats["warm"] == 1 and fresh.stats["cold"] == 0
    assert fresh.stats["prewarmed"] == 1
    jsess = jcore.Session(jconfig(NucleusConfig()))
    jsess.decompose(jproblem(problem("planted40", 2, 3)))
    with pytest.raises(ValueError, match="reference package"):
        fresh.prewarm(jsess.manifest())


def test_session_update_streams_like_the_reference():
    """Session.update counts the local stages' shape classes as the
    reference does, and the result equals a fresh decompose."""
    cfg = NucleusConfig(r=1, s=2)
    g = GRAPHS["er20"](device="cpu")
    p = problem("er20", 1, 2)
    sess = Session(cfg, device="cpu")
    jsess = jcore.Session(jconfig(cfg))
    dec, jdec = sess.decompose(p), jsess.decompose(jproblem(p))
    present = {tuple(x) for x in g.edges.numpy().tolist()}
    ins = next((u, v) for u in range(g.n) for v in range(u + 1, g.n)
               if (u, v) not in present)
    for kw in (dict(insert=np.array([ins])), dict(delete=np.array([ins]))):
        dec = sess.update(dec, GraphDelta(**kw))
        jdec = jsess.update(jdec, jcore.GraphDelta(**kw))
    assert counts(sess.stats) == counts(jsess.stats)
    assert sess.stats["stream_warm"] >= 1
    assert list(sess.stats["buckets"])[1:] == \
        list(jsess.stats["buckets"])[1:]
    fresh = decompose(dec.problem.g, cfg, device="cpu")
    for f in ("core", "uf_parent", "uf_L"):
        np.testing.assert_array_equal(getattr(dec, f), getattr(fresh, f))


def test_session_needs_a_card_and_refuses_sharded(monkeypatch):
    """device=None means the card: without one Session raises and names
    device="cpu"; a sharded pool runs on the CPU (``make_host_mesh``'s
    one CPU slab) and gives the dense decompose's arrays."""
    sharded = Session(NucleusConfig(backend="sharded"), device="cpu")
    g = GRAPHS["k4"](device="cpu")
    got = sharded.decompose(g)
    want = decompose(g, NucleusConfig(), device="cpu")
    for f in ("core", "uf_parent", "uf_L"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.peel_stats["slabs"] == 1
    assert [k[8] for k in sharded.stats["buckets"]] == [1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Session(NucleusConfig())
