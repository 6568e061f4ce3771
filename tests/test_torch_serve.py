"""repro_torch's multi-tenant serve stack against the reference's.

* ROUTING: canonical configs key the pools (the reference's pool keys);
  the report carries the embedded Plan, hit rates and shape buckets.
* PARITY: artifacts from the concurrent Frontend equal serial
  ``decompose()``, and the counters sum exactly.
* ADMISSION: the padded plan bytes equal the reference's
  ``padded_plan_bytes`` on the same problem; over-budget graphs and a full
  queue are typed errors (HTTP 413 and 429, as the reference maps them).
* RESTART: the manifest round-trips and prewarm makes the first
  post-restart same-bucket decompose warm; ``init_persistent_cache``
  points the kernel build directory at its argument.
* STATUS: the port's report passes the reference's ``validate_status``.
* LANES: ``serve_nucleus_warm_pool()`` at its defaults counts what the
  reference's does; every lane raises without a card and without
  ``device="cpu"``.
"""
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.incidence as jincidence
import repro.graph.generators as jgenerators
import repro.serve as jserve
from repro.core.incidence import NucleusProblem as JProblem
from repro.graph.container import Graph as JGraph

from repro_torch import Decomposition, GraphDelta, NucleusConfig, decompose
from repro_torch.core.incidence import build_problem
from repro_torch.graph.container import make_graph
from repro_torch.graph.generators import golden_suite, planted_cliques
from repro_torch.kernels import _build
from repro_torch.launch import serve as launch
from repro_torch.serve import (AdmissionError, Frontend, NucleusHTTPServer,
                               QueueFullError, Request, Router,
                               canonical_config, init_persistent_cache,
                               load_manifest, padded_plan_bytes, pool_key,
                               prewarm_router, router_manifest,
                               save_manifest, status_report, validate_status)

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

pytestmark = pytest.mark.fast

GRAPHS = golden_suite()
FIELDS = ("r_cliques", "inc_rid", "mem_offsets", "mem_sids", "deg0")


def jproblem(p):
    return JProblem(g=JGraph(n=p.g.n, edges=jnp.asarray(p.g.edges.numpy())),
                    r=p.r, s=p.s,
                    **{f: jnp.asarray(getattr(p, f).numpy()) for f in FIELDS},
                    orientation=p.orientation)


def g_(name):
    return GRAPHS[name](device="cpu")


def assert_same(a, b, label):
    assert a.rounds == b.rounds, label
    for f in ("core", "order_round", "peel_value", "uf_parent", "uf_L"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{label}: {f}")


def cpu_router(**kw):
    return Router(device="cpu", **kw)


# ---------------------------------------------------------------------------
# Pool keying
# ---------------------------------------------------------------------------

def test_canonical_config_pins_dead_axes():
    a = NucleusConfig(method="exact", delta=0.1)
    b = NucleusConfig(method="exact", delta=0.7)
    assert pool_key(a) == pool_key(b)
    c = NucleusConfig(method="approx", delta=0.1)
    d = NucleusConfig(method="approx", delta=0.7)
    assert pool_key(c) != pool_key(d)
    assert canonical_config(b).delta == NucleusConfig().delta
    # the same keys as the reference's pools
    from repro.core import NucleusConfig as JConfig
    for cfg in (a, b, c, d, NucleusConfig(r=1, s=2, hierarchy="none")):
        jcfg = JConfig(**{k: v for k, v in cfg.to_dict().items()})
        assert pool_key(cfg) == jserve.pool_key(jcfg)


def test_router_pools_by_canonical_config():
    router = cpu_router()
    g = g_("er20")
    router.route(Request(graph=g, r=2, s=3, delta=0.1))
    router.route(Request(graph=g, r=2, s=3, delta=0.9))  # same pool
    router.route(Request(graph=g, r=1, s=2))             # new pool
    report = router.report()
    assert len(report["pools"]) == 2
    exact = next(p for p in report["pools"] if p["config"]["s"] == 3)
    assert exact["stats"]["decompositions"] == 2
    assert exact["stats"]["warm"] == 1
    assert exact["hit_rate"] == pytest.approx(0.5)
    assert exact["plan"] is not None and "backend" in exact["plan"]
    assert any("n_r_pad" in b for b in exact["buckets"])


# ---------------------------------------------------------------------------
# Concurrent parity + exact stats
# ---------------------------------------------------------------------------

def test_concurrent_frontend_parity_and_stats():
    cases = [("triangle", 1, 2), ("k4", 2, 3), ("two_triangles", 2, 3),
             ("er20", 2, 3), ("er20", 1, 2), ("planted40", 2, 3)]
    front = Frontend(cpu_router()).start()
    try:
        results, errors = {}, []

        def client(idx, name, r, s):
            try:
                fut = front.submit(Request(graph=g_(name), r=r, s=s,
                                           artifact=f"a{idx}"))
                results[idx] = fut.result(timeout=300)
            except Exception as e:  # pragma: no cover - surfaced below
                errors.append((idx, e))

        threads = [threading.Thread(target=client, args=(i, *case))
                   for i, case in enumerate(cases)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not errors, errors
        for i, (name, r, s) in enumerate(cases):
            assert_same(results[i], decompose(g_(name), NucleusConfig(
                r=r, s=s), device="cpu"), f"{name} r={r} s={s}")
        stats = front.stats
        assert stats["submitted"] == stats["served"] == len(cases)
        assert stats["failed"] == 0
        per_pool = [p["stats"] for p in front.router.report()["pools"]]
        assert sum(s["decompositions"] for s in per_pool) == len(cases)
        for s in per_pool:
            assert s["warm"] + s["cold"] + s["fallback"] == \
                s["decompositions"]
    finally:
        front.stop()


def test_problems_build_on_the_worker_thread(monkeypatch):
    """Concurrent submits only enqueue: every problem build (the device
    work of admission) and every decompose runs on the one worker
    thread, an over-budget graph included."""
    router = cpu_router()
    seen = []
    resolve, route_many = router.resolve, router.route_many

    def spy(fn):
        def wrapped(*a, **k):
            seen.append(threading.current_thread().name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(router, "resolve", spy(resolve))
    monkeypatch.setattr(router, "route_many", spy(route_many))
    k4 = build_problem(g_("k4"), 2, 3, device="cpu")
    front = Frontend(router,
                     admission_budget_bytes=padded_plan_bytes(k4)).start()
    try:
        futures, lock = [], threading.Lock()

        big = planted_cliques(100, [12, 10], 0.03, seed=1, device="cpu")

        def client(name):
            g = big if name == "big" else g_(name)
            fut = front.submit(Request(graph=g, r=2, s=3))
            with lock:
                futures.append((name, fut))

        names = ["k4", "triangle", "big", "k4"]
        threads = [threading.Thread(target=client, args=(n,))
                   for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        for name, fut in futures:
            if name == "big":
                with pytest.raises(AdmissionError):
                    fut.result(timeout=120)
            else:
                assert fut.result(timeout=120).n_r > 0
    finally:
        front.stop()
    assert len(seen) >= len(names) and set(seen) == {"nucleus-frontend"}
    assert front.stats["rejected_admission"] == 1
    assert front.stats["served"] == len(names) - 1


def test_frontend_counters_survive_a_thread_storm():
    """More submitters than cores with a short switch interval: every
    accepted request is served once and no counter loses an update."""
    import os
    import sys

    n = (os.cpu_count() or 4) + 4
    front = Frontend(cpu_router(), max_queue=n).start()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        futures, lock = [], threading.Lock()

        def client(i):
            fut = front.submit(Request(graph=g_("triangle"), r=1, s=2,
                                       artifact=f"t{i}"))
            with lock:
                futures.append(fut)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        for fut in futures:
            fut.result(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        front.stop()
    assert front.stats["submitted"] == front.stats["served"] == n
    stats = front.router.report()["pools"][0]["stats"]
    assert stats["decompositions"] == stats["warm"] + stats["cold"] == n
    assert len(front.router.report()["artifacts"]) == n


# ---------------------------------------------------------------------------
# Admission control + backpressure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,r,s", [("er20", 2, 3), ("planted40", 2, 3),
                                      ("planted40", 1, 2),
                                      ("planted40", 3, 4)])
def test_admission_bytes_equal_the_reference(name, r, s):
    p = build_problem(g_(name), r, s, device="cpu")
    assert padded_plan_bytes(p) == jserve.padded_plan_bytes(jproblem(p))


def test_admission_error_carries_computed_bytes():
    front = Frontend(cpu_router(), admission_budget_bytes=16).start()
    try:
        g = g_("er20")
        fut = front.submit(Request(graph=g, r=2, s=3))
        with pytest.raises(AdmissionError) as ei:
            fut.result(timeout=120)
        p = build_problem(g, 2, 3, device="cpu")
        assert ei.value.plan_bytes == padded_plan_bytes(p)
        assert ei.value.budget_bytes == 16
        assert "offline" in str(ei.value)
        # admission runs on the worker: the job was queued, then rejected
        assert front.stats["rejected_admission"] == 1
        assert front.stats["submitted"] == 1
        assert front.stats["served"] == front.stats["failed"] == 0
    finally:
        front.stop()


def test_queue_full_is_typed_backpressure():
    front = Frontend(cpu_router(), max_queue=1)
    # no worker drains: the bound is deterministic
    front._worker = threading.current_thread()
    front.submit(Request(graph=g_("triangle"), r=1, s=2))
    with pytest.raises(QueueFullError):
        front.submit(Request(graph=g_("triangle"), r=1, s=2))
    assert front.stats["rejected_queue"] == 1
    assert front.stats["submitted"] == 1


def test_submit_requires_started_worker():
    with pytest.raises(RuntimeError, match="start"):
        Frontend(cpu_router()).submit(Request(graph=g_("triangle"), r=1,
                                              s=2))


# ---------------------------------------------------------------------------
# Manifest round-trip, restart prewarm, the kernel cache directory
# ---------------------------------------------------------------------------

def test_manifest_prewarm_restart(tmp_path):
    router = cpu_router()
    router.route(Request(graph=planted_cliques(40, [8, 6, 5], 0.05, seed=3,
                                               device="cpu"), r=2, s=3))
    save_manifest(router, str(tmp_path))
    manifest = load_manifest(str(tmp_path))
    assert manifest is not None
    restarted = cpu_router()
    assert prewarm_router(restarted, manifest) == 1
    g2 = planted_cliques(42, [8, 6, 5], 0.05, seed=4, device="cpu")
    dec = restarted.route(Request(graph=g2, r=2, s=3))
    stats = restarted.report()["pools"][0]["stats"]
    assert (stats["warm"], stats["cold"], stats["prewarmed"]) == (1, 0, 1)
    assert_same(dec, decompose(g2, NucleusConfig(), device="cpu"),
                "restart parity")


def test_manifest_rejects_wrong_format(tmp_path):
    p = tmp_path / "session_manifest.json"
    p.write_text(json.dumps({"format": "something-else", "pools": []}))
    with pytest.raises(ValueError, match="format"):
        load_manifest(str(tmp_path))
    assert load_manifest(str(tmp_path / "missing")) is None
    with pytest.raises(ValueError, match="format"):
        prewarm_router(cpu_router(), {"format": "repro.nucleus-server-"
                                      "manifest", "pools": []})


def test_router_manifest_shape():
    router = cpu_router()
    router.route(Request(graph=g_("er20"), r=2, s=3))
    m = router_manifest(router)
    entry = m["pools"][0]["buckets"][0]
    for key in ("method", "r", "s", "fused", "n_r_pad", "n_s_pad",
                "schedule", "e_pad"):
        assert key in entry, key
    json.dumps(m)


def test_init_persistent_cache_moves_the_kernel_build(tmp_path):
    """The kernel library is built into and loaded from the cache
    directory (nothing is built on the CPU); an unusable directory
    returns False with a warning and leaves the build directory alone."""
    before = _build.BUILD_DIR
    try:
        assert init_persistent_cache(str(tmp_path / "cache")) is True
        assert _build.BUILD_DIR == (tmp_path / "cache").resolve()
        assert _build.library_path().parent == (tmp_path / "cache").resolve()
        assert not list((tmp_path / "cache").iterdir())
        blocker = tmp_path / "file"
        blocker.write_text("x")
        with pytest.warns(RuntimeWarning, match="unavailable"):
            assert init_persistent_cache(str(blocker / "sub")) is False
        assert _build.BUILD_DIR == (tmp_path / "cache").resolve()
    finally:
        _build.set_build_dir(before)


# ---------------------------------------------------------------------------
# Named live artifacts
# ---------------------------------------------------------------------------

def test_named_artifact_update_versioning():
    router = cpu_router()
    dec = router.route(Request(graph=g_("two_triangles"), r=2, s=3,
                               artifact="live"))
    assert dec.name == "live" and dec.version == 0
    new = router.update("live", GraphDelta(insert=np.array([[0, 4]])))
    assert new.name == "live" and new.version == 1
    assert router.artifact("live") is new
    back = Decomposition.from_json(new.to_json())
    assert back.name == "live" and back.version == 1
    pool = router.report()["pools"][0]["stats"]
    assert pool["updates"] == 1 and pool["stream_cold"] >= 1
    with pytest.raises(KeyError, match="no live artifact"):
        router.artifact("ghost")


# ---------------------------------------------------------------------------
# Status schema
# ---------------------------------------------------------------------------

def test_status_report_passes_the_reference_validator():
    front = Frontend(cpu_router()).start()
    try:
        front.submit_wait(Request(graph=g_("er20"), r=2, s=3, artifact="a"))
        front.submit_wait(Request(graph=g_("er20"), r=2, s=3))
        status = status_report(front)
        assert jserve.validate_status(status) is status
        assert validate_status(status) is status
        assert status["format"] == jserve.STATUS_FORMAT
        assert status["frontend"]["served"] == 2
        pool = status["pools"][0]
        assert pool["stats"]["decompositions"] == 2
        assert pool["hit_rate"] == pytest.approx(0.5)
        assert pool["build"]["build"] == "eager"
        assert status["artifacts"]["a"]["version"] == 0
        json.dumps(status)
    finally:
        front.stop()


@pytest.mark.parametrize("drift,path", [("served", "frontend.served"),
                                        ("format", "format")])
def test_validate_status_names_the_drifted_field(drift, path):
    front = Frontend(cpu_router()).start()
    try:
        status = status_report(front)
        if drift == "served":
            del status["frontend"]["served"]
        else:
            status["format"] = "nope"
        for validate in (validate_status, jserve.validate_status):
            with pytest.raises(ValueError, match=path):
                validate(status)
    finally:
        front.stop()


# ---------------------------------------------------------------------------
# HTTP surface
# ---------------------------------------------------------------------------

def _post(host, port, route, payload, timeout=300):
    req = urllib.request.Request(
        f"http://{host}:{port}{route}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def test_httpd_end_to_end():
    server = NucleusHTTPServer(Frontend(cpu_router()))
    host, port = server.start()
    try:
        g = g_("two_triangles")
        art = _post(host, port, "/decompose",
                    {"n": g.n, "edges": g.edges.numpy().tolist(),
                     "r": 2, "s": 3, "artifact": "web"})
        assert art["artifact"] == "web" and art["version"] == 0
        assert art["plan"] and "backend" in art["plan"]
        cut = _post(host, port, "/query",
                    {"artifact": "web", "kind": "cut", "c": 1})
        assert len(cut["cut"]) == art["n_r"]
        nuc = _post(host, port, "/query",
                    {"artifact": "web", "kind": "nuclei", "c": 1})
        assert nuc["nuclei"]
        upd = _post(host, port, "/update",
                    {"artifact": "web", "insert": [[0, 4]]})
        assert upd["version"] == 1
        with urllib.request.urlopen(
                f"http://{host}:{port}/status", timeout=300) as resp:
            status = jserve.validate_status(json.loads(resp.read()))
        assert status["artifacts"]["web"]["version"] == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(host, port, "/query",
                  {"artifact": "ghost", "kind": "cut", "c": 1})
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(host, port, "/decompose", {"n": 3})  # no edges
        assert ei.value.code == 400
    finally:
        server.stop()


@pytest.mark.parametrize("reject", [413, 429])
def test_httpd_typed_rejections(reject):
    """Over-budget admission is 413 (with the computed bytes), a full
    queue 429, as the reference maps them."""
    if reject == 413:
        front = Frontend(cpu_router(), admission_budget_bytes=16)
    else:
        front = Frontend(cpu_router(), max_queue=1)
    server = NucleusHTTPServer(front)
    if reject == 429:
        # no worker drains: one queued job fills the queue
        front._worker = threading.current_thread()
        front.submit(Request(graph=g_("triangle"), r=1, s=2))
    host, port = server.start()
    try:
        g = g_("er20")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(host, port, "/decompose",
                  {"n": g.n, "edges": g.edges.numpy().tolist(),
                   "r": 2, "s": 3})
        assert ei.value.code == reject
        body = json.loads(ei.value.read())
        if reject == 413:
            assert body["plan_bytes"] > body["budget_bytes"] == 16
        else:
            assert "queue full" in body["error"]
    finally:
        if reject == 429:
            front._worker = None
        server.stop()


# ---------------------------------------------------------------------------
# The launch lanes
# ---------------------------------------------------------------------------

def test_warm_pool_counts_match_the_reference(monkeypatch):
    """``serve_nucleus_warm_pool()`` at its defaults: the same graphs,
    pools, warm hits and buckets as the reference's (whose graph
    canonicalization and incidence build are fed the port's arrays: its
    jnp ``make_graph`` and eager build compile per op and shape;
    tests/test_torch_graph.py holds the port's ``make_graph`` to it)."""
    got = launch.serve_nucleus_warm_pool(quiet=True, device="cpu")

    def make_graph_from_port(n, edges):
        pg = make_graph(n, np.asarray(edges), device="cpu")
        return JGraph(n=n, edges=jnp.asarray(pg.edges.numpy()))

    monkeypatch.setattr(jgenerators, "make_graph", make_graph_from_port)

    def build_from_port(g, r, s, **kw):
        p = build_problem(make_graph(g.n, np.asarray(g.edges),
                                     device="cpu"), r, s, device="cpu")
        return JProblem(g=g, r=r, s=s, orientation=p.orientation,
                        **{f: jnp.asarray(getattr(p, f).numpy())
                           for f in FIELDS})

    monkeypatch.setattr(jincidence, "build_problem", build_from_port)
    from repro.launch.serve import serve_nucleus_warm_pool
    want = serve_nucleus_warm_pool(quiet=True)
    for key in ("graphs", "queries", "configs", "warm_hits", "n_buckets"):
        assert got[key] == want[key], key
    assert len(got["pools"]) == len(want["pools"])
    assert [p["stats"] for p in got["pools"]] == \
        [p["stats"] for p in want["pools"]]


def test_server_selftest_and_restart_on_cpu(tmp_path):
    before = _build.BUILD_DIR
    try:
        first = launch.serve_nucleus_server(
            selftest=True, cache_dir=str(tmp_path), quiet=True,
            device="cpu")
        assert first["warm_hits"] >= 1 and first["prewarmed"] == 0
        second = launch.serve_nucleus_server(
            selftest=True, cache_dir=str(tmp_path), quiet=True,
            device="cpu")
        assert second["prewarmed"] == 2 and second["warm_hits"] == 3
    finally:
        _build.set_build_dir(before)
    stats = launch.serve_nucleus(n_queries=8, quiet=True, device="cpu")
    assert stats["queries"] == 8 and stats["n_r"] > 0


def test_lanes_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: launch.serve_nucleus(quiet=True),
                 lambda: launch.serve_nucleus_warm_pool(quiet=True),
                 lambda: launch.serve_nucleus_server(selftest=True,
                                                     quiet=True),
                 lambda: Router(), lambda: Frontend(),
                 lambda: launch.serve_din(n_batches=1, quiet=True)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
