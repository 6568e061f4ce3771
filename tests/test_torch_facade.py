"""repro_torch.decompose over every single-device configuration, against
repro.decompose and the golden fixtures, and the JSON artifact.

* Parity: on the (2,3) goldens and on one (1,2) and one (3,4) golden,
  every legal non-sharded (method, backend, hierarchy) triple of the port
  equals the reference's ``decompose`` on the same incidence arrays:
  ``core``, ``rounds``, ``order_round``, ``peel_value``, the forest, the
  tree's ``parent``/``level`` and ``cut`` at every level, bit for bit.
  Each sharded triple (over three CPU slabs) equals the port's dense
  triple of the same method and hierarchy, itself held to the reference
  (the reference's sharded backend does not run under this jax).
* Fixtures: on all 24 ``tests/golden/*.json`` every exact triple gives the
  fixture's core and partitions; every approx triple stays within the
  approximation bound of the fixture's core.
* The k-core lane: ``fast_lane=True`` equals the generic engine on every
  (1,2) golden and on a seeded ``community_power_law`` graph, exact and
  approx, with the hierarchy; on CPU tensors its decrement is the segment
  sum's plain twin.
* JSON: the port's ``to_json()`` is byte-identical to the reference's for
  dense/fused, gather/replay and nh/two_phase; artifacts cross-load in
  both directions with equal ``cut``/``nuclei``; version-1 artifacts load.

The reference runs as its own tests run it on the CPU.  Its results are
computed once per cell and shared by the tests of this file, and its eager
gather peel loop, a pure function of the problem and the schedule, runs
once per cell and method for the triples that differ only in their
hierarchy (each triple's hierarchy is still the reference's own).  It
runs on a pool of threads, ahead of the tests that read it.
"""
import json
import threading
from concurrent.futures import Future, ThreadPoolExecutor, wait
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.peel as jpeel
from repro.core.api import Decomposition as JDecomposition
from repro.core.incidence import NucleusProblem as JProblem
from repro.graph.container import Graph as JGraph
from repro.graph.generators import GOLDEN_RS

import repro_torch.core.kcore as kcore_mod
from repro_torch import Decomposition, NucleusConfig, decompose
from repro_torch.core import (build_problem, canonicalize_labels,
                              exact_coreness, approx_coreness)
from repro_torch.core.peel import _gather_incident_sids
from repro_torch.graph.generators import community_power_law, golden_suite
from repro_torch.launch.mesh import Mesh

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

pytestmark = pytest.mark.fast

FIELDS = ("r_cliques", "inc_rid", "mem_offsets", "mem_sids", "deg0")
GRAPHS = sorted(golden_suite())
# er20 and planted40 at (2,3), the costliest cells on the reference side,
# run the same check in tests/test_torch_backends.py
HEAVY = ("er20", "planted40")
PARITY_CELLS = [(g, 2, 3) for g in GRAPHS if g not in HEAVY] + \
    [("fig1", 1, 2), ("fig1", 3, 4)]
LOCAL = NucleusConfig.legal_combinations()
# the sharded triples' mesh: three slabs, so every cell splits its rows
SHARDED_MESH = Mesh(("cpu",) * 3)
JSON_TRIPLES = [("exact", "dense", "fused"), ("exact", "gather", "replay"),
                ("exact", "nh", "two_phase")]
_PEEL_LOOP = jpeel._peel_loop
# The reference's side of a cell costs mostly XLA compiles of its eager
# ops at new shapes, which release the interpreter lock: it runs on a few
# threads, a cell's work submitted when a test first asks for a cell of
# its file, while the main thread checks the port.
_POOL = ThreadPoolExecutor(max_workers=4, thread_name_prefix="reference")
_SUBMITTED = []
_LOCK = threading.Lock()
_MEMO = {}


def _once(key, fn, keep=None):
    """``fn()``, computed once per ``key`` whichever thread asks first;
    the others wait for it (and see its exception).  ``keep`` is held
    beside the value (an object whose ``id`` is part of the key)."""
    with _LOCK:
        entry = _MEMO.get(key)
        owner = entry is None
        if owner:
            entry = _MEMO[key] = (keep, Future())
    fut = entry[1]
    if owner:
        try:
            fut.set_result(fn())
        except BaseException as e:
            fut.set_exception(e)
            raise
    return fut.result()


def _shared_peel_loop(problem, schedule):
    """The reference's ``_peel_loop``, run once per (problem, schedule):
    its eager loop compiles and dispatches every op of every round, the
    costliest part of a cell, and gather/none, /replay, /two_phase and
    /basic all peel alike."""
    return _once(("peel", id(problem), schedule),
                 lambda: _PEEL_LOOP(problem, schedule), keep=problem)


@pytest.fixture(autouse=True, scope="module")
def reference_pool():
    """The shared peel loop in place of the reference's for the module's
    tests (patched once: the pool's threads call it concurrently); at
    the end, pending reference work is dropped and running work waited
    for.  A failed task's exception is read by the test that asks for
    its result (``_once``)."""
    with mock.patch.object(jpeel, "_peel_loop", _shared_peel_loop):
        yield
        for f in _SUBMITTED:
            f.cancel()
        wait(_SUBMITTED)
        _SUBMITTED.clear()


def _cell(gname, r, s):
    """(port problem, reference problem on the same arrays), built once."""
    def build():
        g = golden_suite()[gname](device="cpu")
        pp = build_problem(g, r, s, device="cpu")
        jp = JProblem(g=JGraph(n=g.n, edges=jnp.asarray(g.edges.numpy())),
                      r=r, s=s,
                      **{f: jnp.asarray(getattr(pp, f).numpy())
                         for f in FIELDS},
                      orientation=pp.orientation)
        return pp, jp
    return _once(("cell", gname, r, s), build)


def _reference(gname, r, s, triple):
    """The reference's decompose of a non-sharded triple, once."""
    m, b, h = triple
    return _once(("ref", gname, r, s, triple), lambda: jcore.decompose(
        _cell(gname, r, s)[1],
        jcore.NucleusConfig(r=r, s=s, method=m, backend=b, hierarchy=h)))


def _pair(gname, r, s, triple):
    """(port decomposition, what it is held to): the reference's
    decompose, or for a sharded triple the port's dense one."""
    def run():
        pp = _cell(gname, r, s)[0]
        m, b, h = triple
        if b == "sharded":
            got = decompose(pp, NucleusConfig(
                r=r, s=s, method=m, backend=b, hierarchy=h,
                mesh=SHARDED_MESH), device="cpu")
            return got, _pair(gname, r, s, (m, "dense", h))[0]
        got = decompose(pp, NucleusConfig(r=r, s=s, method=m, backend=b,
                                          hierarchy=h), device="cpu")
        return got, _reference(gname, r, s, triple)
    return _once(("pair", gname, r, s, triple), run)


def _ref_tree(gname, r, s, want):
    """The reference's tree.  A two_phase/basic tree is a function of the
    problem and the core alone, so equal cores share one tree (the
    reference builds it per level with jitted connectivity, the costliest
    step here)."""
    h = want.config.hierarchy
    if h not in ("two_phase", "basic"):
        return want.tree
    key = ("tree", gname, r, s, h,
           np.asarray(want.core).astype(np.int64).tobytes())
    return _once(key, lambda: want.tree)


def _reference_work(gname, r, s, triples):
    """The reference's decompose of each triple in order, and its
    two_phase or basic tree (a fused or replay tree is left to the test:
    building one fills the decomposition's forest, which the test reads
    first)."""
    for triple in triples:
        want = _reference(gname, r, s, triple)
        if triple[2] in ("two_phase", "basic"):
            _ref_tree(gname, r, s, want)


def _prefetch(cells):
    """Submit the reference's work of each cell not yet submitted, in
    order: first each method's gather triples as one task (their shared
    peel loop is the longest), then every dense and nh triple alone."""
    for gname, r, s in cells:
        with _LOCK:
            if ("prefetch", gname, r, s) in _MEMO:
                continue
            _MEMO[("prefetch", gname, r, s)] = None
        local = [t for t in LOCAL if t[1] != "sharded"]
        tasks = [[t for t in local if t[:2] == (m, "gather")]
                 for m in ("exact", "approx")]
        tasks += [[t] for t in local if t[1] != "gather"]
        _SUBMITTED.extend(_POOL.submit(_reference_work, gname, r, s, task)
                          for task in tasks)


def _opt(x):
    return None if x is None else np.asarray(x)


def check_cell(gname, r, s, prefetch=()):
    """Every local triple of the port == the reference's decompose; every
    sharded triple == the port's dense one.  The reference's work of this
    cell, then of the ``prefetch`` cells, starts on the pool."""
    _prefetch([(gname, r, s), *prefetch])
    pp = _cell(gname, r, s)[0]
    if pp.n_r == 0:
        pytest.skip("no r-cliques")
    assert len(LOCAL) == 29
    for triple in sorted(LOCAL, key=lambda t: (t[1] == "sharded",
                                               t[1] != "nh")):
        label = "/".join(triple)
        sharded = triple[1] == "sharded"
        got, want = _pair(gname, r, s, triple)
        assert got.rounds == want.rounds, label
        assert type(got.rounds) is int
        fields = ("core", "order_round", "peel_value", "uf_parent", "uf_L")
        if sharded:
            # no trace; an unfused peel_value is the clipped core, as the
            # reference's sharded backend returns it
            assert got.order_round is None, label
            fields = ("core", "uf_parent", "uf_L") + (
                ("peel_value",) if triple[2] == "fused" else ())
        for f in fields:
            a, b = _opt(getattr(got, f)), _opt(getattr(want, f))
            assert (a is None) == (b is None), f"{label}: {f}"
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{label}: {f}")
        if not sharded:
            assert got.plan.reasons == want.plan.reasons, label
        if triple[2] == "none":
            with pytest.raises(ValueError, match="hierarchy='none'"):
                got.tree
            continue
        tree = want.tree if sharded else _ref_tree(gname, r, s, want)
        np.testing.assert_array_equal(got.tree.parent, tree.parent,
                                      err_msg=f"{label}: tree parent")
        np.testing.assert_array_equal(got.tree.level, tree.level,
                                      err_msg=f"{label}: tree level")
        for c in sorted(set(int(x) for x in want.peel_value if x > 0)):
            np.testing.assert_array_equal(got.cut(c),
                                          tree.ancestor_at_level(c),
                                          err_msg=f"{label}: cut({c})")
        if triple[2] == "replay":
            assert got.link_stats == want.link_stats, label


@pytest.mark.parametrize("gname,r,s", PARITY_CELLS,
                         ids=[f"{g}_r{r}s{s}" for g, r, s in PARITY_CELLS])
def test_every_local_triple_matches_reference(gname, r, s):
    check_cell(gname, r, s, prefetch=PARITY_CELLS)


FIXTURES = sorted(f"{g}_r{r}s{s}.json" for g in GRAPHS for r, s in GOLDEN_RS)


def _load_fixture(fname):
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", fname)
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("fname", FIXTURES)
def test_every_local_triple_reproduces_golden_fixture(fname):
    fx = _load_fixture(fname)
    r, s = fx["r"], fx["s"]
    problem = build_problem(golden_suite()[fx["graph"]](device="cpu"), r, s,
                            device="cpu")
    assert problem.n_r == fx["n_r"]
    if problem.n_r == 0:
        return
    core = np.asarray(fx["core"])
    deg0 = problem.deg0.numpy()
    for (m, b, h) in LOCAL:
        mesh = SHARDED_MESH if b == "sharded" else None
        dec = decompose(problem, NucleusConfig(r=r, s=s, method=m,
                                               backend=b, hierarchy=h,
                                               mesh=mesh),
                        device="cpu")
        label = f"{fname} {m}/{b}/{h}"
        if m == "approx":
            # an estimate is >= the true core and clipped to deg0
            assert (core <= dec.core).all() and (dec.core <= deg0).all(), \
                label
            continue
        np.testing.assert_array_equal(dec.core, core, err_msg=label)
        if h == "none":
            continue
        for c, want in fx["partitions"].items():
            np.testing.assert_array_equal(
                canonicalize_labels(dec.cut(int(c))), want,
                err_msg=f"{label}: cut({c})")


# ---------------------------------------------------------------------------
# The k-core lane
# ---------------------------------------------------------------------------

def _lane_problems():
    for g in GRAPHS:
        yield g, golden_suite()[g](device="cpu")
    yield "cpl300", community_power_law(300, seed=3, device="cpu")


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_kcore_lane_equals_generic_engine(method, monkeypatch):
    calls = {"plain": 0}
    plain = kcore_mod.segment_sum_plain

    def counting_plain(*a):
        calls["plain"] += 1
        return plain(*a)
    monkeypatch.setattr(kcore_mod, "segment_sum_plain", counting_plain)
    peel = exact_coreness if method == "exact" else approx_coreness
    n_lane_rounds = 0
    for name, g in _lane_problems():
        problem = build_problem(g, 1, 2, device="cpu")
        lane = peel(problem, hierarchy=True, fast_lane=True, device="cpu")
        generic = peel(problem, hierarchy=True, fast_lane=False,
                       device="cpu")
        assert lane.rounds == generic.rounds, name
        for f in ("core", "order_round", "peel_value", "uf_parent", "uf_L"):
            np.testing.assert_array_equal(getattr(lane, f).numpy(),
                                          getattr(generic, f).numpy(),
                                          err_msg=f"{name}: {f}")
        if g.m:
            n_lane_rounds += lane.rounds
    # on CPU tensors every lane round's decrement is the plain twin
    assert calls["plain"] == n_lane_rounds > 0


def test_kcore_routing_rule(monkeypatch):
    """(1, 2) dense peels take the lane unless use_kernel=True; the plan
    reasons say which."""
    taken = []
    real = kcore_mod.kcore_coreness
    import repro_torch.core.peel as peel_mod

    def spy(*a, **kw):
        taken.append(True)
        return real(*a, **kw)
    monkeypatch.setattr(peel_mod, "kcore_coreness", spy)
    g = golden_suite()["planted40"](device="cpu")
    lane = decompose(g, NucleusConfig(r=1, s=2), device="cpu")
    assert taken == [True]
    assert any(x.startswith("fast lane 'kcore'") for x in lane.plan.reasons)
    pinned = decompose(g, NucleusConfig(r=1, s=2, use_kernel=True),
                       device="cpu")
    assert taken == [True]
    assert any("not taken" in x for x in pinned.plan.reasons)
    for f in ("core", "order_round", "uf_parent", "uf_L"):
        np.testing.assert_array_equal(getattr(lane, f), getattr(pinned, f))
    decompose(g, NucleusConfig(r=2, s=3), device="cpu")
    assert taken == [True]


@pytest.mark.parametrize("gname", ["fig1", "planted40"])
def test_oracles_and_baselines_match_reference(gname):
    """nh_full / nh_hierarchy / brute_force_coreness, the no-hierarchy
    baseline, cut_hierarchy, same_partition and build_hierarchy_interleaved
    against the reference's and the facade's on the same arrays."""
    from repro.core import nh_baseline as jnh
    from repro.core import nuclei as jnuclei
    from repro_torch.core import (brute_force_coreness,
                                  build_hierarchy_interleaved, cut_hierarchy,
                                  nh_full, nuclei_without_hierarchy,
                                  same_partition)
    pp, jp = _cell(gname, 2, 3)
    core, tree, rho = nh_full(pp)
    jcore_, jtree, jrho = jnh.nh_full(jp)
    assert rho == jrho
    np.testing.assert_array_equal(core, jcore_)
    np.testing.assert_array_equal(tree.parent, jtree.parent)
    np.testing.assert_array_equal(tree.level, jtree.level)
    np.testing.assert_array_equal(brute_force_coreness(pp), core)
    got, _ = _pair(gname, 2, 3, ("exact", "dense", "fused"))
    for link in ("replay", "fused"):
        inter = build_hierarchy_interleaved(pp, link=link, device="cpu")
        np.testing.assert_array_equal(inter.tree.parent, got.tree.parent)
        np.testing.assert_array_equal(inter.tree.level, got.tree.level)
    for c in sorted(set(int(x) for x in core if x > 0)):
        base = nuclei_without_hierarchy(pp, core, c)
        np.testing.assert_array_equal(
            base, jnuclei.nuclei_without_hierarchy(jp, jnp.asarray(core), c))
        assert same_partition(base, cut_hierarchy(got.tree, c))
        assert not same_partition(base, np.full_like(base, -1))


def test_gather_loop_touches_nothing_when_empty():
    problem = build_problem(golden_suite()["path4"](device="cpu"), 2, 3,
                            device="cpu")
    import torch
    assert _gather_incident_sids(
        problem, torch.zeros((0,), dtype=torch.int64)).numel() == 0
    res = exact_coreness(problem, backend="gather", device="cpu")
    assert res.rounds == (1 if problem.n_r else 0)


# ---------------------------------------------------------------------------
# The JSON artifact
# ---------------------------------------------------------------------------

JSON_CASES = [(g, t) for g in GRAPHS if g not in HEAVY
              for t in JSON_TRIPLES]


@pytest.mark.parametrize("gname,triple", JSON_CASES,
                         ids=[f"{g}-{t[1]}-{t[2]}" for g, t in JSON_CASES])
def test_to_json_is_byte_identical_to_reference(gname, triple):
    check_json(gname, triple)


def check_json(gname, triple):
    if _cell(gname, 2, 3)[0].n_r == 0:
        pytest.skip("no r-cliques")
    got, want = _pair(gname, 2, 3, triple)
    blob = got.to_json()
    assert blob == want.to_json()
    assert Decomposition.from_json(blob).to_json() == blob


def _same_queries(a, b, label):
    for c in sorted(set(int(x) for x in a.core if x > 0)):
        np.testing.assert_array_equal(a.cut(c), b.cut(c),
                                      err_msg=f"{label}: cut({c})")
        na, nb = a.nuclei(c), b.nuclei(c)
        assert sorted(na) == sorted(nb), label
        for lab in na:
            np.testing.assert_array_equal(na[lab].vertices, nb[lab].vertices)
            assert na[lab].n_r_cliques == nb[lab].n_r_cliques
            assert na[lab].density == nb[lab].density


@pytest.mark.parametrize("gname", ["bowtie_plus", "fig1", "k4"])
def test_artifacts_cross_load(gname):
    got, want = _pair(gname, 2, 3, ("exact", "dense", "fused"))
    port_in_ref = JDecomposition.from_json(got.to_json())
    ref_in_port = Decomposition.from_json(want.to_json())
    assert port_in_ref.problem is None and ref_in_port.problem is None
    _same_queries(port_in_ref, got, f"{gname}: port artifact in repro")
    _same_queries(ref_in_port, want, f"{gname}: repro artifact in port")
    assert ref_in_port.plan == got.plan
    assert ref_in_port.to_json() == want.to_json()


def test_json_reads_version1_and_rejects_foreign_blobs():
    got, _ = _pair("two_triangles", 2, 3, ("exact", "dense", "fused"))
    d = json.loads(got.to_json())
    d["version"] = 1
    d.pop("plan")
    loaded = Decomposition.from_json(json.dumps(d))
    assert loaded.plan is None
    assert "not recorded" in loaded.plan_report()
    np.testing.assert_array_equal(loaded.core, got.core)
    for c in sorted(set(int(x) for x in got.core if x > 0)):
        np.testing.assert_array_equal(loaded.cut(c), got.cut(c))
    for bad in (99, "2", None):
        d["version"] = bad
        with pytest.raises(ValueError, match="unsupported Decomposition"):
            Decomposition.from_json(json.dumps(d))
    with pytest.raises(ValueError, match="format"):
        Decomposition.from_json('{"format": "something-else"}')


def test_save_load_roundtrip(tmp_path):
    got, _ = _pair("fig1", 2, 3, ("exact", "gather", "replay"))
    path = str(tmp_path / "fig1.json")
    got.save(path)
    loaded = Decomposition.load(path)
    assert loaded.to_json() == got.to_json()
    assert loaded.name is None and loaded.version == 0
    _same_queries(loaded, got, "fig1 save/load")
