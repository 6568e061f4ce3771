"""repro_torch's backend registry, legality matrix and planner against the
reference's (``repro.core.backends``).

* The registry: the same four backends in the same order with the same
  capabilities, and ``legal_combinations()`` equal to the reference's 29
  triples literally (``tests/test_backends.py`` pins the same list).
* Validation: each error of ``tests/test_facade.py::
  test_config_validation_errors_are_actionable`` has a port counterpart
  raising ``ConfigError`` on the same config; the sharded pieces, once
  refused, run and equal the dense path (``NOT_PORTED`` is empty).
* The planner: on a grid of facts (n_r across the tiny threshold, budgets
  above and below the dense round bytes, cpu vs an accelerator, (1,2) vs
  (2,3), every hierarchy including 'auto') the port's ``resolve_plan``
  picks the reference's (backend, hierarchy) from the same profile file;
  explicit configs carry the reference's reasons word for word.
* The planner profile: the port reads its own file, which has no entries,
  so the static thresholds apply.
* ``backend='auto'`` through ``decompose``: the plan, the build upgrade
  under a budget, and arrays equal to the explicit resolved triple.
* Conformance: every local triple, and the JSON artifact, against the
  reference on er20 and planted40 at (2,3) (the parity checks of
  ``tests/test_torch_facade.py`` on its two costliest cells).
"""
import itertools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.backends as JB
import repro.core.planner_profile as JPP
from repro.core.api import NucleusConfig as JConfig
from repro.core.api import decompose as j_decompose
from repro.core.incidence import NucleusProblem as JProblem
from repro.distbuild import estimate_eager_build_bytes as j_estimate
from repro.graph.container import Digraph as JDigraph, Graph as JGraph

import repro_torch.core.backends as B
import repro_torch.core.planner_profile as PP
from repro_torch import ConfigError, NucleusConfig, decompose
from repro_torch.core import build_problem
from repro_torch.core.api import NOT_PORTED
from repro_torch.core.incidence import INCIDENCE_FIELDS, pick_rank
from repro_torch.distbuild import estimate_eager_build_bytes
from repro_torch.graph.generators import golden_suite
from repro_torch.launch.mesh import Mesh

# the facade file's parity checks, run here on its two costliest cells
from test_torch_facade import HEAVY, JSON_TRIPLES, check_cell, check_json
# the reference's shared peel loop and its pool, for this module's tests
from test_torch_facade import reference_pool  # noqa: F401

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's matrix, pinned literally as tests/test_backends.py does
EXPECTED_LEGAL = [
    ("exact", "dense", "none"), ("exact", "dense", "fused"),
    ("exact", "dense", "replay"), ("exact", "dense", "two_phase"),
    ("exact", "dense", "basic"),
    ("exact", "gather", "none"), ("exact", "gather", "replay"),
    ("exact", "gather", "two_phase"), ("exact", "gather", "basic"),
    ("exact", "sharded", "none"), ("exact", "sharded", "fused"),
    ("exact", "sharded", "two_phase"), ("exact", "sharded", "basic"),
    ("exact", "nh", "none"), ("exact", "nh", "two_phase"),
    ("exact", "nh", "basic"),
    ("approx", "dense", "none"), ("approx", "dense", "fused"),
    ("approx", "dense", "replay"), ("approx", "dense", "two_phase"),
    ("approx", "dense", "basic"),
    ("approx", "gather", "none"), ("approx", "gather", "replay"),
    ("approx", "gather", "two_phase"), ("approx", "gather", "basic"),
    ("approx", "sharded", "none"), ("approx", "sharded", "fused"),
    ("approx", "sharded", "two_phase"), ("approx", "sharded", "basic"),
]


@pytest.fixture(autouse=True)
def _fresh_profile_caches():
    PP.reset_cache()
    JPP.reset_cache()
    yield
    PP.reset_cache()
    JPP.reset_cache()


def _port_kw(kw):
    """The port's spelling of a reference config: use_pallas is
    use_kernel."""
    kw = dict(kw)
    if "use_pallas" in kw:
        kw["use_kernel"] = kw.pop("use_pallas")
    return kw


# ---------------------------------------------------------------------------
# Registry + derived legality
# ---------------------------------------------------------------------------

def test_legal_combinations_equal_the_reference():
    assert NucleusConfig.legal_combinations() == EXPECTED_LEGAL
    assert NucleusConfig.legal_combinations() == \
        JConfig.legal_combinations()


def test_registry_matches_the_reference():
    assert B.names() == JB.names() == ("dense", "gather", "sharded", "nh")
    for name in B.names():
        got, want = B.get(name).capabilities, JB.get(name).capabilities
        assert isinstance(B.get(name), B.Backend)
        for field in ("methods", "compiled_peel", "records_trace", "knobs",
                      "fast_lanes", "hierarchies"):
            assert getattr(got, field) == getattr(want, field), \
                (name, field)


# (config, the reference test's match word, the port's match word)
VALIDATION_CASES = [
    (dict(r=3, s=2), "1 <= r < s", "1 <= r < s"),
    (dict(backend="gather", hierarchy="fused"), "no compiled loop to fuse",
     "no compiled loop to fuse"),
    (dict(backend="sharded", hierarchy="replay"), "peel trace",
     "peel trace"),
    (dict(backend="nh", method="approx", hierarchy="none"),
     "sequential exact baseline", "sequential exact baseline"),
    (dict(backend="gather", hierarchy="none", use_pallas=True), "Pallas",
     "use_kernel=True"),
    (dict(method="approx", delta=0.0), "delta > 0", "delta > 0"),
    (dict(compress=True), "compress", "compress"),
    (dict(mesh=object(), backend="dense"), "mesh", "mesh"),
]


@pytest.mark.parametrize("kw,ref_word,word", VALIDATION_CASES,
                         ids=[str(i) for i in range(len(VALIDATION_CASES))])
def test_validation_errors_match_the_reference(kw, ref_word, word):
    with pytest.raises(JB.ConfigError, match=ref_word):
        JConfig(**kw).validate()
    with pytest.raises(ConfigError, match=word):
        NucleusConfig(**_port_kw(kw)).validate()


@pytest.mark.parametrize("kw", [
    dict(backend="cuda"), dict(hierarchy="bogus"),
    dict(backend="nh", hierarchy="fused"),
    dict(backend="nh", hierarchy="replay"),
    dict(backend="sharded", use_pallas=True, hierarchy="none"),
    dict(backend="gather", compress=True, hierarchy="none"),
    dict(backend="nh", mesh=object(), hierarchy="none"),
    dict(backend="auto", use_pallas=True, compress=True),
    dict(memory_budget_bytes=1 << 20),
    dict(build="chunked", build_chunk_size=0),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()
                           if k != "mesh"))
def test_illegal_configs_raise_in_both(kw):
    with pytest.raises(JB.ConfigError) as want:
        JConfig(**kw).validate()
    with pytest.raises(ConfigError) as got:
        NucleusConfig(**_port_kw(kw)).validate()
    if "backend" in kw and kw["backend"] not in ("auto", "cuda"):
        assert kw["backend"] in str(got.value)
    if "use_pallas" not in kw:
        assert str(got.value) == str(want.value)


def test_sharded_pieces_raise_not_yet_ported():
    """Each config the port once refused as "not yet ported" now runs and
    gives the dense path's arrays; ``NOT_PORTED`` is empty."""
    g = golden_suite()["k4"](device="cpu")
    want = decompose(g, NucleusConfig(), device="cpu")
    for kw in (dict(backend="sharded"), dict(build="sharded"),
               dict(backend="sharded", compress=True),
               dict(backend="sharded", hierarchy="none",
                    mesh=Mesh(("cpu",) * 2)),
               dict(build="sharded", build_shards=2)):
        got = decompose(g, NucleusConfig(**kw), device="cpu")
        assert got.rounds == want.rounds
        np.testing.assert_array_equal(got.core, want.core)
        if got.uf_parent is not None:
            np.testing.assert_array_equal(got.uf_parent, want.uf_parent)
            np.testing.assert_array_equal(got.uf_L, want.uf_L)
    assert NOT_PORTED == ()


def test_config_dict_has_the_reference_keys():
    """to_dict writes the reference's key set (use_kernel as use_pallas,
    no mesh), so a port config loads in the reference and back."""
    for kw in (dict(), dict(method="approx", delta=0.5, backend="gather",
                            hierarchy="replay"),
               dict(use_pallas=True, build="chunked",
                    memory_budget_bytes=1 << 20, build_chunk_size=8)):
        port = NucleusConfig(**_port_kw(kw))
        ref = JConfig(**kw)
        assert port.to_dict() == ref.to_dict()
        assert JConfig.from_dict(port.to_dict()) == ref
        assert NucleusConfig.from_dict(ref.to_dict()) == port


# ---------------------------------------------------------------------------
# The planner against the reference's on a grid of facts
# ---------------------------------------------------------------------------

def _write_profile(tmp_path, profiles):
    path = tmp_path / "prof.json"
    path.write_text(json.dumps({"format": PP.FORMAT, "version": PP.VERSION,
                                "profiles": profiles}))
    return str(path)


GRID_AXES = [(kind, rs, method) for kind in ("cpu", "cuda")
             for rs in ((1, 2), (2, 3)) for method in ("exact", "approx")]


@pytest.mark.parametrize("kind,rs,method", GRID_AXES,
                         ids=[f"{k}-r{rs[0]}s{rs[1]}-{m}"
                              for k, rs, m in GRID_AXES])
def test_planner_grid_matches_the_reference(tmp_path, kind, rs, method):
    """Same profile file, same facts -> same (backend, hierarchy); the
    profile moves the cpu tiny threshold to 200 so n_r crosses it."""
    path = _write_profile(tmp_path, {"cpu": {"tiny_nr": 200}})
    r, s = rs
    n_sub = 2 if rs == (1, 2) else 3
    n_s = 1000
    dense_bytes = B.DENSE_ROUND_BYTES_PER_ENTRY * n_s * n_sub
    checked = 0
    for backend, hierarchy, n_r, budget, use_pallas in itertools.product(
            ("auto", "dense", "gather", "nh"),
            ("auto", "none", "fused", "replay", "two_phase", "basic"),
            (10, 199, 200, 5000),
            (None, dense_bytes - 1, dense_bytes + 1),
            (None, True)):
        kw = dict(r=r, s=s, method=method, backend=backend,
                  hierarchy=hierarchy, use_pallas=use_pallas,
                  memory_budget_bytes=budget,
                  build="eager" if budget is None else "chunked")
        facts = dict(n_r=n_r, n_s=n_s, n_sub=n_sub, device_kind=kind,
                     n_devices=1, r=r, s=s, profile_path=path)
        try:
            JConfig(**kw).validate()
        except JB.ConfigError:
            with pytest.raises(ConfigError):
                NucleusConfig(**_port_kw(kw)).validate()
            continue
        port_cfg = NucleusConfig(**_port_kw(kw)).validate()
        want = JB.resolve_plan(JConfig(**kw), **facts)
        got = B.resolve_plan(port_cfg, **facts)
        label = f"{kw} {facts}"
        assert (got.backend, got.hierarchy) == \
            (want.backend, want.hierarchy), label
        assert got.was_auto == want.was_auto, label
        if backend != "auto" and use_pallas is None:
            # an explicit config's reasons are the reference's word for word
            assert got.reasons == want.reasons, label
        checked += 1
    assert checked > 200


def test_planner_rules_fire_with_their_reasons():
    def plan(cfg, **facts):
        kw = dict(n_r=1000, n_s=1000, n_sub=3, device_kind="cpu",
                  n_devices=1, profile_path="/nonexistent/profile.json")
        kw.update(facts)
        return B.resolve_plan(cfg, **kw)
    auto = NucleusConfig(backend="auto", hierarchy="auto")
    assert plan(auto, n_r=B.TINY_NR - 1).backend == "gather"
    assert plan(auto, n_r=B.TINY_NR).backend == "dense"
    assert plan(auto, n_r=10, device_kind="cuda").backend == "dense"
    assert plan(NucleusConfig(backend="auto", use_kernel=True),
                n_r=10).backend == "dense"
    assert plan(NucleusConfig(backend="auto", mesh=object())).backend == \
        "sharded"
    small = NucleusConfig(backend="auto", hierarchy="auto",
                          memory_budget_bytes=1 << 10)
    p = plan(small, n_s=100_000)
    assert (p.backend, p.hierarchy) == ("gather", "replay")
    assert any("static defaults" in r for r in p.reasons)
    # the kcore lane: taken at (1, 2) unless use_kernel=True pins the
    # generic megakernel engine
    p12 = plan(NucleusConfig(r=1, s=2), r=1, s=2, n_sub=2)
    assert any(r.startswith("fast lane 'kcore': (r, s) = (1, 2)")
               for r in p12.reasons)
    pk = plan(NucleusConfig(r=1, s=2, use_kernel=True), r=1, s=2, n_sub=2)
    assert any("not taken: use_kernel=True" in r for r in pk.reasons)
    assert not any("kcore" in r for r in plan(NucleusConfig(), r=2,
                                               s=3).reasons)
    rep = p.report()
    assert "backend='gather'" in rep and "requested backend='auto'" in rep


# ---------------------------------------------------------------------------
# The planner profile
# ---------------------------------------------------------------------------

def test_port_profile_is_its_own_and_empty():
    """The committed profile is the port's own: one measured ``cuda``
    entry (keyed by the platform and by the card's name) and no ``cpu``
    entry, so the CPU keeps the static rule the parity tests pin."""
    assert os.path.dirname(PP.PROFILE_PATH) == os.path.join(
        ROOT, "src", "repro_torch", "core")
    blob = PP.load_profile()
    assert blob is not None and blob["format"] == PP.FORMAT
    assert blob["version"] == PP.VERSION
    profiles = blob["profiles"]
    assert "cpu" not in profiles
    entry = profiles["cuda"]
    assert isinstance(entry["tiny_nr"], int) and entry["tiny_nr"] > 0
    assert isinstance(entry["kernel_default"], bool)
    assert "shard_min_incidence" not in entry
    m = entry["measured"]
    assert m["platform"] == "cuda" and m["quick"] is False
    assert m["n_devices"] >= 1 and m["device_name"] in profiles
    assert profiles[m["device_name"]] == entry
    assert m["power_limit"].startswith(m["device_name"] + ", ")
    th = PP.thresholds(device_kind="cuda", platform="cuda")
    assert th == {"tiny_nr": entry["tiny_nr"],
                  "shard_min_incidence": PP.STATIC_SHARD_MIN_INCIDENCE,
                  "source": "planner_profile['cuda']"}
    assert PP.kernel_default("cuda") is entry["kernel_default"]
    assert PP.thresholds(device_kind="cpu", platform="cpu")["source"] == \
        "static defaults"
    with pytest.warns(UserWarning, match="falls back to the static"):
        assert PP.kernel_default("cpu") is None


def test_profile_entries_drive_thresholds_and_kernel_default(tmp_path):
    path = _write_profile(tmp_path, {"cuda": {"tiny_nr": 33,
                                              "kernel_default": False}})
    th = PP.thresholds(device_kind="cuda", path=path)
    assert th["tiny_nr"] == 33 and "planner_profile['cuda']" in th["source"]
    assert th["shard_min_incidence"] == PP.STATIC_SHARD_MIN_INCIDENCE
    assert PP.kernel_default("cuda", path=path) is False
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.warns(UserWarning, match="falling back to the static"):
        assert PP.thresholds(path=str(bad))["source"] == "static defaults"


# ---------------------------------------------------------------------------
# backend='auto' through decompose()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gname", ["er20", "planted40"])
def test_auto_decompose_equals_the_explicit_resolved_triple(gname):
    g = golden_suite()[gname](device="cpu")
    auto = decompose(g, NucleusConfig(backend="auto", hierarchy="auto"),
                     device="cpu")
    assert auto.plan.was_auto
    want_backend = "gather" if auto.n_r < B.TINY_NR else "dense"
    assert auto.config.backend == auto.plan.backend == want_backend
    explicit = decompose(g, NucleusConfig(backend=auto.config.backend,
                                          hierarchy=auto.config.hierarchy),
                         device="cpu")
    assert auto.rounds == explicit.rounds
    for f in ("core", "order_round", "peel_value"):
        np.testing.assert_array_equal(getattr(auto, f),
                                      getattr(explicit, f))
    np.testing.assert_array_equal(auto.tree.parent, explicit.tree.parent)
    np.testing.assert_array_equal(auto.tree.level, explicit.tree.level)
    d = json.loads(auto.to_json())
    assert d["plan"]["requested_backend"] == "auto"
    assert d["config"]["backend"] == auto.plan.backend


def test_auto_upgrades_the_build_under_a_budget():
    """The eager estimate is the reference's; over the budget the build
    becomes 'chunked', the plan says why, and the arrays are the eager
    build's."""
    g = golden_suite()["planted40"](device="cpu")
    dg = pick_rank(g)[0]
    est = estimate_eager_build_bytes(dg, 3)
    # the reference's estimate of the same DAG (pick_rank is held to the
    # reference's in tests/test_torch_incidence.py)
    assert est == j_estimate(JDigraph(n=dg.n, **{
        f: jnp.asarray(getattr(dg, f).numpy())
        for f in ("offsets", "neighbors", "adj", "outdeg")}), 3)
    dec = decompose(g, NucleusConfig(backend="auto",
                                     memory_budget_bytes=est - 1),
                    device="cpu")
    assert dec.config.build == "chunked"
    assert dec.problem.build_stats["eager_estimate_bytes"] == est
    assert any(r.startswith("build 'chunked'") for r in dec.plan.reasons)
    fits = decompose(g, NucleusConfig(backend="auto",
                                      memory_budget_bytes=est),
                     device="cpu")
    assert fits.config.build == "eager"
    # the port's one departure: where the eager build fits, it drops the
    # budget from the resolved eager config; the reference raises
    assert fits.config.memory_budget_bytes is None
    assert fits.plan.backend == "dense"
    # the reference raises in plan_config, after its build: fed the eager
    # arrays (its jnp eager build compiles per op), it raises there alike
    eager = build_problem(g, 2, 3, device="cpu")
    with pytest.raises(JB.ConfigError, match="memory_budget_bytes"):
        j_decompose(JProblem(g=JGraph(n=g.n,
                                      edges=jnp.asarray(g.edges.numpy())),
                             r=2, s=3, orientation=eager.orientation,
                             **{f: jnp.asarray(getattr(eager, f).numpy())
                                for f in INCIDENCE_FIELDS}),
                    JConfig(backend="auto", memory_budget_bytes=est))
    np.testing.assert_array_equal(dec.problem.mem_sids.numpy(),
                                  eager.mem_sids.numpy())
    np.testing.assert_array_equal(dec.core, fits.core)


# ---------------------------------------------------------------------------
# Conformance: every local triple == the reference on the two largest
# (2,3) goldens (the other cells are in tests/test_torch_facade.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gname", HEAVY)
def test_every_local_triple_matches_reference(gname):
    check_cell(gname, 2, 3, prefetch=[(g, 2, 3) for g in HEAVY])


@pytest.mark.parametrize("gname,triple", [(g, t) for g in HEAVY
                                          for t in JSON_TRIPLES],
                         ids=[f"{g}-{t[1]}-{t[2]}" for g in HEAVY
                              for t in JSON_TRIPLES])
def test_to_json_is_byte_identical_to_reference(gname, triple):
    check_json(gname, triple)
