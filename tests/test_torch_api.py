"""repro_torch.decompose: the golden fixtures, parity with repro.decompose,
the config surface and the device policy.

* All 24 ``tests/golden/*.json``: ``decompose(..., device="cpu")`` gives the
  fixture's core numbers and canonical cut partitions (port only).
* The (2,3) goldens, and fig1 and planted40 at (1,2), (2,3) and (3,4)
  exact and approx: every array of the port's default ``Decomposition``
  equals ``repro.decompose``'s on the same incidence arrays, cuts and
  nuclei included (the other configurations: tests/test_torch_facade.py).
* Without a card, an entry point called with no ``device`` raises and names
  ``device="cpu"``.
"""
import json
import os
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core as jcore
from repro.core.incidence import NucleusProblem as JProblem
from repro.graph.container import Graph as JGraph

from repro_torch import ConfigError, NucleusConfig, decompose
from repro_torch.core import (build_problem, canonicalize_labels,
                              dense_coreness, make_schedule)
from repro_torch.graph.generators import golden_suite

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

pytestmark = pytest.mark.fast

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
FIXTURES = sorted(f for f in os.listdir(GOLDEN_DIR) if f.endswith(".json"))
FIELDS = ("r_cliques", "inc_rid", "mem_offsets", "mem_sids", "deg0")


def load(fname):
    with open(os.path.join(GOLDEN_DIR, fname)) as f:
        return json.load(f)


def test_all_golden_fixtures_present():
    assert len(FIXTURES) == 24


@pytest.mark.parametrize("fname", FIXTURES)
def test_decompose_reproduces_golden_fixture(fname):
    fx = load(fname)
    g = golden_suite()[fx["graph"]](device="cpu")
    dec = decompose(g, NucleusConfig(r=fx["r"], s=fx["s"]), device="cpu")
    assert dec.n_r == fx["n_r"]
    assert dec.problem.n_s == fx["n_s"]
    if dec.n_r == 0:
        return
    np.testing.assert_array_equal(dec.core, fx["core"])
    for c, want in fx["partitions"].items():
        np.testing.assert_array_equal(canonicalize_labels(dec.cut(int(c))),
                                      want, err_msg=f"cut level c={c}")


# (2,3) exact on every golden (ids: the graph's name), then approx at
# (2,3) and exact and approx at (1,2) and (3,4) on the graphs with the
# deepest cores (ROADMAP Queue 1.1's coverage)
REFERENCE_CASES = (
    [pytest.param(name, 2, 3, "exact", id=name)
     for name in sorted(golden_suite())] +
    [pytest.param(name, r, s, method, id=f"{name}-r{r}s{s}-{method}")
     for name in ("fig1", "planted40")
     for r, s, method in ((2, 3, "approx"), (1, 2, "exact"),
                          (1, 2, "approx"), (3, 4, "exact"),
                          (3, 4, "approx"))])


def _config(r, s, method):
    cfg = dict(r=r, s=s, method=method)
    if method == "approx":
        cfg["delta"] = 0.5
    return cfg


def _reference_case(name, r, s, method):
    """The reference's side of a case: its ``decompose`` of the port's
    incidence arrays, and its cut and nuclei at every level it peeled."""
    g = golden_suite()[name](device="cpu")
    port_problem = build_problem(g, r, s, device="cpu")
    jp = JProblem(g=JGraph(n=g.n, edges=jnp.asarray(g.edges.numpy())),
                  r=r, s=s,
                  **{f: jnp.asarray(getattr(port_problem, f).numpy())
                     for f in FIELDS},
                  orientation=port_problem.orientation)
    want = jcore.decompose(jp, jcore.NucleusConfig(**_config(r, s, method)))
    levels = sorted(set(int(x) for x in want.peel_value if x > 0))
    return want, {c: (want.cut(c), want.nuclei(c)) for c in levels}


@pytest.fixture(scope="module")
def reference_cases():
    """Every case's reference side, submitted together to a few threads
    when the first case runs (its cost is XLA compiles of the reference's
    programs, which release the interpreter lock) while the main thread
    checks the port; pending work is dropped at the end."""
    with ThreadPoolExecutor(max_workers=4,
                            thread_name_prefix="reference") as pool:
        futures = {tuple(case.values): pool.submit(_reference_case,
                                                   *case.values)
                   for case in REFERENCE_CASES}
        yield futures
        for f in futures.values():
            f.cancel()
        wait(futures.values())


@pytest.mark.parametrize("name,r,s,method", REFERENCE_CASES)
def test_decompose_matches_reference(reference_cases, name, r, s, method):
    want, queries = reference_cases[(name, r, s, method)].result()
    g = golden_suite()[name](device="cpu")
    got = decompose(g, NucleusConfig(**_config(r, s, method)), device="cpu")
    assert got.rounds == want.rounds
    for field in ("core", "order_round", "peel_value", "uf_parent", "uf_L"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    for c, (want_cut, wn) in queries.items():
        np.testing.assert_array_equal(got.cut(c), want_cut,
                                      err_msg=f"cut({c})")
        gn = got.nuclei(c)
        assert sorted(gn) == sorted(wn)
        for lab in gn:
            np.testing.assert_array_equal(gn[lab].vertices,
                                          wn[lab].vertices)
            assert gn[lab].n_r_cliques == wn[lab].n_r_cliques
            assert gn[lab].density == wn[lab].density


@pytest.mark.parametrize("bad,word", [
    ({"build": "chunked", "build_shards": 2},
     "build_shards is the sharded builder's worker count"),
    ({"build": "sharded", "build_shards": 0}, "build_shards must be "
     "positive"),
    ({"backend": "dense", "compress": True}, "only applies to a sharded "
     "collective"),
    ({"backend": "gather", "hierarchy": "replay", "mesh": ("cpu",)},
     "a mesh only applies to"),
    ({"backend": "tpu"}, "expected one of"),
    ({"method": "approx", "delta": 0.0}, "delta > 0"),
    ({"r": 3, "s": 3}, "1 <= r < s"),
    ({"backend": "gather", "hierarchy": "fused"}, "no compiled loop"),
    ({"backend": "nh", "method": "approx"}, "exact baseline"),
])
def test_config_outside_the_slice_raises(bad, word):
    with pytest.raises(ConfigError, match=word):
        decompose(golden_suite()["k4"](device="cpu"), NucleusConfig(**bad),
                  device="cpu")


def test_hierarchy_none_has_no_tree():
    dec = decompose(golden_suite()["planted40"](device="cpu"),
                    NucleusConfig(hierarchy="none"), device="cpu")
    assert dec.uf_parent is None and dec.core.max() > 0
    with pytest.raises(ValueError, match="hierarchy='none'"):
        dec.tree


def test_entry_points_raise_without_a_card(monkeypatch):
    """device=None means the card; with none present every entry point
    raises and names device="cpu" instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = golden_suite()["k4"](device="cpu")
    problem = build_problem(g, 2, 3, device="cpu")
    calls = [lambda: decompose(g), lambda: build_problem(g, 2, 3),
             lambda: dense_coreness(problem,
                                    make_schedule(problem, "exact")),
             lambda: golden_suite()["k4"]()]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
