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


@pytest.mark.parametrize("name,r,s,method", REFERENCE_CASES)
def test_decompose_matches_reference(name, r, s, method):
    g = golden_suite()[name](device="cpu")
    port_problem = build_problem(g, r, s, device="cpu")
    jp = JProblem(g=JGraph(n=g.n, edges=jnp.asarray(g.edges.numpy())),
                  r=r, s=s,
                  **{f: jnp.asarray(getattr(port_problem, f).numpy())
                     for f in FIELDS},
                  orientation=port_problem.orientation)
    cfg = dict(r=r, s=s, method=method)
    if method == "approx":
        cfg["delta"] = 0.5
    want = jcore.decompose(jp, jcore.NucleusConfig(**cfg))
    got = decompose(g, NucleusConfig(**cfg), device="cpu")
    assert got.rounds == want.rounds
    for field in ("core", "order_round", "peel_value", "uf_parent", "uf_L"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    for c in sorted(set(int(x) for x in want.peel_value if x > 0)):
        np.testing.assert_array_equal(got.cut(c), want.cut(c),
                                      err_msg=f"cut({c})")
        gn, wn = got.nuclei(c), want.nuclei(c)
        assert sorted(gn) == sorted(wn)
        for lab in gn:
            np.testing.assert_array_equal(gn[lab].vertices,
                                          wn[lab].vertices)
            assert gn[lab].n_r_cliques == wn[lab].n_r_cliques
            assert gn[lab].density == wn[lab].density


@pytest.mark.parametrize("bad,word", [
    ({"backend": "sharded"}, "not yet ported"),
    ({"build": "sharded"}, "not yet ported"),
    ({"backend": "sharded", "compress": True}, "not yet ported"),
    ({"build": "chunked", "build_shards": 2}, "not yet ported"),
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
