"""repro_torch's chunked incidence build vs repro's, array for array.

The same seeded numpy graphs go to both packages.  For every graph of
tests/test_build_chunked.py x (1,2), (2,3), (2,4), (3,4) x chunk size
{1, 7, None}, the port's ``build="chunked"`` must equal the reference's
chunked build and the port's eager build bit for bit (``r_cliques``,
``inc_rid``, ``mem_offsets``, ``mem_sids``, ``deg0``, orientation), and
``build_stats``' ``build``/``chunk_size``/``n_chunks``/
``memory_budget_bytes``/``fastpath`` must equal the reference's.  The
reference side is its host-numpy chunked builder (``_build_chunked``),
which tests/test_build_chunked.py pins to its eager build: the jnp eager
build, and the jnp ``make_graph``/``pick_rank``, compile XLA programs per
op and shape, about a second each here.  So both builders get the same
graph and DAG, made by the port: tests/test_torch_incidence.py and
tests/test_torch_graph.py hold those to the reference's.

Also here: the tricount plain versions against the reference's Pallas
kernel in interpret mode and its jnp oracles (exact), the clique-listing
helpers, the ba4k build fingerprint (port only), and the ``NucleusConfig``
build-knob errors (same messages as the reference's).
"""
import functools
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.api import ConfigError as JConfigError
from repro.core.api import NucleusConfig as JConfig
from repro.core.incidence import _build_chunked
from repro.graph.cliques import _expand_levels_np, unique_rows as j_unique
from repro.graph.container import Digraph as JDigraph, Graph as JGraph
from repro.kernels import ref as jref, tricount as jtricount

from repro_torch import ConfigError, NucleusConfig, decompose
from repro_torch.core import canonicalize_labels
from repro_torch.core.incidence import (INCIDENCE_FIELDS as FIELDS,
                                       build_problem, pick_rank,
                                       problem_digest)
from repro_torch.graph import degree_rank, generators as tgen, orient
from repro_torch.graph.cliques import (count_cliques, iter_clique_chunks,
                                       list_cliques, unique_rows)
from repro_torch.kernels import ops, tricount

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = ("build", "chunk_size", "n_chunks", "memory_budget_bytes",
         "fastpath")
# the graphs of tests/test_build_chunked.py, as (generator, args)
GRAPHS = {
    "bowtie_plus": ("tiny_named", ("bowtie_plus",)),
    "er20": ("erdos_renyi", (20, 0.35, 1)),
    "planted": ("planted_cliques", (40, [8, 6, 5], 0.05, 3)),
    "ba60": ("barabasi_albert", (60, 4, 4)),
    "empty10": ("erdos_renyi", (10, 0.0, 0)),
}
RS = [(1, 2), (2, 3), (2, 4), (3, 4)]


def port_graph(gname):
    fn, args = GRAPHS[gname]
    return getattr(tgen, fn)(*args, device="cpu")


def j_digraph(dg):
    return JDigraph(n=dg.n, **{f: jnp.asarray(getattr(dg, f).numpy())
                               for f in ("offsets", "neighbors", "adj",
                                         "outdeg")})


@functools.lru_cache(maxsize=None)
def reference(gname):
    """The reference's Graph and DAG, from the port's arrays."""
    tg = port_graph(gname)
    dg, orientation = pick_rank(tg)
    return JGraph(n=tg.n, edges=jnp.asarray(tg.edges.numpy())), \
        j_digraph(dg), orientation


def assert_same(port, ref_problem, what):
    assert port.orientation == ref_problem.orientation, what
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(port, f).numpy(), np.asarray(getattr(ref_problem, f)),
            err_msg=f"{what} {f}")


def assert_same_stats(port, ref_problem, what):
    assert set(port.build_stats) == set(ref_problem.build_stats), what
    for k in STATS:
        assert port.build_stats[k] == ref_problem.build_stats[k], (what, k)


@pytest.mark.parametrize("chunk", [1, 7, None])
@pytest.mark.parametrize("r,s", RS)
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_chunked_matches_reference_and_eager(gname, r, s, chunk):
    g, dg, orientation = reference(gname)
    tg = port_graph(gname)
    want = _build_chunked(g, r, s, dg, orientation, memory_budget_bytes=None,
                          chunk_size=chunk, fastpath=None)
    got = build_problem(tg, r, s, build="chunked", chunk_size=chunk,
                        device="cpu")
    what = f"{gname} ({r},{s}) chunk={chunk}"
    assert_same(got, want, what)
    assert_same_stats(got, want, what)
    eager = build_problem(tg, r, s, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(eager, f)), (what, f)


@pytest.mark.parametrize("gname", ["er20", "planted", "ba60"])
def test_fastpath_matches_reference(gname):
    """The dense (2,3) count pass and the sparse path, forced either way
    and left to the default budget's rule, against the reference's."""
    g, dg, orientation = reference(gname)
    tg = port_graph(gname)
    for fastpath in (True, False, None):
        want = _build_chunked(g, 2, 3, dg, orientation,
                              memory_budget_bytes=None, chunk_size=None,
                              fastpath=fastpath)
        got = build_problem(tg, 2, 3, build="chunked", fastpath=fastpath,
                            device="cpu")
        what = f"{gname} fastpath={fastpath}"
        assert got.build_stats["fastpath"] == (fastpath is not False), what
        assert_same(got, want, what)
        assert_same_stats(got, want, what)
    # a budget under 5·n²·4 turns the fast path off, as in the reference
    small = 5 * tg.n * tg.n * 4 - 1
    want = _build_chunked(g, 2, 3, dg, orientation, memory_budget_bytes=small,
                          chunk_size=None, fastpath=None)
    got = build_problem(tg, 2, 3, build="chunked", memory_budget_bytes=small,
                        device="cpu")
    assert not got.build_stats["fastpath"]
    assert_same(got, want, f"{gname} budget={small}")
    assert_same_stats(got, want, f"{gname} budget={small}")


def test_fastpath_rejected_off_23():
    g, dg, orientation = reference("er20")
    with pytest.raises(ValueError) as want:
        _build_chunked(g, 2, 4, dg, orientation, memory_budget_bytes=None,
                       chunk_size=None, fastpath=True)
    with pytest.raises(ValueError) as got:
        build_problem(port_graph("er20"), 2, 4, build="chunked",
                      fastpath=True, device="cpu")
    assert str(got.value) == str(want.value)


def random_adj(n, seed, oriented):
    """A 0/1 matrix with a zero diagonal: as drawn (not symmetric, so a
    transposed operand would show) or symmetrized."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.3).astype(np.float32)
    np.fill_diagonal(a, 0.0)
    return a if oriented else np.maximum(a, a.T)


@pytest.mark.parametrize("n", [1, 20, 130, 257])
def test_tricount_plain_matches_reference(n):
    """CPU tensors take the plain versions; they equal the reference's
    Pallas kernel (interpret mode, padded to 128 and sliced) and its jnp
    oracles exactly, for the oriented and the symmetric adjacency."""
    for oriented, port_fn, j_fn, j_ref in (
            (True, tricount.tricount_oriented, jtricount.tricount_oriented,
             jref.tricount_oriented_ref),
            (False, tricount.tricount_per_edge, jtricount.tricount_per_edge,
             jref.tricount_per_edge_ref)):
        a = random_adj(n, n, oriented)
        got = port_fn(torch.from_numpy(a)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(j_fn(jnp.asarray(a), interpret=True)))
        np.testing.assert_array_equal(got, np.asarray(j_ref(jnp.asarray(a))))
        # ops casts to float32 (here from bool), as the reference's do
        got = (ops.tricount_oriented if oriented else ops.tricount)(
            torch.from_numpy(a > 0))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j_ref(jnp.asarray(a))))
    assert float(tricount.triangle_count(torch.from_numpy(a))) == \
        float(jref.triangle_count_ref(jnp.asarray(a)))


def test_tricount_rejects_non_square():
    with pytest.raises(ValueError, match=r"\(n, n\)"):
        tricount.tricount_oriented(torch.zeros((3, 4)))


def test_clique_helpers_match_reference():
    """list_cliques/count_cliques on the degree orientation, the chunk
    iterator's concatenation and unique_rows, against the reference's
    numpy expansion and jnp unique_rows."""
    tg = port_graph("planted")
    ddg = orient(tg, degree_rank(tg))
    want, _ = _expand_levels_np(ddg.adj.numpy(), ddg.outdeg.numpy(),
                                np.arange(tg.n, dtype=np.int32), [2, 3, 4])
    got = list_cliques(tg, [2, 3, 4])
    for t in (2, 3, 4):
        np.testing.assert_array_equal(got.levels[t].numpy(), want[t])
        assert got.count(t) == count_cliques(tg, t) == want[t].shape[0]
    assert count_cliques(tg, 1) == tg.n
    dg, _ = pick_rank(tg)
    whole = list_cliques(tg, [2, 4], dg=dg)
    for chunk in (1, 9, tg.n):
        parts = {2: [], 4: []}
        for _start, levels, peak in iter_clique_chunks(dg, [2, 4], chunk):
            assert peak >= 0
            for t in (2, 4):
                parts[t].append(levels[t])
        for t in (2, 4):
            assert torch.equal(torch.cat(parts[t]), whole.levels[t])
    rows = np.random.default_rng(0).integers(0, 4, size=(50, 3)).astype(
        np.int32)
    ju, jinv = j_unique(jnp.asarray(rows))
    tu, tinv = unique_rows(torch.from_numpy(rows))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))


def test_ba4k_build_fingerprint():
    with open(os.path.join(ROOT, "tests", "golden", "build",
                           "ba4k_build_r2s3.json")) as f:
        fx = json.load(f)
    g = tgen.barabasi_albert(4000, 8, seed=7, device="cpu")
    p = build_problem(g, fx["r"], fx["s"], build="chunked",
                      memory_budget_bytes=fx["budget"], device="cpu")
    assert (p.n_r, p.n_s, p.orientation) == (fx["n_r"], fx["n_s"],
                                             fx["orientation"])
    assert p.build_stats["n_chunks"] > 1 and not p.build_stats["fastpath"]
    assert problem_digest(p) == fx["digest"]


@pytest.mark.parametrize("fastpath_budget", [1 << 14, 1 << 20])
def test_decompose_chunked_reproduces_golden(fastpath_budget):
    """decompose(build="chunked") on the sparse and the dense path gives
    the golden fixture's cores and cuts."""
    with open(os.path.join(ROOT, "tests", "golden",
                           "planted40_r2s3.json")) as f:
        fx = json.load(f)
    g = tgen.golden_suite()["planted40"](device="cpu")
    dec = decompose(g, NucleusConfig(build="chunked",
                                     memory_budget_bytes=fastpath_budget),
                    device="cpu")
    assert dec.problem.build_stats["fastpath"] == (fastpath_budget > 1 << 14)
    np.testing.assert_array_equal(dec.core, fx["core"])
    for c, want in fx["partitions"].items():
        np.testing.assert_array_equal(canonicalize_labels(dec.cut(int(c))),
                                      want, err_msg=f"cut({c})")


@pytest.mark.parametrize("kw", [
    {"memory_budget_bytes": 1 << 20},
    {"build": "chunked", "memory_budget_bytes": 0},
    {"build": "chunked", "memory_budget_bytes": -5},
    {"build_chunk_size": 4},
    {"build": "chunked", "build_chunk_size": 0},
    {"build": "chunked", "memory_budget_bytes": 1 << 20,
     "build_chunk_size": 3},
])
def test_config_build_knobs_match_reference(kw):
    """The same error, message for message, or both accept."""
    try:
        JConfig(**kw).validate()
        want = None
    except JConfigError as e:
        want = str(e)
    if want is None:
        NucleusConfig(**kw).validate()
    else:
        with pytest.raises(ConfigError) as got:
            NucleusConfig(**kw).validate()
        assert str(got.value) == want
