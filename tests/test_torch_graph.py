"""repro_torch.graph vs repro.graph: bit-identical on the golden suite and a
seeded ~500-vertex graph.

Inputs are made once with numpy and fed to both packages; every integer
output must be equal element for element (tolerance 0).  The reference's
``expand_levels`` and ``sort_join`` compile one XLA program per op and
shape, so they are checked through the reference's numpy twins
(``_expand_levels_np``, ``sort_join_np``: same rows, same ids, pinned to
the jnp functions by tests/test_build_chunked.py).  Both orientations are
compared here on the seeded graph and, for the goldens, in
tests/test_torch_incidence.py, which compiles the same reference programs
for ``pick_rank`` anyway; the expansion and the CSR here take the port's
DAG as the input both packages get.
"""
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import pytest
import torch

from repro.graph import container as jcontainer
from repro.graph import orientation as jorient
from repro.graph.cliques import (_expand_levels_np, lexsort_rows as
                                 j_lexsort, sort_join_np)
from repro.graph.generators import golden_suite as j_golden_suite
from repro.graph.unionfind import uf_union_edges as j_uf_union_edges

from repro_torch.graph import (csr_from_pairs, expand_levels, lexsort_rows,
                               make_graph, orient, sort_join,
                               uf_union_edges)
from repro_torch.graph import orientation as torient
from repro_torch.graph.generators import golden_suite

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

pytestmark = pytest.mark.fast


def seeded_edges(n=500, seed=7):
    """A ~500-vertex graph: random background + planted dense groups."""
    rng = np.random.default_rng(seed)
    e = [rng.integers(0, n, size=(1500, 2))]
    for _ in range(20):
        m = rng.choice(n, 12, replace=False)
        iu = np.triu_indices(12, 1)
        keep = rng.random(iu[0].shape[0]) < 0.6
        e.append(np.stack([m[iu[0]][keep], m[iu[1]][keep]], axis=1))
    return n, np.concatenate(e)


GRAPHS = sorted(golden_suite()) + ["seed500"]


def graph_pair(name):
    if name == "seed500":
        n, e = seeded_edges()
        return jcontainer.make_graph(n, e), make_graph(n, e, device="cpu")
    return j_golden_suite()[name](), golden_suite()[name](device="cpu")


def eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(),
                                  err_msg=what)


def t(x):
    return torch.tensor(np.array(x))


ORIENT_FIELDS = ("offsets", "neighbors", "adj", "outdeg")


def reference_container(name):
    """The reference's side of ``test_container_and_orientation``, as
    numpy: the graph, on seed500 both ranks and the degree-rank DAG, and
    ``csr_from_pairs`` over the port's DAG arcs (the keys are the port's
    arrays, the same input both packages get)."""
    jg, tg = graph_pair(name)
    out = {"n": jg.n, "edges": np.asarray(jg.edges)}
    if name == "seed500":
        for kind in ("degree_rank", "approx_degeneracy_rank"):
            out[kind] = np.asarray(getattr(jorient, kind)(jg))
        dg = jcontainer.orient(jg, jorient.degree_rank(jg))
        out["orient"] = {f: np.asarray(getattr(dg, f)) for f in ORIENT_FIELDS}
    keys = orient(tg, torient.degree_rank(tg)).neighbors.numpy()
    vals = np.arange(keys.shape[0], dtype=np.int32)
    out["csr"] = [np.asarray(x) for x in
                  jcontainer.csr_from_pairs(keys, vals, jg.n)]
    return out


@pytest.fixture(scope="module")
def reference_containers():
    """Every graph's reference side, submitted together to a few threads
    when the first graph's test runs (XLA compiles, which release the
    interpreter lock); pending work dropped at the end."""
    with ThreadPoolExecutor(max_workers=4,
                            thread_name_prefix="reference") as pool:
        futures = {name: pool.submit(reference_container, name)
                   for name in GRAPHS}
        yield futures
        for f in futures.values():
            f.cancel()
        wait(futures.values())


@pytest.mark.parametrize("name", GRAPHS)
def test_container_and_orientation(reference_containers, name):
    ref = reference_containers[name].result()
    tg = golden_suite()[name](device="cpu") if name != "seed500" else \
        make_graph(*seeded_edges(), device="cpu")
    assert tg.n == ref["n"]
    eq(ref["edges"], tg.edges, "make_graph edges")
    tr = torient.degree_rank(tg)
    tdg = orient(tg, tr)
    if name == "seed500":
        for kind in ("degree_rank", "approx_degeneracy_rank"):
            eq(ref[kind], getattr(torient, kind)(tg), kind)
        for field in ORIENT_FIELDS:
            eq(ref["orient"][field], getattr(tdg, field),
               f"orient {field}")
    # csr_from_pairs over the DAG arcs, keyed by head (many equal keys)
    keys = tdg.neighbors.numpy()
    vals = np.arange(keys.shape[0], dtype=np.int32)
    jo, jv = ref["csr"]
    to, tv = csr_from_pairs(t(keys), t(vals), tg.n)
    eq(jo, to, "csr offsets")
    eq(jv, tv, "csr vals")
    # expansion over the same DAG, held to the reference's numpy twin
    ks = [1, 2, 3, 4]
    seeds = np.arange(tg.n, dtype=np.int32)
    want = _expand_levels_np(tdg.adj.numpy(), tdg.outdeg.numpy(), seeds,
                             ks)[0]
    got = expand_levels(tdg, t(seeds), ks)
    for k in ks:
        eq(want[k], got[k], f"expand_levels level {k}")


@pytest.mark.parametrize("name", GRAPHS)
def test_sort_join_and_union_find(name):
    jg, tg = graph_pair(name)
    rng = np.random.default_rng(11)
    edges = np.asarray(jg.edges)
    # table = the sorted edge rows; queries = hits, reversed pairs (misses)
    queries = np.concatenate([edges[rng.permutation(edges.shape[0])],
                              edges[:, ::-1]], axis=0).astype(np.int32)
    table = edges[np.asarray(j_lexsort(edges))] if edges.shape[0] else edges
    got = sort_join(t(table), t(queries))
    eq(sort_join_np(table, queries), got, "sort_join")
    eq(np.asarray(j_lexsort(queries)), lexsort_rows(t(queries)),
       "lexsort_rows")
    # union-find: random edges over a random (unresolved) initial forest
    n = jg.n
    init = np.minimum(np.arange(n), rng.integers(0, n, size=n)).astype(
        np.int32)
    u = rng.integers(0, n, size=2 * n).astype(np.int32)
    v = rng.integers(0, n, size=2 * n).astype(np.int32)
    eq(j_uf_union_edges(init, u, v),
       uf_union_edges(t(init), t(u), t(v)), "uf_union_edges")
