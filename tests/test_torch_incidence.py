"""repro_torch's eager incidence build vs repro's, array for array.

Every golden graph x (1,2), (2,3), (3,4): ``r_cliques``, ``inc_rid``,
``mem_offsets``, ``mem_sids``, ``deg0`` and the recorded ``orientation``
must be bit-identical, and so must both candidate orientations of each
golden graph (ranks and oriented CSR/adjacency).  The reference side is
``pick_rank`` + the reference's host assembly of the same expansion
(``build="chunked"`` with one chunk of all vertices), which
tests/test_build_chunked.py pins array for array to the reference's eager
build on these same graphs: the jnp eager path compiles one XLA program
per op and shape, several seconds per graph, where this one costs one
``pick_rank`` per graph.
"""
import functools
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import pytest
import torch

from repro.core.incidence import _build_chunked, pick_rank as j_pick_rank
from repro.graph import container as jcontainer, orientation as jorient
from repro.graph.generators import golden_suite as j_golden_suite

from repro_torch.core.incidence import (build_problem, pick_rank,
                                        problem_from_reference)
from repro_torch.graph import orient, orientation as torient
from repro_torch.graph.generators import GOLDEN_RS, golden_suite

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

pytestmark = pytest.mark.fast

FIELDS = ("r_cliques", "inc_rid", "mem_offsets", "mem_sids", "deg0")


@functools.lru_cache(maxsize=None)
def reference_dag(name):
    g = j_golden_suite()[name]()
    dg, orientation = j_pick_rank(g)
    return g, dg, orientation


ORIENT_FIELDS = ("offsets", "neighbors", "adj", "outdeg")


def reference_orientations(name):
    """{kind: (rank, {field: oriented array})} of the reference, for both
    candidate orientations of a golden graph."""
    g, _, _ = reference_dag(name)  # same programs pick_rank compiled
    out = {}
    for kind in ("degree_rank", "approx_degeneracy_rank"):
        jr = getattr(jorient, kind)(g)
        jd = jcontainer.orient(g, jr)
        out[kind] = (np.asarray(jr), {f: np.asarray(getattr(jd, f))
                                      for f in ORIENT_FIELDS})
    return out


@pytest.fixture(scope="module")
def reference_orients():
    """Every graph's reference orientations, submitted together to a few
    threads when the first graph's test runs (their cost is XLA compiles,
    which release the interpreter lock); pending work dropped at the
    end."""
    with ThreadPoolExecutor(max_workers=4,
                            thread_name_prefix="reference") as pool:
        futures = {name: pool.submit(reference_orientations, name)
                   for name in sorted(golden_suite())}
        yield futures
        for f in futures.values():
            f.cancel()
        wait(futures.values())


@pytest.mark.parametrize("name", sorted(golden_suite()))
def test_orientations_match_reference(reference_orients, name):
    want = reference_orients[name].result()
    tg = golden_suite()[name](device="cpu")
    for kind in ("degree_rank", "approx_degeneracy_rank"):
        jr, jd = want[kind]
        tr = getattr(torient, kind)(tg)
        np.testing.assert_array_equal(tr.numpy(), jr, err_msg=kind)
        td = orient(tg, tr)
        for field in ORIENT_FIELDS:
            np.testing.assert_array_equal(
                getattr(td, field).numpy(), jd[field],
                err_msg=f"{kind} {field}")


@pytest.mark.parametrize("r,s", GOLDEN_RS)
@pytest.mark.parametrize("name", sorted(golden_suite()))
def test_eager_build_matches_reference(name, r, s):
    g, dg, orientation = reference_dag(name)
    want = _build_chunked(g, r, s, dg, orientation, memory_budget_bytes=None,
                          chunk_size=g.n, fastpath=False)
    got = build_problem(golden_suite()[name](device="cpu"), r, s,
                        device="cpu")
    assert got.orientation == want.orientation
    assert (got.n_r, got.n_s, got.n_sub) == (want.n_r, want.n_s, want.n_sub)
    for field in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=f"{name} ({r},{s}) {field}")
    # the port's pick_rank keeps only the winning adjacency
    tdg, torient = pick_rank(golden_suite()[name](device="cpu"))
    assert torient == orientation
    np.testing.assert_array_equal(tdg.adj.numpy(), np.asarray(dg.adj))
    # problem_from_reference carries the reference's arrays across unchanged
    arrays = {f: np.asarray(getattr(want, f)) for f in FIELDS}
    arrays.update(edges=np.asarray(g.edges), n=g.n)
    carried = problem_from_reference(arrays, r, s, orientation,
                                     device="cpu")
    for field in FIELDS:
        assert torch.equal(getattr(carried, field), getattr(got, field))
    assert torch.equal(carried.g.edges, got.g.edges)
