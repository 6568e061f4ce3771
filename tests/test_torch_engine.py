"""repro_torch's peel engine vs repro.core.engine.dense_coreness.

``(core, order_round, rounds, uf_parent, uf_L)`` must be bit-identical to
the reference's ``dense_coreness(..., use_pallas=False, hierarchy=True)``
for exact and approx (delta 0.1) peeling, through the port's round bodies:
plain torch, the megakernel's plain version (``fused_kernel=True``) and the
segment-sum decrement's plain version (``fused_kernel=False``).  The golden
graphs go through the two kernel bodies (the ones the card runs); the
seeded graph goes through all three.  Both packages get the identical incidence
arrays: one numpy dict, fed to ``problem_from_reference`` for the port and
to the reference's ``NucleusProblem``.
"""
import functools
from math import comb

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core.engine import (dense_coreness as j_dense_coreness,
                               make_schedule as j_make_schedule)
from repro.core.incidence import NucleusProblem as JProblem
from repro.core.schedule import PeelSchedule as JSchedule
from repro.graph.container import Graph as JGraph

from repro_torch.core.engine import (_plan_arrays, dense_coreness,
                                     make_schedule)
from repro_torch.core.incidence import build_problem, problem_from_reference
from repro_torch.core.schedule import PeelSchedule
from repro_torch.graph import make_graph
from repro_torch.graph.generators import golden_suite

pytestmark = pytest.mark.fast

FIELDS = ("r_cliques", "inc_rid", "mem_offsets", "mem_sids", "deg0")
BODIES = [(False, None), (True, True), (True, False)]  # (use_kernel, fused)
KERNEL_BODIES = BODIES[1:]


def seeded_graph(n=500, seed=7):
    rng = np.random.default_rng(seed)
    e = [rng.integers(0, n, size=(1500, 2))]
    for _ in range(20):
        m = rng.choice(n, 12, replace=False)
        iu = np.triu_indices(12, 1)
        keep = rng.random(iu[0].shape[0]) < 0.6
        e.append(np.stack([m[iu[0]][keep], m[iu[1]][keep]], axis=1))
    return make_graph(n, np.concatenate(e), device="cpu")


@functools.lru_cache(maxsize=None)
def arrays_of(name, r, s):
    g = seeded_graph() if name == "seed500" else \
        golden_suite()[name](device="cpu")
    p = build_problem(g, r, s, device="cpu")
    arrays = {f: getattr(p, f).numpy() for f in FIELDS}
    arrays.update(edges=p.g.edges.numpy(), n=g.n)
    return arrays, p.orientation


def both_problems(name, r, s):
    arrays, orientation = arrays_of(name, r, s)
    port = problem_from_reference(arrays, r, s, orientation, device="cpu")
    j = JProblem(g=JGraph(n=int(arrays["n"]),
                          edges=jnp.asarray(arrays["edges"])),
                 r=r, s=s, **{f: jnp.asarray(arrays[f]) for f in FIELDS},
                 orientation=orientation)
    return port, j


CASES = [(name, 2, 3) for name in sorted(golden_suite())] + \
    [("seed500", 1, 2), ("seed500", 2, 3), ("seed500", 3, 4)]


@pytest.mark.parametrize("kind", ["exact", "approx"])
@pytest.mark.parametrize("name,r,s", CASES)
def test_dense_coreness_matches_reference(name, r, s, kind):
    port, j = both_problems(name, r, s)
    if port.n_r == 0:
        pytest.skip("no r-cliques")
    want = [np.asarray(x) for x in j_dense_coreness(
        j, j_make_schedule(j, kind, 0.1), use_pallas=False, hierarchy=True)]
    bodies = BODIES if name == "seed500" else KERNEL_BODIES
    for use_kernel, fused in bodies:
        got = dense_coreness(port, make_schedule(port, kind, 0.1),
                             device="cpu", use_kernel=use_kernel,
                             fused_kernel=fused, hierarchy=True)
        for w, g, field in zip(want, got, ("core", "order_round", "rounds",
                                           "uf_parent", "uf_L")):
            np.testing.assert_array_equal(
                np.asarray(g), w,
                err_msg=f"{field} (use_kernel={use_kernel}, "
                        f"fused_kernel={fused})")


@pytest.mark.parametrize("kind", ["exact", "approx"])
def test_peeled0_ghosts_match_reference(kind):
    """Ghost r-cliques (no incidence) marked peeled before round 0 stay
    inert, as in the reference's shape-bucketed problems."""
    arrays, orientation = arrays_of("seed500", 2, 3)
    arrays = dict(arrays)
    ghosts = 5
    arrays["r_cliques"] = np.concatenate(
        [arrays["r_cliques"], np.zeros((ghosts, 2), np.int32)])
    arrays["deg0"] = np.concatenate([arrays["deg0"],
                                     np.zeros(ghosts, np.int32)])
    arrays["mem_offsets"] = np.concatenate(
        [arrays["mem_offsets"], np.full(ghosts, arrays["mem_offsets"][-1],
                                        np.int32)])
    port = problem_from_reference(arrays, 2, 3, orientation, device="cpu")
    j = JProblem(g=JGraph(n=int(arrays["n"]),
                          edges=jnp.asarray(arrays["edges"])),
                 r=2, s=3, **{f: jnp.asarray(arrays[f]) for f in FIELDS},
                 orientation=orientation)
    peeled0 = np.zeros(port.n_r, bool)
    peeled0[-ghosts:] = True
    want = [np.asarray(x) for x in j_dense_coreness(
        j, j_make_schedule(j, kind, 0.1), use_pallas=False, hierarchy=True,
        peeled0=jnp.asarray(peeled0))]
    assert (want[0][-ghosts:] == -1).all()
    for use_kernel, fused in BODIES:
        got = dense_coreness(port, make_schedule(port, kind, 0.1),
                             device="cpu", use_kernel=use_kernel,
                             fused_kernel=fused, hierarchy=True,
                             peeled0=torch.as_tensor(peeled0))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(g), w)


def test_plan_arrays_match_reference():
    from repro.core.engine import _plan_arrays as j_plan_arrays
    port, j = both_problems("seed500", 2, 3)
    for w, g in zip(j_plan_arrays(j), _plan_arrays(port)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["exact", "approx"])
def test_schedule_levels_match_reference(kind):
    """next_level over a rising and falling dmin stream, bucket caps
    included: the host schedule picks the reference's levels."""
    # n=2: a per-bucket cap of 22 rounds, which the 2000-run exceeds
    js = JSchedule(kind=kind, s_choose_r=comb(3, 2), delta=0.1, n=2)
    ts = PeelSchedule(kind=kind, s_choose_r=comb(3, 2), delta=0.1, n=2)
    assert ts.cap() == js.cap() == 22
    dmins = [0, 0, 1, 3, 3, 2, 7, 7, 7, 7, 20, 19, 64, 65, 300, 2000] + \
        [2000] * 30
    step = jax.jit(js.next_level)
    jc, tc = js.init_carry(), ts.init_carry()
    for dmin in dmins:
        jc, jl = step(jc, jnp.int32(dmin))
        tc, tl = ts.next_level(tc, dmin)
        assert int(jl) == tl
        assert tuple(int(x) for x in jc) == tc
