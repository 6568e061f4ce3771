"""The port's kernel wrappers and plain twins vs the reference's oracles.

CPU: ``repro_torch.kernels.ref`` vs ``repro.kernels.ref`` and the Pallas
kernels in interpret mode, and the wrappers (which take their plain
version on CPU tensors) vs the same oracles.  Integer outputs must be
equal element for element; float32 segment sums agree to 1e-5 relative
(the sums are taken in another order).

The round wrapper takes the reference's peeled flags packed into its key
(``peel_key``).  The states the CUDA round kernel skips (peeled before the
round or in it) are cases of the round tests, and the tricount kernel's
extreme shapes and densities have cases of their own.  The CUDA kernels themselves are held to these plain versions by
tests/test_torch_cuda.py (on a card) and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.kernels import ref as jref, tricount as jtricount
from repro.kernels.peel_round import (chunk_windows, fused_peel_round as
                                      j_fused_peel_round, peel_round_plan)
from repro.kernels.segment_sum import segment_sum_sorted, sorted_ids_plan

from repro_torch.kernels import launch_counts, ref
from repro_torch.kernels.peel_round import (PEELED, fused_peel_round,
                                            peel_key)
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.kernels.tricount import tricount_oriented, tricount_per_edge

# one intra-op thread: the suite runs its workers on shared cores, and
# idle OpenMP threads spin against the other workers' tests
torch.set_num_threads(1)

pytestmark = pytest.mark.fast

# the reference's round oracle compiled whole, once per shape (level and
# round traced): eager JAX compiles op by op
j_peel_round_ref = jax.jit(jref.peel_round_ref)


def t(x):
    return torch.tensor(np.array(x))


def random_round(rng, n_r, E, C, kind="random"):
    """A rid-sorted plan + a consistent random round state, or one of the
    states the CUDA round kernel's skip rests on: an r-clique peeled before
    the round, or peeled in it (deg <= level), keeps its deg whatever its
    edges say, so the kernel never reads them.  "all peeled" and "all
    dying" (deg < 6, so at every level from 6 on) leave nothing to walk;
    "long runs" adds one 2,000-edge run to the E random edges."""
    rids = rng.integers(0, n_r, E)
    if kind == "long runs":
        rids = np.concatenate([rids, np.full(2000, n_r // 2)])
    rids = np.sort(rids).astype(np.int32)
    members = rng.integers(0, n_r, (rids.size, C)).astype(np.int32)
    if rids.size:
        members[rng.random(members.shape) < 0.05] = -1
    deg = rng.integers(0, 12, n_r)
    peeled = rng.integers(0, 2, n_r)
    if kind == "all peeled":
        peeled[:] = 1
    elif kind == "all dying":
        peeled[:] = 0
        deg = rng.integers(0, 6, n_r)
    state = tuple(x.astype(np.int32) for x in (
        deg, peeled, rng.integers(-1, 9, n_r), rng.integers(-1, 9, n_r)))
    return rids, members, state


def offsets_of(rids, n_r):
    return np.searchsorted(rids, np.arange(n_r + 1), side="left").astype(
        np.int32)


def port_round(rids, members, state, level, rnd):
    """The port's wrapper on the reference's round state (deg, peeled, core,
    order): peeled goes in packed into the key and comes out unpacked, and
    the key out must be the packing of deg and peeled out."""
    n_r = state[0].size
    deg, peeled, core, order = (t(x) for x in state)
    d, key, c, o = fused_peel_round(t(offsets_of(rids, n_r)), t(members),
                                    deg, peel_key(deg, peeled), core, order,
                                    level, rnd)
    p = (key == PEELED).to(torch.int32)
    assert torch.equal(key, peel_key(d, p))
    return d, p, c, o


def assert_round(got, want):
    for g, w, name in zip(got, want, ("deg", "peeled", "core", "order")):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


def assert_skipped_deg_kept(got, state, level):
    """deg' == deg for every r-clique peeled before or in the round."""
    deg, peeled = state[0], state[1]
    done = (peeled > 0) | (deg <= level)
    np.testing.assert_array_equal(np.asarray(got[0])[done], deg[done])


@pytest.mark.parametrize("n_r,E,C,kind", [
    (1, 1, 3, "random"), (50, 200, 3, "random"), (97, 513, 4, "random"),
    (33, 0, 3, "random"), (64, 300, 2, "random"), (60, 150, 3, "all peeled"),
    (60, 150, 3, "all dying"), (40, 80, 3, "long runs")])
def test_peel_round_ref_and_wrapper_match_reference(n_r, E, C, kind):
    rng = np.random.default_rng(n_r * 1000 + E)
    rids, members, state = random_round(rng, n_r, E, C, kind)
    # pad edges (id = n_r, members -1) after the real ones, as the
    # reference's plan lays them out
    ids_pad = np.concatenate([rids, np.full(7, n_r, np.int32)])
    mem_pad = np.concatenate([members, np.full((7, C), -1, np.int32)])
    for level in (0, 3, 7, 11):
        want = j_peel_round_ref(ids_pad, mem_pad, *state, level, 5)
        assert_skipped_deg_kept(want, state, level)
        got = ref.peel_round_ref(t(ids_pad), t(mem_pad),
                                 *(t(x) for x in state), level, 5)
        assert_round(got, want)
        before = dict(launch_counts)
        wrapped = port_round(rids, members, state, level, 5)
        assert launch_counts == before  # CPU tensors: plain, no launch
        assert_round(wrapped, want)


@pytest.mark.parametrize("n_r,E,kind", [
    (50, 65, "random"), (130, 400, "random"), (60, 150, "all peeled"),
    (60, 150, "all dying"), (40, 80, "long runs")])
def test_peel_round_matches_pallas_interpret(n_r, E, kind):
    """The Pallas megakernel (interpret mode) on its padded plan vs the
    port's wrapper on the CSR plan of the same edges."""
    rng = np.random.default_rng(E)
    block_n, chunk_e = 32, 64
    rids, members, state = random_round(rng, n_r, E, 3, kind)
    ids_p, mem_p, n_r_pad, max_chunks = peel_round_plan(
        rids, members, n_r, block_n=block_n, chunk_e=chunk_e)
    ids_p, mem_p = jnp.asarray(ids_p), jnp.asarray(mem_p)
    pad = n_r_pad - n_r
    padded = [np.concatenate([x, np.full(pad, fill, np.int32)])
              for x, fill in zip(state, (0, 1, -1, -1))]
    c0, nch = chunk_windows(ids_p, n_r_pad, block_n, chunk_e, max_chunks)
    for level in (2, 6):
        want = j_fused_peel_round(
            ids_p, mem_p, *(jnp.asarray(x) for x in padded),
            jnp.int32(level), jnp.int32(3), c0, nch, block_n=block_n,
            chunk_e=chunk_e, max_chunks=max_chunks, interpret=True)
        want = [np.asarray(w)[:n_r] for w in want]
        assert_skipped_deg_kept(want, state, level)
        assert_round(port_round(rids, members, state, level, 3), want)


def tricount_input(n, density, seed):
    """A 0/1 (n, n) matrix at the given density, not symmetric; from n = 4
    on, row 1 empty and row 2 full (the bitset kernel's extreme rows)."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density).astype(np.float32)
    if n > 3:
        a[1] = 0.0
        a[2] = 1.0
    return a


@pytest.mark.parametrize("density", [1e-3, 0.3])
@pytest.mark.parametrize("n", [1, 31, 33, 127, 130, 257])
def test_tricount_density_extremes_match_reference(n, density):
    """The tricount wrappers (their plain versions on CPU) vs the
    reference's oracles and its Pallas kernel (interpret mode) at the
    shapes and densities tests/test_torch_cuda.py holds the kernel to."""
    a = tricount_input(n, density, n)
    ja = jnp.asarray(a)
    for port_fn, j_fn, j_ref in (
            (tricount_oriented, jtricount.tricount_oriented,
             jref.tricount_oriented_ref),
            (tricount_per_edge, jtricount.tricount_per_edge,
             jref.tricount_per_edge_ref)):
        got = port_fn(torch.from_numpy(a)).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_ref(ja)))
        np.testing.assert_array_equal(
            got, np.asarray(j_fn(ja, interpret=True)))


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("d", [1, 4])
def test_segment_sum_matches_reference(dtype, d):
    rng = np.random.default_rng(d)
    n_seg, E = 70, 300
    ids = np.sort(rng.integers(0, n_seg, E)).astype(np.int32)
    # trailing pad rows carry id = n_seg and must be dropped
    ids = np.concatenate([ids, np.full(5, n_seg, np.int32)])
    if dtype == "int32":
        data = rng.integers(-3, 9, (E + 5, d)).astype(np.int32)
    else:
        data = rng.standard_normal((E + 5, d)).astype(np.float32)
    want = np.asarray(jref.segment_sum_ref(data, ids, n_seg))
    for got in (ref.segment_sum_ref(t(data), t(ids), n_seg),
                segment_sum(t(data), t(ids), n_seg)):
        assert got.dtype == getattr(torch, dtype)
        if dtype == "int32":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)


def edge_ids(case, rng):
    """(ids, n_seg) at the CUDA kernel's edges (tiles of 4,096 rows, 16 a
    thread): runs over many tiles, power-law run lengths, long gaps with ids
    from 5,000, nothing but the pad id, a few rows."""
    if case == "long runs":
        return np.sort(rng.integers(0, 3, 20_000)), 3
    if case == "power-law":
        lengths = np.minimum(rng.zipf(1.8, 500), 300)
        return np.repeat(np.arange(lengths.size), lengths), lengths.size
    if case == "gaps":
        gaps = np.cumsum(rng.integers(1, 300, 100)) + 5000
        return np.sort(rng.choice(gaps, 6000)), int(gaps[-1]) + 700
    if case == "all pad":
        return np.full(5000, 70), 70
    return np.sort(rng.integers(0, 6, int(case))), 5


@pytest.mark.parametrize("case", ["long runs", "power-law", "gaps",
                                  "all pad", "1", "7", "17"])
def test_segment_sum_edges_match_reference(case):
    """The wrapper (its plain version on CPU) vs the reference's oracle on
    the inputs tests/test_torch_cuda.py holds the kernel to."""
    rng = np.random.default_rng(len(case))
    ids, n_seg = edge_ids(case, rng)
    ids = ids.astype(np.int32)
    for data in (rng.integers(-5, 6, (ids.size, 1)).astype(np.int32),
                 rng.standard_normal((ids.size, 1)).astype(np.float32)):
        want = np.asarray(jref.segment_sum_ref(data, ids, n_seg))
        got = segment_sum(t(data), t(ids), n_seg).numpy()
        if data.dtype == np.int32:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_segment_sum_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    n_seg, E = 200, 700
    ids = np.sort(rng.integers(0, n_seg, E)).astype(np.int32)
    data = rng.integers(0, 2, (E, 1)).astype(np.int32)
    ids_p, n_seg_pad, max_chunks = sorted_ids_plan(ids, n_seg, block_n=64,
                                                   chunk_e=128)
    data_p = np.zeros((ids_p.shape[0], 1), np.int32)
    data_p[:E] = data
    want = segment_sum_sorted(jnp.asarray(data_p), jnp.asarray(ids_p),
                              n_seg_pad, block_n=64, chunk_e=128,
                              max_chunks=max_chunks, interpret=True)
    got = segment_sum(t(data), t(ids), n_seg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n_seg])
