"""The CUDA kernels vs their plain-torch versions, on a card, and the
chunked build on the card vs the CPU.

Marked ``cuda``: without a card each test skips (decided inside the
fixture, so every pytest worker collects the same tests).  Run on the card
with ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports torch and repro_torch only, so it also runs where JAX is
absent.
``chip_smoke.py`` makes the same comparison at the smoke graph's shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.engine import _round_plan
from repro_torch.core.incidence import build_problem
from repro_torch.graph.generators import barabasi_albert, golden_suite
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.peel_round import (fused_peel_round, peel_key,
                                            peel_round_plain)
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_plain
from repro_torch.kernels.tricount import (tricount_oriented,
                                          tricount_oriented_plain,
                                          tricount_per_edge,
                                          tricount_per_edge_plain)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def t(x):
    return torch.tensor(np.array(x))


def round_state(deg, peeled, core, order):
    """(deg, key, core, order) int32 tensors from numpy arrays."""
    deg, peeled, core, order = (t(x.astype(np.int32))
                                for x in (deg, peeled, core, order))
    return [deg, peel_key(deg, peeled), core, order]


def random_round(rng, n_r, E, C):
    """A rid-sorted CSR plan (5% pad members) + a random round state."""
    rids = np.sort(rng.integers(0, n_r, E)).astype(np.int32)
    members = rng.integers(0, n_r, (E, C)).astype(np.int32)
    if E:
        members[rng.random((E, C)) < 0.05] = -1
    offsets = np.searchsorted(rids, np.arange(n_r + 1)).astype(np.int32)
    return [t(offsets), t(members)] + round_state(
        rng.integers(0, 12, n_r), rng.integers(0, 2, n_r),
        rng.integers(-1, 9, n_r), rng.integers(-1, 9, n_r))


@pytest.mark.cuda
def test_peel_round_kernel_on_card(cuda_device):
    rng = np.random.default_rng(0)
    for n_r, E, C in [(1, 1, 3), (1000, 5000, 3), (777, 4096, 4),
                      (100, 0, 3)]:
        args = random_round(rng, n_r, E, C)
        cuda_args = [a.to(cuda_device) for a in args]
        before = launch_counts["peel_round"]
        for level in (0, 5, 11):
            got = fused_peel_round(*cuda_args, level, 4)
            torch.cuda.synchronize()
            want = peel_round_plain(*args, level, 4)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
        assert launch_counts["peel_round"] == before + 3


def round_states(rng, n_r, level):
    """Random round states at `level`, then the skip's extremes: every
    r-clique peeled, every one dying (deg <= level), none changing (every
    deg above level, so no s-clique dies)."""
    def draw(deg, peeled):
        return round_state(deg, peeled, rng.integers(-1, 9, n_r),
                           rng.integers(-1, 9, n_r))
    yield "random", draw(rng.integers(0, 12, n_r), rng.integers(0, 2, n_r))
    yield "all peeled", draw(rng.integers(0, 12, n_r), np.ones(n_r))
    yield "all dying", draw(rng.integers(0, level + 1, n_r), np.zeros(n_r))
    yield "none changing", draw(rng.integers(level + 1, level + 9, n_r),
                                np.zeros(n_r))


@pytest.mark.cuda
def test_peel_round_edges_on_card(cuda_device):
    """The skip and the edge-balanced walk at their edges, bit for bit
    against the plain twin: the skip's extreme states, one r-clique owning
    150,000 edges beside thousands with 1 to 3, the C = 2, 4 and 6 plans
    of the (1,2), (3,4) and (2,4) problems on golden graphs, and views one
    element in (pointers off 16-byte alignment)."""
    rng = np.random.default_rng(6)

    def random_plan(counts, C):
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        members = rng.integers(-1, counts.size, (int(offsets[-1]), C))
        return t(offsets), t(members.astype(np.int32))

    long_run = rng.integers(1, 4, 3000)
    long_run[1500] = 150_000
    plans = [("random runs",) + random_plan(rng.integers(0, 6, 5000), 3),
             ("a 150,000-edge run",) + random_plan(long_run, 3)]
    for name, r, s in (("planted40", 1, 2), ("planted40", 3, 4),
                       ("er20", 2, 4)):
        p = build_problem(golden_suite()[name](device="cpu"), r, s,
                          device="cpu")
        plans.append((f"{name} ({r},{s})",) + _round_plan(p))
    for what, offsets, members in plans:
        n_r = int(offsets.shape[0]) - 1
        for state_name, state in round_states(rng, n_r, 4):
            for level in (4,) if state_name != "random" else (0, 4, 11):
                args = [offsets, members] + state
                want = peel_round_plain(*args, level, 3)
                got = fused_peel_round(*[a.to(cuda_device) for a in args],
                                       level, 3)
                for name, g, w in zip(("deg", "key", "core", "order"),
                                      got, want):
                    assert torch.equal(g.cpu(), w), (what, state_name,
                                                     level, name)
        # the same round through views one element in
        views = [torch.cat([a[:1], a]).to(cuda_device)[1:]
                 for a in [offsets, members] + state]
        got = fused_peel_round(*views, 4, 3)
        for g, w in zip(got, peel_round_plain(offsets, members, *state, 4,
                                              3)):
            assert torch.equal(g.cpu(), w), (what, "views")


@pytest.mark.cuda
def test_tricount_edges_on_card(cuda_device):
    """The bitset kernel at ragged n around its 32-column words, an empty
    and a full row, densities 1e-3 (probe counts) and 0.3 (popcount
    counts), both operand layouts, bit for bit."""
    rng = np.random.default_rng(7)
    for n in (1, 31, 33, 127, 130, 257):
        for density in (1e-3, 0.3):
            a = (rng.random((n, n)) < density).astype(np.float32)
            if n > 3:
                a[1] = 0.0
                a[2] = 1.0
            cpu = t(a)
            for kernel, plain in ((tricount_oriented,
                                   tricount_oriented_plain),
                                  (tricount_per_edge,
                                   tricount_per_edge_plain)):
                got = kernel(cpu.to(cuda_device))
                assert torch.equal(got.cpu(), plain(cpu)), (
                    n, density, kernel.__name__)
    for bad in (2.0, float("nan"), 0.5):
        a = torch.zeros((70, 70), device=cuda_device)
        a[3, 69] = bad
        with pytest.raises(ValueError, match="other than 0 and 1"):
            tricount_per_edge(a)


@pytest.mark.cuda
def test_segment_sum_kernel_on_card(cuda_device):
    rng = np.random.default_rng(1)
    for n_seg, E, d in [(1, 1, 1), (1000, 20000, 1), (300, 999, 4),
                        (513, 0, 1), (2000, 5000, 33)]:
        ids = np.sort(rng.integers(0, n_seg + 1, E)).astype(np.int32)
        for data in (rng.integers(-5, 5, (E, d)).astype(np.int32),
                     rng.standard_normal((E, d)).astype(np.float32)):
            want = segment_sum_plain(t(data), t(ids), n_seg)
            before = launch_counts["segment_sum"]
            got = segment_sum(t(data).to(cuda_device),
                              t(ids).to(cuda_device), n_seg)
            torch.cuda.synchronize()
            assert launch_counts["segment_sum"] == before + 1
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.cuda
def test_tricount_kernel_on_card(cuda_device):
    """Both operand layouts at ragged n, bit for bit (0/1 operands make the
    int8 product exact); a value other than 0/1 raises."""
    rng = np.random.default_rng(2)
    for n in (1, 127, 130, 257, 1000):
        a = (rng.random((n, n)) < 0.2).astype(np.float32)  # not symmetric
        np.fill_diagonal(a, 0.0)
        cpu = t(a)
        for kernel, plain in ((tricount_oriented, tricount_oriented_plain),
                              (tricount_per_edge, tricount_per_edge_plain)):
            before = launch_counts["tricount"]
            got = kernel(cpu.to(cuda_device))
            torch.cuda.synchronize()
            assert launch_counts["tricount"] == before + 1
            assert torch.equal(got.cpu(), plain(cpu)), (n, kernel.__name__)
    with pytest.raises(ValueError, match="other than 0 and 1"):
        tricount_oriented(torch.full((5, 5), 2.0, device=cuda_device))


@pytest.mark.cuda
def test_chunked_build_on_card(cuda_device):
    """The dense fast path (one tricount launch) and the sparse path on the
    card equal the CPU build array for array."""
    g = barabasi_albert(300, 5, seed=3, device="cpu")
    want = build_problem(g, 2, 3, device="cpu")
    for fastpath in (True, False):
        before = launch_counts["tricount"]
        got = build_problem(g, 2, 3, build="chunked", fastpath=fastpath,
                            chunk_size=None if fastpath else 17,
                            device=cuda_device)
        assert launch_counts["tricount"] == before + int(fastpath)
        assert got.build_stats["fastpath"] == fastpath
        for f in ("r_cliques", "inc_rid", "mem_offsets", "mem_sids", "deg0"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def row_rel_err(got, want):
    """max over rows of ||got - want|| / ||want||, norms over the head dim"""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30))
                 .max())


@pytest.mark.cuda
def test_flash_attention_kernel_on_card(cuda_device):
    """The kernel vs its plain twin in the working type: ragged Sq/Sk, GQA,
    each supported head dim, causal and not, Sq < Sk, and (B, S, H, D)
    tensors read through transposed views.  The bar is on each output row
    (one query's D values): ||got - want|| / ||want|| <= 1e-2 in bf16,
    whose output rounding is relative (2^-9), and 1e-4 in float32 (sums in
    another order).  The kernel with q scaled by 1.03 (the softmax scale 3%
    off) must fail the same bar."""
    rng = np.random.default_rng(3)
    cases = [  # B, H, Hkv, Sq, Sk, D, causal, dtype
        (1, 2, 2, 96, 96, 64, True, torch.bfloat16),
        (2, 4, 2, 130, 130, 128, True, torch.bfloat16),
        (1, 4, 1, 77, 77, 160, True, torch.bfloat16),
        (1, 3, 3, 40, 200, 64, True, torch.bfloat16),
        (2, 2, 1, 65, 129, 128, False, torch.bfloat16),
        (1, 2, 2, 100, 100, 64, True, torch.float32),
        (1, 4, 2, 33, 70, 160, False, torch.float32),
        (1, 2, 2, 1, 1, 64, True, torch.bfloat16),
    ]
    for B, H, Hkv, Sq, Sk, D, causal, dt in cases:
        q = t(rng.standard_normal((B, Sq, H, D), dtype=np.float32)).to(dt)
        k = t(rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32)).to(dt)
        v = t(rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32)).to(dt)
        args = [x.to(cuda_device).transpose(1, 2) for x in (q, k, v)]
        before = launch_counts["flash_attention"]
        got = flash_attention(*args, causal=causal)
        torch.cuda.synchronize()
        assert launch_counts["flash_attention"] == before + 1
        assert got.stride() == args[0].stride()
        want = flash_attention_plain(*args, causal=causal)
        tol = 1e-2 if dt == torch.bfloat16 else 1e-4
        case = (B, H, Hkv, Sq, Sk, D, causal, dt)
        assert row_rel_err(got, want) <= tol, case
        if Sk > 1:  # one key: the output is v whatever the scale
            ctl = flash_attention(args[0] * 1.03, *args[1:], causal=causal)
            assert row_rel_err(ctl, want) > tol, case
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros((1, 1, 8, 32), device=cuda_device)
        flash_attention(x, x, x)


def segment_cases(rng):
    """(name, ids, n_seg) at the flat-tile design's edges (tiles of 4,096
    rows, 16 per thread): a segment over many tiles, power-law lengths like
    the engine's plan, long gaps with ids starting above 0, nothing but the
    pad id, and every E from 1 to 17 (the 16-row vector loads' tails)."""
    lengths = np.minimum(rng.zipf(1.8, 3000), 900)
    yield "three segments over 200,000 rows", np.sort(
        rng.integers(0, 3, 200_000)), 3
    yield "power-law lengths", np.repeat(
        np.arange(lengths.size), lengths), lengths.size
    gaps = np.cumsum(rng.integers(1, 3000, 400)) + 5000
    yield "long gaps, ids from 5,000", np.sort(
        rng.choice(gaps, 20_000)), int(gaps[-1]) + 7000
    yield "all pad ids", np.full(9000, 700), 700
    for E in range(1, 18):
        yield f"E={E}", np.sort(rng.integers(0, 6, E)), 5


@pytest.mark.cuda
def test_segment_sum_edges_on_card(cuda_device):
    """The flat-tile kernel vs its plain twin at its edges, int32 bit for bit
    and float32 within 1e-5 relative (sums in another fixed order), also
    through views one row in, whose pointers miss the vector loads'
    16-byte alignment."""
    rng = np.random.default_rng(4)
    for name, ids, n_seg in segment_cases(rng):
        ids = ids.astype(np.int32)
        E = ids.size
        for data in (rng.integers(-5, 6, (E + 1, 1)).astype(np.int32),
                     rng.standard_normal((E + 1, 1)).astype(np.float32)):
            ids1 = np.concatenate([ids[:1], ids])
            for d_dev, i_dev, d_cpu, i_cpu in (
                    (t(data[1:]).to(cuda_device), t(ids).to(cuda_device),
                     t(data[1:]), t(ids)),
                    (t(data).to(cuda_device)[1:], t(ids1).to(cuda_device)[1:],
                     t(data)[1:], t(ids1)[1:])):
                got = segment_sum(d_dev, i_dev, n_seg).cpu()
                want = segment_sum_plain(d_cpu, i_cpu, n_seg)
                if data.dtype == np.int32:
                    assert torch.equal(got, want), name
                else:
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=1e-5, msg=name)


@pytest.mark.cuda
def test_flash_attention_edges_on_card(cuda_device):
    """The wgmma kernel's tile edges (128 query rows a block, 128 keys a
    tile): Sq and Sk one off a multiple of 128, causal and not, B > 1 with
    GQA, and D = 128 at Sq = 2,048; the same per-row bar and q x 1.03
    control as above."""
    rng = np.random.default_rng(5)
    cases = [  # B, H, Hkv, Sq, Sk, D, causal
        (1, 4, 4, 127, 127, 64, True),
        (1, 4, 4, 129, 129, 64, True),
        (1, 4, 2, 255, 255, 128, True),
        (1, 4, 4, 257, 257, 64, False),
        (1, 2, 2, 129, 257, 64, True),
        (1, 2, 2, 255, 127, 128, False),
        (3, 8, 2, 257, 257, 64, True),
        (2, 6, 3, 255, 255, 128, False),
        (1, 24, 8, 2048, 2048, 128, True),
    ]
    for B, H, Hkv, Sq, Sk, D, causal in cases:
        q = t(rng.standard_normal((B, Sq, H, D), dtype=np.float32))
        k = t(rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32))
        v = t(rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32))
        args = [x.to(torch.bfloat16).to(cuda_device).transpose(1, 2)
                for x in (q, k, v)]
        got = flash_attention(*args, causal=causal)
        want = flash_attention_plain(*args, causal=causal)
        ctl = flash_attention(args[0] * 1.03, *args[1:], causal=causal)
        case = (B, H, Hkv, Sq, Sk, D, causal)
        assert row_rel_err(got, want) <= 1e-2, case
        assert row_rel_err(ctl, want) > 1e-2, case


def kcore_slots(rng, n, m):
    """The k-core lane's plan on a random graph of n vertices and about m
    edges, a third of the vertices isolated (empty segments) and one
    vertex a hub (a run over many of the kernel's tiles): (vids, nbrs),
    vids ascending."""
    live = rng.choice(n, size=2 * n // 3, replace=False)
    u = rng.choice(live, m)
    v = rng.choice(live, m)
    u[: m // 4] = live[0]                     # the hub
    keep = u != v
    e = np.unique(np.sort(np.stack([u[keep], v[keep]], 1), 1), axis=0)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    order = np.argsort(src, kind="stable")
    return src[order].astype(np.int32), dst[order].astype(np.int32)


@pytest.mark.cuda
def test_segment_sum_at_the_kcore_lane_shape(cuda_device):
    """The lane's decrement: (2m, 1) int32 of a peeled mask gathered by the
    neighbor slots, summed by the ascending vertex slots, with dense runs
    (a hub) and empty vertices; bit-identical to the plain twin, one
    launch a call."""
    rng = np.random.default_rng(12)
    for n, m in [(1, 0), (7, 12), (5_000, 40_000), (300_000, 1_500_000)]:
        vids, nbrs = kcore_slots(rng, n, m) if m else (
            np.zeros(0, np.int32), np.zeros(0, np.int32))
        for frac in (0.0, 0.05, 1.0):
            a = (rng.random(n) < frac).astype(np.int32)
            data = t(a[nbrs][:, None])
            want = segment_sum_plain(data, t(vids), n)
            before = launch_counts["segment_sum"]
            got = segment_sum(data.to(cuda_device), t(vids).to(cuda_device),
                              n)
            torch.cuda.synchronize()
            assert launch_counts["segment_sum"] == before + 1
            assert torch.equal(got.cpu(), want), (n, m, frac)


@pytest.mark.cuda
def test_kcore_lane_on_card(cuda_device):
    """decompose at (1,2) on the card: the lane launches the segment sum
    once a round and no megakernel, and its arrays equal the CPU lane's
    and the card's generic engine on the megakernel."""
    from repro_torch import NucleusConfig, decompose
    from repro_torch.graph.generators import community_power_law
    for g_cpu in (golden_suite()["planted40"](device="cpu"),
                  community_power_law(3_000, seed=2, device="cpu")):
        before = dict(launch_counts)
        lane = decompose(g_cpu, NucleusConfig(r=1, s=2), device=cuda_device)
        assert launch_counts["segment_sum"] - before["segment_sum"] == \
            lane.rounds
        assert launch_counts["peel_round"] == before["peel_round"]
        on_cpu = decompose(g_cpu, NucleusConfig(r=1, s=2), device="cpu")
        pinned = decompose(g_cpu, NucleusConfig(r=1, s=2, use_kernel=True),
                           device=cuda_device)
        assert launch_counts["peel_round"] - before["peel_round"] == \
            pinned.rounds
        for other in (on_cpu, pinned):
            assert other.rounds == lane.rounds
            for f in ("core", "order_round", "uf_parent", "uf_L"):
                np.testing.assert_array_equal(getattr(lane, f),
                                              getattr(other, f), err_msg=f)


@pytest.mark.cuda
def test_padded_session_on_card(cuda_device):
    """Session.decompose on the card: a (2,3) pool launches the megakernel
    once a round, a (1,2) pool the k-core lane's segment sum; the arrays
    equal the CPU's decompose, and a second same-bucket graph counts
    warm."""
    from repro_torch import NucleusConfig, Session, decompose
    from repro_torch.graph.generators import community_power_law
    # one size, two seeds: one shape class with the kernel's e_pad too
    graphs = [community_power_law(4_000, seed=i, device="cpu")
              for i in range(2)]
    for cfg, kernel in ((NucleusConfig(), "peel_round"),
                        (NucleusConfig(r=1, s=2), "segment_sum"),
                        (NucleusConfig(method="approx"), "peel_round")):
        sess = Session(cfg)
        for g in graphs:
            before = dict(launch_counts)
            got = sess.decompose(g)
            assert launch_counts[kernel] - before[kernel] == got.rounds
            want = decompose(g, cfg, device="cpu")
            assert got.rounds == want.rounds
            for f in ("core", "order_round", "peel_value", "uf_parent",
                      "uf_L"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f), err_msg=f)
        assert (sess.stats["cold"], sess.stats["warm"]) == (1, 1)
        assert sess.prewarm(sess.manifest()) == 1


@pytest.mark.cuda
def test_update_on_card(cuda_device):
    """Decomposition.update on the card at (1,2) and (2,3): equal to a
    fresh decompose of the edited graph on the CPU, problem kept on the
    card."""
    from repro_torch import GraphDelta, NucleusConfig, decompose
    from repro_torch.graph.generators import community_power_law
    g = community_power_law(3_000, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    edges = g.edges.numpy()
    present = {tuple(e) for e in edges.tolist()}
    ins = []
    while len(ins) < 4:
        u, v = sorted(int(x) for x in rng.integers(0, g.n, 2))
        if u != v and (u, v) not in present and (u, v) not in ins:
            ins.append((u, v))
    dels = edges[rng.choice(edges.shape[0], 4, replace=False)]
    delta = GraphDelta(insert=np.array(ins), delete=dels)
    for cfg in (NucleusConfig(), NucleusConfig(r=1, s=2)):
        new = decompose(g, cfg, device=cuda_device).update(delta)
        assert new.problem.device.type == "cuda"
        fresh = decompose(new.problem.g.to(torch.device("cpu")), cfg,
                          device="cpu")
        for f in ("core", "uf_parent", "uf_L"):
            np.testing.assert_array_equal(getattr(new, f),
                                          getattr(fresh, f), err_msg=f)
        kmax = int(fresh.core.max())
        for c in (1, max(kmax // 2, 1), kmax):
            np.testing.assert_array_equal(new.cut(c), fresh.cut(c))
