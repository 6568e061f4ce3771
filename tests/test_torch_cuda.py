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

from repro_torch.core.incidence import build_problem
from repro_torch.graph.generators import barabasi_albert
from repro_torch.kernels import launch_counts
from repro_torch.kernels.peel_round import fused_peel_round, \
    peel_round_plain
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


def random_round(rng, n_r, E, C):
    """A rid-sorted CSR plan (5% pad members) + a random round state."""
    rids = np.sort(rng.integers(0, n_r, E)).astype(np.int32)
    members = rng.integers(0, n_r, (E, C)).astype(np.int32)
    if E:
        members[rng.random((E, C)) < 0.05] = -1
    offsets = np.searchsorted(rids, np.arange(n_r + 1)).astype(np.int32)
    state = [rng.integers(0, 12, n_r), rng.integers(0, 2, n_r),
             rng.integers(-1, 9, n_r), rng.integers(-1, 9, n_r)]
    return [t(offsets), t(members)] + [t(x.astype(np.int32)) for x in state]


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
