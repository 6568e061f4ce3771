"""The peel-round megakernel: one launch per peel round.

Replaces ``repro/kernels/peel_round.py::fused_peel_round`` (the TPU
megakernel).  The CUDA source is ``csrc/peel_round.cu``; its header note
says what bounds it on an H100 (memory: the state stream, plus member rows
and one scattered int32 gather per member for the edges of the r-cliques
that are live and survive the round, the only ones whose deg changes) and
how the design answers that (a thread per r-clique reads its state and
skips the rest; the block's lanes walk the needed edges laid end to end by
a scan, whatever the run lengths; a ballot and popcount per run, no atomics
on deg).

The round state is ``(deg, key, core, order)``: ``key`` packs the peeled
flag into the degree, ``PEELED`` where the r-clique is peeled and its deg
where it is live (``peel_key``), so a member's one gather answers both of
the round's questions (peeled before the round? peeled at it?), and the
minimum of ``key`` is the minimum live degree, ``PEELED`` once every
r-clique is.  A live deg is a count of s-cliques, so it never reaches
``PEELED``.

The port's plan is ``(offsets, members)``: ``offsets`` is the incidence CSR
(``NucleusProblem.mem_offsets``, r-clique r owns edges
``offsets[r]:offsets[r+1]``) and ``members[k]`` is the full member row of
edge k's s-clique.  It needs no padding, so the reference's
``peel_round_plan`` (tile padding) and ``chunk_windows`` (per-block chunk
windows) have no counterpart: the CSR offsets are the windows.
``peel_round_plain`` computes the same function with ``ref.peel_round_ref``
over the reference's ids-based plan, so the kernel is held to the
reference's oracle.
"""
from __future__ import annotations

import torch

from . import launch_counts, ref
from ._checks import kernel_device, need, need_int32

INT = torch.int32
PEELED = 2 ** 31 - 1  # the key of a peeled r-clique (int32 max)


def peel_key(deg: torch.Tensor, peeled: torch.Tensor) -> torch.Tensor:
    """The round state's key: PEELED where ``peeled`` (bool or 0/1), else
    deg."""
    return torch.where(peeled.bool(), PEELED, deg)


def plan_ids(offsets: torch.Tensor, n_edges: int) -> torch.Tensor:
    """The per-edge r-clique id of a CSR plan (the reference's ``ids``)."""
    counts = (offsets[1:] - offsets[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(counts.shape[0], dtype=INT, device=offsets.device),
        counts, output_size=n_edges)


def peel_round_plain(offsets, members, deg, key, core, order, level, rnd):
    """The plain-torch version (the CPU path and the kernel's oracle): the
    reference's round on peeled = (key == PEELED)."""
    ids = plan_ids(offsets, int(members.shape[0]))
    deg, peeled, core, order = ref.peel_round_ref(
        ids, members, deg, (key == PEELED).to(INT), core, order, int(level),
        int(rnd))
    return deg, peel_key(deg, peeled), core, order


def fused_peel_round(offsets: torch.Tensor, members: torch.Tensor,
                     deg: torch.Tensor, key: torch.Tensor,
                     core: torch.Tensor, order: torch.Tensor,
                     level: int, rnd: int):
    """One peel round: (deg, key, core, order) -> the same, updated.

    offsets (n_r + 1,) int32 ascending; members (E, C) int32 (a member -1
    reads as already peeled); deg/key/core/order (n_r,) int32 with key =
    ``peel_key(deg, peeled)``; level, rnd Python ints.  CPU tensors take
    the plain version; CUDA tensors launch the kernel on the current
    stream.  The outputs are fresh tensors: the inputs are never written.
    """
    state = (deg, key, core, order)
    dev = kernel_device((offsets, members) + state, "fused_peel_round")
    if dev.type == "cpu":
        return peel_round_plain(offsets, members, deg, key, core, order,
                                level, rnd)
    if dev.type != "cuda":
        raise ValueError(f"fused_peel_round: unsupported device {dev}")
    n_r = int(deg.shape[0])
    need(offsets, "offsets", INT, 1)
    need(members, "members", INT, 2)
    if int(offsets.shape[0]) != n_r + 1:
        raise ValueError(f"offsets has {offsets.shape[0]} entries, "
                         f"expected n_r + 1 = {n_r + 1}")
    for name, t in zip(("deg", "key", "core", "order"), state):
        need(t, name, INT, 1)
        if int(t.shape[0]) != n_r:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected "
                             f"{n_r}")
    level = need_int32(level, "level")
    rnd = need_int32(rnd, "rnd")
    outs = tuple(torch.empty_like(t) for t in state)
    if n_r == 0:
        return outs
    from ._build import check, library
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.repro_peel_round(
            offsets.data_ptr(), members.data_ptr(), int(members.shape[1]),
            deg.data_ptr(), key.data_ptr(), core.data_ptr(),
            order.data_ptr(), *(o.data_ptr() for o in outs), n_r, level, rnd,
            stream)
    launch_counts["peel_round"] += 1
    check(status, "repro_peel_round")
    return outs
