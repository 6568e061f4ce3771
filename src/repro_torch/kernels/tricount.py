"""Masked 0/1 matrix products for triangle counting.

Replaces ``repro/kernels/tricount.py::_masked_matmul`` (the TPU kernel) and
its entry points ``tricount_per_edge``, ``tricount_oriented`` and
``triangle_count``.  The CUDA source is ``csrc/tricount.cu``; its header
note says what bounds the function on an H100 (bytes: one read of adj, one
write of out; the mask keeps nnz(adj) of the n² outputs) and what the
design does (a pack pass into row bitsets, then per output row the zeros
and a count at each of the row's nonzeros only, by bit probes or popcounts
over the bitsets).

The reference zero-pads n to its 128 tile and slices the result; the
kernel masks the ragged edge itself, so the wrappers take any n and return
exactly ``[:n, :n]`` of the reference's padded call.  The kernel is exact
for 0/1 operands, the contract of every caller; on CUDA tensors a value
other than 0 or 1 raises ``ValueError``.
"""
from __future__ import annotations

import torch

from . import launch_counts, ref
from ._checks import kernel_device, need

WORD = 32  # columns per bitset word


def tricount_per_edge_plain(adj: torch.Tensor) -> torch.Tensor:
    """The plain-torch version (the CPU path and the kernel's oracle)."""
    return ref.tricount_per_edge_ref(adj)


def tricount_oriented_plain(adj: torch.Tensor) -> torch.Tensor:
    """The plain-torch version (the CPU path and the kernel's oracle)."""
    return ref.tricount_oriented_ref(adj)


def _masked_product(adj: torch.Tensor, op_transposed: bool, plain,
                    name: str) -> torch.Tensor:
    """(adj @ op(adj)) ⊙ adj, op = transpose or identity: the plain version
    on CPU tensors, the kernel on CUDA tensors (or a raise)."""
    if adj.dim() != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"{name}: adj must be (n, n), got "
                         f"{tuple(adj.shape)}")
    dev = kernel_device((adj,), name)
    if dev.type == "cpu":
        return plain(adj)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    need(adj, "adj", torch.float32, 2)
    n = int(adj.shape[0])
    out = torch.empty((n, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    # bitset scratch: row bitsets, and column bitsets for op = identity
    rows = torch.empty((n, -(-n // WORD)), dtype=torch.int32, device=dev)
    cols = rows if op_transposed else torch.empty_like(rows)
    bad = torch.zeros((1,), dtype=torch.int32, device=dev)
    from ._build import check, library
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.repro_tricount(
            adj.data_ptr(), n, int(op_transposed), rows.data_ptr(),
            cols.data_ptr(), out.data_ptr(), bad.data_ptr(), stream)
    launch_counts["tricount"] += 1
    check(status, "repro_tricount")
    if int(bad.item()):
        raise ValueError(f"{name}: adj holds a value other than 0 and 1")
    return out


def tricount_per_edge(adj: torch.Tensor) -> torch.Tensor:
    """Per-pair triangle counts (A @ A) ⊙ A.

    adj: (n, n) float32 in {0, 1}, symmetric with a zero diagonal, any n.
    Returns (n, n) float32: count[u, v] = #common neighbors on an edge.
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (and wait for its 0/1 check).
    """
    return _masked_product(adj, False, tricount_per_edge_plain,
                           "tricount_per_edge")


def tricount_oriented(adj: torch.Tensor) -> torch.Tensor:
    """Per-DAG-edge extension counts (D @ Dᵀ) ⊙ D.

    adj: (n, n) float32 in {0, 1}, the oriented adjacency (adj[u, v] = 1
    iff u→v), any n.  Returns (n, n) float32 with out[u, v] = |N⁺(u) ∩
    N⁺(v)| on u→v and 0 elsewhere: the triangles the chunked (2,3) build
    lists for that edge.  Dᵀ is read by indexing, never materialized.
    """
    return _masked_product(adj, True, tricount_oriented_plain,
                           "tricount_oriented")


def triangle_count(adj: torch.Tensor) -> torch.Tensor:
    """Total triangles = sum((A @ A) ⊙ A) / 6, as a float32 scalar."""
    return torch.sum(tricount_per_edge(adj)) / 6.0
