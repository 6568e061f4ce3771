"""Sorted-segment sum: ``out[n] = sum(data[k] for ids[k] == n)``.

Replaces ``repro/kernels/segment_sum.py::segment_sum_sorted`` (and its
wrapper ``repro/kernels/ops.py::segment_sum``).  The CUDA source is
``csrc/segment_sum.cu``; its header note says what bounds it on an H100
(memory: data and ids read once) and how the design answers that (flat
tiles of consecutive rows, each thread summing the runs in its rows, a
segmented scan joining runs across threads, the block holding a segment's
first row writing it once; no atomics, no search).  int32 data sums in int32, float32 in float32, for any width d.
The kernel takes the ids unpadded, so the reference's ``sorted_ids_plan``
(tile padding, per-block chunk bound) has no counterpart.
"""
from __future__ import annotations

import torch

from . import count_launch, ref
from ._checks import kernel_device, need

INT = torch.int32
_ENTRY = {torch.int32: "repro_segment_sum_i32",
          torch.float32: "repro_segment_sum_f32"}


def segment_sum_plain(data: torch.Tensor, ids: torch.Tensor,
                      n_segments: int) -> torch.Tensor:
    """The plain-torch version (the CPU path and the kernel's oracle)."""
    return ref.segment_sum_ref(data, ids, n_segments)


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """data (E, d) int32/float32, ids (E,) int32 ASCENDING -> (n_segments, d).

    Rows whose id lies outside [0, n_segments) are dropped (pads carry
    id = n_segments).  The ascending order is the caller's contract (the
    engine's plan is sorted by construction) and is not re-checked here:
    that would cost a device sync per call.  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream.
    """
    dev = kernel_device((data, ids), "segment_sum")
    if dev.type == "cpu":
        return segment_sum_plain(data, ids, n_segments)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {dev}")
    if data.dtype not in _ENTRY:
        raise TypeError(f"segment_sum: data must be int32 or float32, got "
                        f"{data.dtype}")
    need(data, "data", data.dtype, 2)
    need(ids, "ids", INT, 1)
    E, d = int(data.shape[0]), int(data.shape[1])
    if int(ids.shape[0]) != E:
        raise ValueError(f"ids has {ids.shape[0]} rows, data has {E}")
    n_segments = int(n_segments)
    if not 0 <= n_segments < (1 << 31):
        raise ValueError(f"n_segments={n_segments} out of range")
    out = torch.empty((n_segments, d), dtype=data.dtype, device=dev)
    if n_segments == 0 or d == 0:
        return out.zero_()
    from ._build import check, library
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = getattr(lib, _ENTRY[data.dtype])(
            data.data_ptr(), ids.data_ptr(), E, d, n_segments,
            out.data_ptr(), stream)
    count_launch("segment_sum")
    check(status, _ENTRY[data.dtype])
    return out
