"""Flash attention: online-softmax attention, causal by index or not.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the TPU
kernel) and, through ``ops.attention``, its padding wrapper.  The CUDA
source is ``csrc/flash_attention.cu``; its header note says what bounds the
function on an H100 (operations: 4·D flops per visible (query, key) pair)
and what the design does about it (bf16 at D = 64 and 128: a producer
warpgroup streaming K/V tiles by TMA through an mbarrier ring, three (D =
64) or two (D = 128) consumer warpgroups of 64 query rows on ``wgmma``,
taking turns, with the running max, sum and accumulator in registers;
causal blocks stop at the diagonal; D = 160 and float32 keep the first
``mma.sync``/FMA design).

Beyond the TPU kernel's contract, the kernel masks the ragged edge itself
(any Sq and Sk, no padded copy), reads K and V of query head ``h`` from KV
head ``h // (H // Hkv)`` (GQA without a repeat), and takes strides, so a
``(B, S, H, D)`` tensor viewed as ``(B, H, S, D)`` needs no transpose copy.
Numerics follow the TPU kernel: scale ``1/sqrt(D)``, mask value -1e30, f32
statistics, p cast to V's dtype before the P·V product, output
``acc / max(l, 1e-30)`` cast to ``q.dtype``.
"""
from __future__ import annotations

import torch

from . import launch_counts, ref
from ._checks import kernel_device, need_int32

HEAD_DIMS = (64, 128, 160)
_IS_F32 = {torch.bfloat16: 0, torch.float32: 1}
_ALIGN = 16  # bytes: the kernel moves rows in 16-byte pieces


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The plain-torch version (the CPU path and the kernel's oracle):
    ``ref.attention_ref`` with each KV head repeated for its query heads."""
    G = q.shape[1] // k.shape[1]
    if G > 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    return ref.attention_ref(q, k, v, causal)


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q (B, H, Sq, D), k and v "
                         f"(B, Hkv, Sk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {k.shape[1]} KV heads")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype} differ")


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernel can read it through its strides (head dim
    contiguous, 16-byte aligned rows), else a contiguous copy."""
    es = x.element_size()
    if (x.stride(3) == 1 and x.data_ptr() % _ALIGN == 0 and
            all((x.stride(i) * es) % _ALIGN == 0 for i in range(3))):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B, H, Sq, D); k, v (B, Hkv, Sk, D), H % Hkv == 0 -> (B, H, Sq, D).

    Any Sq and Sk; causal masks key index > query index.  CPU tensors take
    the plain version; CUDA tensors launch the kernel on the current stream
    (bf16 or float32, D in ``HEAD_DIMS``) or raise.  The output has q's
    strides, so a (B, S, H, D) tensor's transposed view comes back as one.
    """
    _check_shapes(q, k, v)
    dev = kernel_device((q, k, v), "flash_attention")
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if q.dtype not in _IS_F32:
        raise TypeError(f"flash_attention: bf16 or float32, got {q.dtype}")
    B, H, Sq, D = (int(x) for x in q.shape)
    Hkv, Sk = int(k.shape[1]), int(k.shape[2])
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not one the "
                         f"kernel supports {HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H = {B * H} exceeds 65535")
    need_int32(Sq, "Sq")
    need_int32(Sk, "Sk")
    q, k, v = (_kernel_layout(x) for x in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    strides = [int(s) for x in (q, k, v, out) for s in x.stride()[:3]]
    from ._build import check, library
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _IS_F32[q.dtype], B, H, Hkv, Sq, Sk, D, int(bool(causal)),
            *strides, stream)
    launch_counts["flash_attention"] += 1
    check(status, "repro_flash_attention")
    return out
