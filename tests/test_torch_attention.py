"""The port's attention (plain twin and ``ops.attention`` on CPU tensors)
against the reference's ``ref.attention_ref`` and ``ops.attention`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
against the model's ``online_attention`` for GQA.

Inputs come from numpy seeds; bf16 inputs are rounded from the same f32
values on both sides.  Tolerances are those of ``tests/test_kernels.py``:
2e-5 in float32 (sums in another order), 2e-2 in bf16 (the output is
rounded to bf16, one ulp near 2 is 1.6e-2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.transformer import online_attention as j_online
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
GRID = [  # (B, H, Sq, Sk, D, bq, bk) of tests/test_kernels.py
    (1, 1, 64, 64, 32, 32, 32),
    (2, 3, 128, 128, 64, 64, 64),
    (1, 2, 96, 96, 64, 32, 32),      # padding path in the reference
    (2, 1, 128, 128, 128, 128, 128),
]


def inputs(seed, q_shape, k_shape, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(q_shape).astype(np.float32),
            rng.standard_normal(k_shape).astype(np.float32),
            rng.standard_normal(k_shape).astype(np.float32)]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,Sq,Sk,D,bq,bk", GRID)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_ref_matches_reference(B, H, Sq, Sk, D, bq, bk, dtype):
    (jq, jk, jv), (q, k, v) = inputs(0, (B, H, Sq, D), (B, H, Sk, D), dtype)
    got = ref.attention_ref(q, k, v, causal=True)
    assert got.dtype == q.dtype
    close(got, jref.attention_ref(jq, jk, jv, causal=True), DTYPES[dtype][2])


@pytest.mark.parametrize("B,H,Sq,Sk,D,bq,bk", GRID)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ops_attention_matches_reference_kernel(B, H, Sq, Sk, D, bq, bk,
                                                dtype):
    """CPU tensors take the plain twin and launch nothing."""
    (jq, jk, jv), (q, k, v) = inputs(0, (B, H, Sq, D), (B, H, Sk, D), dtype)
    before = launch_counts["flash_attention"]
    got = ops.attention(q, k, v, causal=True, block_q=bq, block_k=bk)
    assert launch_counts["flash_attention"] == before
    want = jops.attention(jq, jk, jv, causal=True, block_q=bq, block_k=bk)
    close(got, want, DTYPES[dtype][2])


def test_ops_attention_noncausal():
    (jq, jk, jv), (q, k, v) = inputs(1, (1, 2, 64, 32), (1, 2, 64, 32),
                                     "f32")
    got = ops.attention(q, k, v, causal=False, block_q=32, block_k=32)
    want = jops.attention(jq, jk, jv, causal=False, block_q=32, block_k=32)
    close(got, want, 2e-5)


def test_ops_attention_noncausal_ragged_keys_raise():
    """Both packages refuse non-causal keys that need padding."""
    (jq, jk, jv), (q, k, v) = inputs(2, (1, 2, 64, 32), (1, 2, 40, 32),
                                     "f32")
    with pytest.raises(ValueError, match="pre-pad keys"):
        ops.attention(q, k, v, causal=False, block_q=32, block_k=32)
    with pytest.raises(AssertionError, match="pre-pad keys"):
        jops.attention(jq, jk, jv, causal=False, block_q=32, block_k=32)
    # keys that fill whole blocks are fine without causal
    out = ops.attention(q, k, v, causal=False, block_q=32, block_k=40)
    assert out.shape == q.shape


@pytest.mark.parametrize("Sq,Sk", [(40, 96), (40, 100)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ops_attention_fewer_queries_than_keys(Sq, Sk, dtype):
    """Causal by index with Sq < Sk: query i sees keys 0..i (the
    reference pads Sk = 100 to 128; the pad keys lie past every query)."""
    (jq, jk, jv), (q, k, v) = inputs(3, (2, 2, Sq, 64), (2, 2, Sk, 64),
                                     dtype)
    got = ops.attention(q, k, v, causal=True, block_q=32, block_k=32)
    want = jops.attention(jq, jk, jv, causal=True, block_q=32, block_k=32)
    close(got, want, DTYPES[dtype][2])
    close(got, jref.attention_ref(jq, jk, jv, causal=True), DTYPES[dtype][2])


@pytest.mark.parametrize("H,Hkv", [(4, 2), (6, 1), (4, 4)])
def test_gqa_grouping_matches_online_attention(H, Hkv):
    """Query head h reads KV head h // (H // Hkv): the port's kernel call
    on (B, H, S, D) views of the model's (B, S, H, D) tensors equals the
    reference model's online_attention scan."""
    B, S, D = 2, 48, 32
    (jq, jk, jv), (q, k, v) = inputs(4, (B, S, H, D), (B, S, Hkv, D), "f32")
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    want = j_online(jq, jk, jv, pos, jnp.full((B,), S, jnp.int32),
                    causal=True, chunk=16)
    got = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True).transpose(1, 2)
    close(got, want, 2e-5)


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,causal", [
    (1, 2, 2, 127, 127, True), (1, 2, 1, 129, 257, True),
    (2, 4, 2, 255, 255, True), (1, 2, 2, 257, 129, False)])
def test_flash_attention_tile_edges_match_reference(B, H, Hkv, Sq, Sk,
                                                    causal):
    """The wrapper (its plain version on CPU) vs the reference's oracle at
    the CUDA kernel's block and tile edges (128 keys a tile; 192 or 128
    query rows a block), with GQA, on (B, S, H, D) tensors viewed as
    (B, H, S, D): the inputs tests/test_torch_cuda.py holds the kernel to."""
    D = 64
    (jq, jk, jv), (q, k, v) = inputs(5, (B, Sq, H, D), (B, Sk, Hkv, D),
                                     "f32")
    G = H // Hkv
    want = jref.attention_ref(*(jnp.swapaxes(x, 1, 2) for x in (
        jq, jnp.repeat(jk, G, axis=2), jnp.repeat(jv, G, axis=2))),
        causal=causal)
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal)
    close(got, want, 2e-5)


def test_shape_and_dtype_errors():
    q = torch.zeros((1, 3, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, torch.zeros((1, 2, 8, 16)), torch.zeros((1, 2, 8,
                                                                       16)))
    with pytest.raises(TypeError, match="differ"):
        flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="B, H, Sq, D"):
        flash_attention(q[0], q, q)
