"""Decoder-only transformer, dense GQA/MHA path (counterpart of
``repro.models.transformer``).

Plain functions on a parameter dict with the reference's names and layout:
every per-layer array is stacked on a leading ``n_layers`` axis, so the
reference's pytree converts leaf for leaf (``params_from_reference``).  The
model keeps the reference's ``(B, S, H, D)`` activations.

Attention has two routes, as in the reference's own test
``tests/test_kernels.py::test_flash_matches_model_online_attention``:

* a forward pass with no cache (``forward``, prefill) has positions
  ``0..S-1`` and every key valid, where the reference's ``online_attention``
  scan computes exactly the flash-attention function, so ``_attn`` calls
  ``kernels.ops.attention`` (causal): the hand-written kernel on the card,
  its plain twin on the CPU;
* a step against a KV cache (``decode_step``) keeps ``online_attention``,
  the torch counterpart of the reference's jnp scan, with its position
  offsets and ``k_valid_len`` mask.

Not yet ported: the MoE FFN (``moe_block``), MLA attention and
``loss_fn``; a config with ``moe`` or ``mla`` set builds (so its parameter
counts can be read) but the model functions raise ``NotImplementedError``
naming the part.  ``dtype`` is a torch dtype.  The reference's sharding and
cost hints (``cost_unroll``, ``moe_ep_data``, ``act_specs``) and ``remat``
(recompute in the backward pass) are dropped: the port runs on one device
and serves without a backward pass.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels import ops

NEG = -1e30  # finite -inf sentinel of the online-softmax scan


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0          # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64    # decoupled RoPE key dims (shared across heads)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    attn_chunk: int = 1024     # KV chunk of online_attention's scan
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    def param_count(self) -> int:
        """Total parameters (for 6ND MODEL_FLOPS accounting)."""
        d = self.d_model
        attn = self._attn_params()
        if self.moe is not None:
            ff = self.moe.d_ff_expert
            moe = self.moe.n_experts * 3 * d * ff + d * self.moe.n_experts \
                + self.moe.n_shared * 3 * d * ff
            per_layer = attn + moe + 2 * d
        else:
            per_layer = attn + 3 * d * self.d_ff + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        ff = self.moe.d_ff_expert
        act = self._attn_params() \
            + (self.moe.top_k + self.moe.n_shared) * 3 * d * ff \
            + d * self.moe.n_experts + 2 * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * act + emb + d

    def _attn_params(self) -> int:
        d, h = self.d_model, self.head_dim
        if self.mla is not None:
            r, pr = self.mla.kv_lora_rank, self.mla.rope_head_dim
            return d * (self.n_heads * h) + d * (r + pr) \
                + r * (self.n_heads * 2 * h) + self.n_heads * h * d
        return d * (self.n_heads + 2 * self.n_kv_heads) * h + self.n_heads * h * d


def _dense_only(cfg: TransformerConfig) -> None:
    for part in ("moe", "mla"):
        if getattr(cfg, part) is not None:
            raise NotImplementedError(
                f"{cfg.name}: {part}={getattr(cfg, part)!r} is not yet "
                f"ported to repro_torch; this slice runs the dense GQA/MHA "
                f"transformer")


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_angles(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.float()[..., None] * freqs  # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) broadcast over heads.  Rotates
    interleaved pairs (x[..., 0::2], x[..., 1::2])."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def online_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_valid_len: torch.Tensor,
                     causal: bool, chunk: int) -> torch.Tensor:
    """Flash-style attention: a loop over KV chunks with running (max, sum).

    q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D).  GQA: H % Hkv == 0, query head
    h reads KV head h // (H // Hkv) by reshape-grouping (no repeat).
    q_pos: (B, Sq) absolute positions for the causal mask.
    k_valid_len: (B,) number of valid cache slots.  Returns (B, Sq, H, D).
    Scores and the P·V product sum in float32 from the inputs' values, and
    probabilities re-enter P·V in V's dtype, as in the reference.
    """
    return _online_scan(q, k, v, _chunk_biases(q_pos, k_valid_len,
                                               k.shape[1], causal, chunk))


def _chunk_biases(q_pos: torch.Tensor, k_valid_len: torch.Tensor, Sk: int,
                  causal: bool, chunk: int
                  ) -> List[Tuple[int, int, torch.Tensor]]:
    """online_attention's masks as additive biases, one (lo, hi, (B, Sq,
    hi - lo)) per KV chunk.  They depend on positions only, so a decode
    step builds them once for all its layers."""
    out = []
    for lo in range(0, Sk, chunk):
        hi = min(lo + chunk, Sk)
        kpos = torch.arange(lo, hi, device=q_pos.device)       # (n,)
        mask = kpos[None, None, :] < k_valid_len[:, None, None]  # (B, 1, n)
        if causal:
            mask = mask & (kpos[None, None, :] <= q_pos[:, :, None])
        out.append((lo, hi, torch.where(mask, 0.0, NEG)))    # (B, Sq, n)
    return out


def _online_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 biases: List[Tuple[int, int, torch.Tensor]]) -> torch.Tensor:
    """online_attention's loop over the chunks of ``_chunk_biases``."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    # (B, Sq, Hkv, G, D) -> (B, Hkv, G, Sq, D)
    qt = q.reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4).float()
    dev = q.device
    m = torch.full((B, Hkv, G, Sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=dev)
    for lo, hi, bias in biases:
        # the reference pads the last chunk with zero keys; they are
        # masked (past k_valid_len), so their probabilities are exactly 0
        kb, vb = k[:, lo:hi].float(), v[:, lo:hi]
        s = torch.einsum("bhgqd,bkhd->bhgqk", qt, kb)
        s = s * scale + bias[:, None, None, :, :]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(),
                          vb.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    # (B, Hkv, G, Sq, D) -> (B, Sq, H, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
           w3: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ w1) * (x @ w3)
    return h @ w2


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _attn(x, params, cfg: TransformerConfig, rope, cache=None,
          cache_len: Optional[int] = None, biases=None):
    """GQA/MHA self-attention. Returns (out, new_cache_kv).

    ``rope`` is ``rope_angles`` of the positions.  With a cache, the new K/V
    rows are written into it in place at ``cache_len`` (the reference
    returns an updated copy) and the step attends over the whole cache
    through ``online_attention``'s scan with its chunk ``biases``.  Without
    one, the flash-attention kernel computes the same function.
    """
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, D)
    k = (x @ params["wk"]).reshape(B, S, Hkv, D)
    v = (x @ params["wv"]).reshape(B, S, Hkv, D)
    q = apply_rope(q, *rope)
    k = apply_rope(k, *rope)
    if cache is None:
        # (B, S, H, D) viewed as (B, H, S, D): the kernel reads and writes
        # through strides, so neither transpose copies
        out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True).transpose(1, 2)
        new_cache = None
    else:
        k_c, v_c = cache                                   # (B, Sc, Hkv, D)
        k_c[:, cache_len:cache_len + S] = k
        v_c[:, cache_len:cache_len + S] = v
        out = _online_scan(q, k_c, v_c, biases)
        new_cache = (k_c, v_c)
    out = out.reshape(B, S, H * D) @ params["wo"]
    return out, new_cache


def _layer(x, params, cfg: TransformerConfig, rope, cache=None,
           cache_len: Optional[int] = None, biases=None):
    h, new_cache = _attn(rmsnorm(x, params["ln1"], cfg.norm_eps), params,
                         cfg, rope, cache, cache_len, biases)
    x = x + h
    z = rmsnorm(x, params["ln2"], cfg.norm_eps)
    y = swiglu(z, params["w1"], params["w2"], params["w3"])
    return x + y, new_cache


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _dense(gen: torch.Generator, shape, dtype, device, scale=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(float(s)).to(device=device, dtype=dtype)


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Stacked-layer params with the reference's names, shapes, dtypes and
    scales: every per-layer array has leading dim n_layers.

    ``generator`` (default: seed 0 on the target device) draws the normal
    samples; it does not reproduce ``jax.random``'s numbers.
    """
    _dense_only(cfg)
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    d, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L, dt = cfg.n_layers, cfg.dtype

    def dense(shape, scale=None):
        return _dense(gen, shape, dt, dev, scale)

    layer: Dict[str, torch.Tensor] = {
        "ln1": torch.ones((L, d), dtype=dt, device=dev),
        "ln2": torch.ones((L, d), dtype=dt, device=dev),
        "wo": dense((L, H * D, d)),
        "wq": dense((L, d, H * D)),
        "wk": dense((L, d, Hkv * D)),
        "wv": dense((L, d, Hkv * D)),
        "w1": dense((L, d, cfg.d_ff)),
        "w2": dense((L, cfg.d_ff, d)),
        "w3": dense((L, d, cfg.d_ff)),
    }
    params: Dict[str, Any] = {
        "embed": dense((cfg.vocab, d), scale=1.0),
        "ln_f": torch.ones((d,), dtype=dt, device=dev),
        "layers": layer,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense((d, cfg.vocab))
    return params


_NP_TO_TORCH = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def params_from_reference(np_params: Dict[str, Any], cfg: TransformerConfig,
                          device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter pytree (numpy arrays, e.g. from
    ``jax.device_get``) as the port's parameters, leaf for leaf.

    bf16 leaves (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` does not
    take) go through float32, which holds every bf16 value exactly.
    """
    _dense_only(cfg)
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        a = np.asarray(a)
        if a.dtype.name not in _NP_TO_TORCH:
            raise TypeError(f"unsupported parameter dtype {a.dtype}")
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=_NP_TO_TORCH[a.dtype.name])

    return conv(np_params)


# ---------------------------------------------------------------------------
# forward / decode
# ---------------------------------------------------------------------------

def _layer_params(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


def trunk(params: Dict[str, Any], tokens: torch.Tensor,
          cfg: TransformerConfig) -> torch.Tensor:
    """tokens (B, S) -> the last layer's output (B, S, d_model)."""
    _dense_only(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device).expand(B, S)
    rope = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x, _ = _layer(x, _layer_params(params, i), cfg, rope)
    return x


def head(params: Dict[str, Any], x: torch.Tensor,
         cfg: TransformerConfig) -> torch.Tensor:
    """Final norm and unembedding: (..., d_model) -> (..., vocab)."""
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    unemb = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ unemb


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab)."""
    return head(params, trunk(params, tokens, cfg), cfg)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked KV cache (k, v), each (L, batch, max_len, Hkv, D), zeros."""
    _dense_only(cfg)
    dt = dtype or cfg.dtype
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def decode_step(params: Dict[str, Any], tokens: torch.Tensor, cache: Any,
                cache_len: Union[int, torch.Tensor], cfg: TransformerConfig):
    """One decode step: tokens (B, S_new) appended at cache_len.

    Returns (logits (B, S_new, vocab), cache, new_len).  The cache is
    updated in place and returned (the reference returns a new one);
    ``cache_len`` is a host integer, so a step needs no device sync.
    """
    _dense_only(cfg)
    B, S = tokens.shape
    off = int(cache_len)
    x = params["embed"][tokens.long()]
    k_c, v_c = cache                           # (L, B, Sc, Hkv, D)
    if off + S > k_c.shape[2]:
        raise ValueError(f"KV cache of {k_c.shape[2]} slots cannot take "
                         f"{S} tokens at {off}")
    positions = off + torch.arange(S, device=x.device).expand(B, S)
    # rope and the chunk masks depend on positions only: once per step
    rope = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    valid = torch.full((B,), off + S, dtype=torch.int32, device=x.device)
    biases = _chunk_biases(positions, valid, k_c.shape[2], True,
                           cfg.attn_chunk)
    for i in range(cfg.n_layers):
        x, _ = _layer(x, _layer_params(params, i), cfg, rope,
                      cache=(k_c[i], v_c[i]), cache_len=off, biases=biases)
    return head(params, x, cfg), cache, off + S
