"""Decoder-only transformer: GQA/MHA or MLA attention, SwiGLU or MoE FFN
(counterpart of ``repro.models.transformer``).

Plain functions on a parameter dict with the reference's names and layout:
every per-layer array is stacked on a leading ``n_layers`` axis, so the
reference's pytree converts leaf for leaf (``params_from_reference``).  The
model keeps the reference's ``(B, S, H, D)`` activations.

Attention has three routes, as in the reference's own test
``tests/test_kernels.py::test_flash_matches_model_online_attention``:

* a forward pass with no cache (``forward``, prefill) has positions
  ``0..S-1`` and every key valid, where the reference's ``online_attention``
  scan computes exactly the flash-attention function, so ``_attn`` calls
  ``kernels.ops.attention`` (causal): the hand-written kernel on the card,
  its plain twin on the CPU;
* training (``loss_fn``, ``train=True`` down to ``_attn``) attends through
  ``online_attention``'s scan with chunk ``attn_chunk`` on every device,
  as the reference's ``loss_fn`` does: the flash kernel has no backward
  pass (its wrapper raises under autograd on the card);
* a step against a KV cache (``decode_step``) keeps ``online_attention``,
  the torch counterpart of the reference's jnp scan, with its position
  offsets and ``k_valid_len`` mask.

MLA (DeepSeek-V2) caches the compressed latent and the shared rope key and
rebuilds K/V from them, over the whole cache at each decode step, as the
reference does.  The MoE FFN (``moe_block``) keeps the reference's
sort-based capacity dispatch: its drops are the reference's drops.  The
expert products are batched matmuls over the ``(E, cap, d)`` buffer (the
reference computes them outside any Pallas kernel too).

``loss_fn`` is the mean next-token cross entropy over float32 logits;
with ``remat`` each layer of the training route runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so the
backward pass recomputes a layer's activations instead of keeping them.
Every stacked leaf is unbound once per pass, so the backward pass stacks
each leaf's layer gradients once (indexing ``v[i]`` per layer would make
a zero-filled gradient of the whole stack per layer).  ``dtype`` is a
torch dtype.  The reference's sharding and cost hints (``cost_unroll``,
``moe_ep_data``, ``act_specs``) are dropped: they steer XLA inside one
jitted program, and the model runs eagerly on one device.  Training over
a named mesh gathers the parameters onto a slot's device and calls these
functions there (``launch.steps.lm_train_step_sharded``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device, default_generator
from ..kernels import ops
from .. import tree
from ..optim.adamw import AdamWState

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
    remat: bool = True         # recompute each layer in the backward pass
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
# MoE: top-k routing + sort-based capacity dispatch
# ---------------------------------------------------------------------------

def moe_capacity(T: int, cfg: MoEConfig) -> int:
    """Slots per expert for a call over T tokens, the reference's float
    expression."""
    return int(np.ceil(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def moe_route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (gate, eidx), each (T, K).

    float32 router logits and softmax; the K largest probabilities with
    ties toward the lower expert index, as ``jax.lax.top_k`` orders them
    (a stable descending sort; ``torch.topk`` promises no order among
    ties); gates renormalised by max(sum, 1e-9).
    """
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :cfg.top_k], eidx[:, :cfg.top_k]
    return gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9), eidx


def moe_slots(eidx: torch.Tensor, n_experts: int, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat (t, k) assignments' (slot, keep), each (T*K,), in (t, k)
    order: an entry's rank inside its expert in one stable sort by expert,
    kept below ``cap``."""
    flat_e = eidx.reshape(-1)
    dev = flat_e.device
    order = torch.argsort(flat_e, stable=True)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(flat_e.numel(), device=dev)
    # each expert's first position in the sorted order (no host sync, as
    # bincount's size check would make)
    starts = torch.searchsorted(flat_e[order],
                                torch.arange(n_experts, device=dev))
    slot = pos - starts[flat_e]
    return slot, slot < cap


def moe_block(x: torch.Tensor, params: Dict[str, torch.Tensor],
              cfg: MoEConfig) -> torch.Tensor:
    """x: (T, d) flat tokens -> (T, d).  Capacity-dropped sorted dispatch.

    Each kept assignment owns one slot of the (E, cap, d) buffer, so the
    dispatch is a copy (dropped ones land in a trash row past the buffer).
    The combine sums a token's K contributions in a fixed order, by
    ascending expert (the order of the reference's scatter-add over the
    expert-sorted entries), so the result has no atomic-order bits.
    """
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    cap = moe_capacity(T, cfg)
    gate, eidx = moe_route(x, params["router"], cfg)
    slot, keep = moe_slots(eidx, E, cap)
    row = eidx.reshape(-1) * cap + slot               # buffer row if kept
    buf = x.new_zeros((E * cap + 1, d))
    buf.index_copy_(0, torch.where(keep, row, E * cap),
                    x.repeat_interleave(K, dim=0))
    h = buf[:E * cap].view(E, cap, d)
    h = torch.nn.functional.silu(torch.bmm(h, params["w1"])) * \
        torch.bmm(h, params["w3"])
    out = torch.bmm(h, params["w2"]).view(E * cap, d)
    contrib = out[torch.where(keep, row, 0)] * \
        (gate.reshape(-1) * keep)[:, None].to(x.dtype)
    rows = torch.arange(T, device=x.device)[:, None] * K + \
        torch.argsort(eidx, dim=1)                   # (T, K) by expert
    y = contrib[rows[:, 0]]
    for j in range(1, K):
        y = y + contrib[rows[:, j]]
    if cfg.n_shared:
        y = y + swiglu(x, params["sw1"], params["sw2"], params["sw3"])
    return y


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _rope_dim(cfg: TransformerConfig) -> int:
    """The rotated dims: the head dim, or MLA's decoupled rope dims."""
    return cfg.mla.rope_head_dim if cfg.mla is not None else cfg.head_dim


def _attn(x, params, cfg: TransformerConfig, rope, cache=None,
          cache_len: Optional[int] = None, biases=None, train: bool = False):
    """Self-attention (GQA/MHA or MLA). Returns (out, new_cache).

    ``rope`` is ``rope_angles`` of the positions over ``_rope_dim(cfg)``.
    With a cache, the step's rows (K/V, or MLA's latent and rope key) are
    written into it in place at ``cache_len`` (the reference returns an
    updated copy) and the step attends over the whole cache through
    ``online_attention``'s scan with its chunk ``biases``.  ``train``
    (no cache) takes the same scan, which autograd differentiates.
    Otherwise the flash-attention kernel computes the same function.
    """
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, D)
    if cfg.mla is not None:
        pr = cfg.mla.rope_head_dim
        latent = x @ params["w_dkv"]                       # (B, S, r)
        k_rope = apply_rope((x @ params["w_kr"]).reshape(B, S, 1, pr), *rope)
        q = torch.cat([apply_rope(q[..., :pr], *rope), q[..., pr:]], dim=-1)
        if cache is not None:
            lat_c, kr_c = cache                # (B, Sc, r), (B, Sc, 1, pr)
            lat_c[:, cache_len:cache_len + S] = latent
            kr_c[:, cache_len:cache_len + S] = k_rope
            latent, k_rope = lat_c, kr_c
        Sk = latent.shape[1]
        k_nope = (latent @ params["w_uk"]).reshape(B, Sk, H, D - pr)
        v = (latent @ params["w_uv"]).reshape(B, Sk, H, D)
        k = torch.cat([k_rope.expand(B, Sk, H, pr), k_nope], dim=-1)
    else:
        k = apply_rope((x @ params["wk"]).reshape(B, S, Hkv, D), *rope)
        v = (x @ params["wv"]).reshape(B, S, Hkv, D)
        q = apply_rope(q, *rope)
        if cache is not None:
            k_c, v_c = cache                               # (B, Sc, Hkv, D)
            k_c[:, cache_len:cache_len + S] = k
            v_c[:, cache_len:cache_len + S] = v
            k, v = k_c, v_c
    if cache is None and not train:
        # (B, S, H, D) viewed as (B, H, S, D): the kernel reads and writes
        # through strides, so neither transpose copies
        out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True).transpose(1, 2)
    else:
        out = _online_scan(q, k, v, biases)
    out = out.reshape(B, S, H * D) @ params["wo"]
    return out, cache


def _layer(x, params, cfg: TransformerConfig, rope, cache=None,
           cache_len: Optional[int] = None, biases=None, train: bool = False):
    h, new_cache = _attn(rmsnorm(x, params["ln1"], cfg.norm_eps), params,
                         cfg, rope, cache, cache_len, biases, train)
    x = x + h
    z = rmsnorm(x, params["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        B, S, d = z.shape
        y = moe_block(z.reshape(B * S, d), params, cfg.moe).reshape(B, S, d)
    else:
        y = swiglu(z, params["w1"], params["w2"], params["w3"])
    return x + y, new_cache


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

DRAW_CHUNK = 1 << 26  # float32 samples drawn at a time (256 MB)


def _dense(gen: torch.Generator, shape, dtype, device, scale=None):
    """N(0, 1) samples times the scale, drawn in float32 ``DRAW_CHUNK`` at a
    time into a preallocated tensor of ``dtype``: a whole stacked expert
    tensor in float32 would not fit beside the rest (moonshot's ``w1`` is
    8.9·10^9 values)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    s = float(scale if scale is not None else 1.0 / np.sqrt(fan_in))
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    flat = out.view(-1)
    for lo in range(0, flat.numel(), DRAW_CHUNK):
        n = min(DRAW_CHUNK, flat.numel() - lo)
        w = torch.randn(n, generator=gen, dtype=torch.float32,
                        device=gen.device)
        flat[lo:lo + n].copy_(w.mul_(s))
    return out


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Stacked-layer params with the reference's names, shapes, dtypes and
    scales: every per-layer array has leading dim n_layers.  MoE configs
    carry the reference's float32 ``router`` in every dtype.

    ``generator`` (default: seed 0 on the target device) draws the normal
    samples; it does not reproduce ``jax.random``'s numbers.  On the
    ``meta`` device nothing is drawn: the tree holds the shapes and
    dtypes alone (what the sharding rules read).
    """
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = default_generator(dev)
    d, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L, dt = cfg.n_layers, cfg.dtype

    def dense(shape, scale=None, dtype=dt):
        return _dense(gen, shape, dtype, dev, scale)

    layer: Dict[str, torch.Tensor] = {
        "ln1": torch.ones((L, d), dtype=dt, device=dev),
        "ln2": torch.ones((L, d), dtype=dt, device=dev),
        "wo": dense((L, H * D, d)),
        "wq": dense((L, d, H * D)),
    }
    if cfg.mla is not None:
        r, pr = cfg.mla.kv_lora_rank, cfg.mla.rope_head_dim
        layer.update(w_dkv=dense((L, d, r)), w_kr=dense((L, d, pr)),
                     w_uk=dense((L, r, H * (D - pr))),
                     w_uv=dense((L, r, H * D)))
    else:
        layer.update(wk=dense((L, d, Hkv * D)), wv=dense((L, d, Hkv * D)))
    if cfg.moe is not None:
        E, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        layer.update(router=dense((L, d, E), dtype=torch.float32),
                     w1=dense((L, E, d, f)), w2=dense((L, E, f, d)),
                     w3=dense((L, E, d, f)))
        if cfg.moe.n_shared:
            fs = f * cfg.moe.n_shared
            layer.update(sw1=dense((L, d, fs)), sw2=dense((L, fs, d)),
                         sw3=dense((L, d, fs)))
    else:
        layer.update(w1=dense((L, d, cfg.d_ff)), w2=dense((L, cfg.d_ff, d)),
                     w3=dense((L, d, cfg.d_ff)))
    params: Dict[str, Any] = {
        "embed": dense((cfg.vocab, d), scale=1.0),
        "ln_f": torch.ones((d,), dtype=dt, device=dev),
        "layers": layer,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense((d, cfg.vocab))
    return params


def params_from_reference(np_params: Dict[str, Any], cfg: TransformerConfig,
                          device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter pytree (numpy arrays, e.g. from
    ``jax.device_get``) as the port's parameters, leaf for leaf
    (``tree.params_from_reference``)."""
    return tree.params_from_reference(np_params, device)


def opt_state_from_reference(np_state: Any, like: Dict[str, Any]
                             ) -> AdamWState:
    """The reference's ``AdamWState`` (numpy leaves, e.g. from
    ``jax.device_get``) as the port's: the int32 step and the float32
    moments on the devices of ``like``'s parameters."""
    dev = like["embed"].device

    def conv(a, ref):
        if isinstance(a, dict):
            return {k: conv(v, ref[k]) for k, v in a.items()}
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(ref.device)

    step = torch.tensor(int(np.asarray(np_state.step)), dtype=torch.int32,
                        device=dev)
    return AdamWState(step=step, mu=conv(np_state.mu, like),
                      nu=conv(np_state.nu, like))


# ---------------------------------------------------------------------------
# forward / loss / decode
# ---------------------------------------------------------------------------

def _layers(params: Dict[str, Any]) -> List[Dict[str, torch.Tensor]]:
    """Each layer's parameters: every stacked leaf unbound once."""
    cut = {k: torch.unbind(v) for k, v in params["layers"].items()}
    return [dict(zip(cut, layer)) for layer in zip(*cut.values())]


def trunk(params: Dict[str, Any], tokens: torch.Tensor,
          cfg: TransformerConfig, train: bool = False) -> torch.Tensor:
    """tokens (B, S) -> the last layer's output (B, S, d_model).

    ``train`` attends through ``online_attention``'s scan (differentiable)
    instead of the flash kernel, and with ``cfg.remat`` recomputes each
    layer in the backward pass.
    """
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device).expand(B, S)
    rope = rope_angles(positions, _rope_dim(cfg), cfg.rope_theta)
    biases = None
    if train:
        every = torch.full((B,), S, dtype=torch.int32, device=x.device)
        biases = _chunk_biases(positions, every, S, True, cfg.attn_chunk)
    for lp in _layers(params):
        if train and cfg.remat:
            x, _ = checkpoint(_layer, x, lp, cfg, rope, biases=biases,
                              train=True, use_reentrant=False)
        else:
            x, _ = _layer(x, lp, cfg, rope, biases=biases, train=train)
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


def loss_fn(params: Dict[str, Any], tokens: torch.Tensor,
            labels: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Mean of ``logsumexp(logits) - logits[label]`` over float32 logits,
    on the training route (``trunk(train=True)``); differentiable."""
    logits = head(params, trunk(params, tokens, cfg, train=True),
                  cfg).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked cache of zeros, leading dim n_layers: (k, v), each (L, batch,
    max_len, Hkv, D); with MLA the latent (L, batch, max_len, r) and the
    rope key (L, batch, max_len, 1, pr)."""
    dt = dtype or cfg.dtype
    dev = resolve_device(device)
    L = cfg.n_layers
    if cfg.mla is not None:
        r, pr = cfg.mla.kv_lora_rank, cfg.mla.rope_head_dim
        return (torch.zeros((L, batch, max_len, r), dtype=dt, device=dev),
                torch.zeros((L, batch, max_len, 1, pr), dtype=dt,
                            device=dev))
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def decode_step(params: Dict[str, Any], tokens: torch.Tensor, cache: Any,
                cache_len: Union[int, torch.Tensor], cfg: TransformerConfig):
    """One decode step: tokens (B, S_new) appended at cache_len.

    Returns (logits (B, S_new, vocab), cache, new_len).  The cache is
    updated in place and returned (the reference returns a new one);
    ``cache_len`` is a host integer, so a step needs no device sync.
    """
    B, S = tokens.shape
    off = int(cache_len)
    x = params["embed"][tokens.long()]
    c_a, c_b = cache                           # slots on axis 2 of each
    Sc = c_a.shape[2]
    if off + S > Sc:
        raise ValueError(f"KV cache of {Sc} slots cannot take {S} tokens "
                         f"at {off}")
    positions = off + torch.arange(S, device=x.device).expand(B, S)
    # rope and the chunk masks depend on positions only: once per step
    rope = rope_angles(positions, _rope_dim(cfg), cfg.rope_theta)
    valid = torch.full((B,), off + S, dtype=torch.int32, device=x.device)
    biases = _chunk_biases(positions, valid, Sc, True, cfg.attn_chunk)
    for i, lp in enumerate(_layers(params)):
        x, _ = _layer(x, lp, cfg, rope, cache=(c_a[i], c_b[i]),
                      cache_len=off, biases=biases)
    return head(params, x, cfg), cache, off + S
