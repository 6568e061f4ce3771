"""AdamW, its schedules and gradient utilities (counterpart of
``repro.optim.adamw``).

The reference's arithmetic in its order: float32 moments, float32 bias
corrections ``1 - b ** step``, a clip that scales each gradient in its own
dtype, and the update ``p - lr * (mhat / (sqrt(nhat) + eps) + wd * p)``
computed in float32 and cast back to the parameter's dtype.  Every value
stays on its leaf's device; ``step``, ``lr`` and the norm are 0-d tensors,
so a step makes no host sync.

Unlike the reference, ``apply_updates`` writes the parameters and moments
in place and returns them, ``CHUNK`` values of a leaf at a time: at
minicpm-2b's width a stacked FFN leaf holds 5.3·10^8 values, and the
update's float32 temporaries over a whole leaf would be about 2 GB each.
``global_norm`` likewise squares a chunk at a time.

The PowerSGD trio (``init_compression``, ``compress_grads``,
``decompress_grads``) is the reference's one power iteration per matrix
with error feedback; ``init_compression`` draws its right factors from a
``torch.Generator`` where the reference splits a jax key.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..tree import leaves, leaves_like, tree_map, unflatten

CHUNK = 1 << 24  # values of a leaf updated (or squared) at a time


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"       # "constant" | "cosine" | "wsd"
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1        # WSD: fraction of steps spent decaying
    min_lr_frac: float = 0.1


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), float32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        frac = torch.ones_like(s)
    elif cfg.schedule == "cosine":
        t = torch.clamp((s - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        # warmup -> stable plateau -> short linear decay (MiniCPM)
        decay_steps = int(cfg.total_steps * cfg.decay_frac)
        stable_end = cfg.total_steps - decay_steps
        t = torch.clamp((s - stable_end) / max(decay_steps, 1), 0.0, 1.0)
        frac = 1.0 - (1.0 - cfg.min_lr_frac) * t
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * frac


def init_state(params: Any) -> AdamWState:
    """Zero float32 moments beside each leaf and step 0."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros, nu=tree_map(torch.clone, zeros))


def _chunks(x: torch.Tensor):
    """Flat views of x, CHUNK values each (x must be contiguous)."""
    flat = x.view(-1)
    for lo in range(0, flat.numel(), CHUNK):
        yield flat[lo:lo + CHUNK]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of their float32 sums of squares."""
    total = None
    for g in leaves(tree):
        sq = sum(c.float().square().sum() for c in _chunks(g.contiguous()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def apply_updates(params: Any, grads: Any, state: AdamWState,
                  cfg: AdamWConfig, grad_norm: Optional[torch.Tensor] = None
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Writes ``params`` and the moments in place and
    returns (params, the state at step + 1, {"grad_norm", "lr"}).

    ``grad_norm`` is the global norm the clip reads, when ``grads`` is one
    shard of a larger gradient (the sharded step computes it once over
    the whole); by default, ``grads``'s own."""
    flat_g = leaves(grads)
    gnorm = global_norm(flat_g) if grad_norm is None else grad_norm
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 else None
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    with torch.no_grad():
        for p, g, mu, nu in zip(leaves(params), flat_g, leaves(state.mu),
                                leaves(state.nu)):
            if scale is not None:
                s = scale.to(g.dtype)
            for pc, gc, mc, nc in zip(_chunks(p), _chunks(g.contiguous()),
                                      _chunks(mu), _chunks(nu)):
                g32 = (gc if scale is None else gc * s).float()
                mc.mul_(b1).add_((1 - b1) * g32)
                nc.mul_(b2).add_((1 - b2) * torch.square(g32))
                delta = (mc / bc1) / (torch.sqrt(nc / bc2) + cfg.eps)
                if cfg.weight_decay:
                    delta = delta + cfg.weight_decay * pc.float()
                pc.copy_(pc.float() - lr * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), metrics


# ---------------------------------------------------------------------------
# PowerSGD-style low-rank gradient compression with error feedback
# ---------------------------------------------------------------------------

class CompressionState(NamedTuple):
    error: Any   # error-feedback residuals, same structure as params
    q: Any       # per-matrix right factors (warm-started power iteration)


def init_compression(params: Any, rank: int,
                     generator: torch.Generator) -> CompressionState:
    """Zero residuals, and for every leaf of 2 or more dims a (n, rank)
    normal right factor, n its trailing size, drawn from ``generator`` (on
    the generator's device, then moved to the leaf's); None for 1-D."""
    errs: List[torch.Tensor] = []
    qs: List[Optional[torch.Tensor]] = []
    for p in leaves(params):
        errs.append(torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device))
        if p.dim() >= 2:
            n = math.prod(p.shape[1:])
            qs.append(torch.randn((n, rank), generator=generator,
                                  dtype=torch.float32,
                                  device=generator.device).to(p.device))
        else:
            qs.append(None)
    return CompressionState(error=unflatten(params, errs),
                            q=unflatten(params, qs))


def compress_grads(grads: Any, cstate: CompressionState, rank: int):
    """One power-iteration low-rank factorization per matrix gradient.

    Returns (payload to all-reduce, new state).  The payload of a matrix
    of shape (m, n) is (P (m, r), Q (n, r)); 1-D leaves ride along
    uncompressed.  Error feedback keeps what the projection dropped.
    """
    payload, new_e, new_q = [], [], []
    for g, e, q in zip(leaves(grads), leaves_like(cstate.error, grads),
                       leaves_like(cstate.q, grads)):
        g32 = g.float() + e
        if g.dim() >= 2 and q is not None:
            m = g32.reshape(g32.shape[0], -1)
            p, _ = torch.linalg.qr(m @ q)               # (m, r)
            q_new = m.T @ p                             # (n, r)
            approx = (p @ q_new.T).reshape(g.shape)
            payload.append((p, q_new))
            new_e.append(g32 - approx)
            new_q.append(q_new)
        else:
            payload.append(g32)
            new_e.append(torch.zeros_like(g32))
            new_q.append(None)
    return (unflatten(grads, payload),
            CompressionState(error=unflatten(grads, new_e),
                             q=unflatten(grads, new_q)))


def decompress_grads(payload: Any, like: Any) -> Any:
    out = []
    for pay, ref in zip(leaves_like(payload, like), leaves(like)):
        if isinstance(pay, tuple):
            p, q = pay
            out.append((p @ q.T).reshape(ref.shape).to(ref.dtype))
        else:
            out.append(pay.to(ref.dtype))
    return unflatten(like, out)
