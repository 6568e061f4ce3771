"""Step functions of the LM family (counterpart of ``repro.launch.steps``'s
``lm_train_step``, ``lm_train_step_microbatched``, ``lm_prefill_step`` and
``lm_decode_step``).

The train steps take the gradient of ``transformer.loss_fn`` (the training
route: ``online_attention``'s scan, ``remat`` per the config) with
``torch.autograd.grad`` and apply ``adamw.apply_updates``, which updates
the parameters and moments in place.  The GNN and recsys steps are not
yet ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..models import transformer as T
from ..optim import adamw
from ..tree import leaves, unflatten


def lm_value_and_grad(params: Dict[str, Any], tokens: torch.Tensor,
                      labels: torch.Tensor, cfg: T.TransformerConfig
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, the gradient of every leaf of ``params`` in ``tree.leaves``
    order, each in its leaf's dtype).  The leaves are detached views, so
    ``params`` need not require grad and no ``.grad`` is written."""
    flat = leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in flat]
        loss = T.loss_fn(unflatten(params, live), tokens, labels, cfg)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), list(grads)


def lm_train_step(params: Dict[str, Any], opt_state: adamw.AdamWState,
                  batch: Dict[str, torch.Tensor], cfg: T.TransformerConfig,
                  opt_cfg: adamw.AdamWConfig):
    """One AdamW step on ``batch["tokens"]``/``["labels"]`` (B, S).

    Returns (params, opt_state, {"loss", "grad_norm", "lr"}), each metric a
    0-d float32 tensor; ``params`` and the moments are updated in place.
    """
    loss, grads = lm_value_and_grad(params, batch["tokens"], batch["labels"],
                                    cfg)
    params, opt_state, metrics = adamw.apply_updates(params, grads,
                                                     opt_state, opt_cfg)
    return params, opt_state, {"loss": loss, **metrics}


def lm_train_step_microbatched(params: Dict[str, Any],
                               opt_state: adamw.AdamWState,
                               batch: Dict[str, torch.Tensor],
                               cfg: T.TransformerConfig,
                               opt_cfg: adamw.AdamWConfig, n_micro: int):
    """Gradient accumulation over ``n_micro`` microbatches of B // n_micro
    rows, in order: each microbatch's gradient is added into float32
    buffers (the reference's scan carry), then divided by ``n_micro``.
    The loss is the microbatches' mean."""
    B = batch["tokens"].shape[0]
    mb = B // n_micro
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves(params)]
    losses = []
    for i in range(n_micro):
        rows = slice(i * mb, (i + 1) * mb)
        loss, grads = lm_value_and_grad(params, batch["tokens"][rows],
                                        batch["labels"][rows], cfg)
        for a, g in zip(acc, grads):
            a.add_(g)
        del grads
        losses.append(loss)
    for a in acc:
        a.div_(n_micro)
    params, opt_state, metrics = adamw.apply_updates(params, acc, opt_state,
                                                     opt_cfg)
    return params, opt_state, {"loss": torch.stack(losses).mean(), **metrics}


def lm_prefill_step(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                    cfg: T.TransformerConfig) -> torch.Tensor:
    """Inference prefill: forward over the full prompt, loss-free.

    Returns ``argmax(logits[:, -1])``, as the reference does, but unembeds
    only the last position: the norm and the unembedding act on each
    position alone, so the result is the same, and at S = 32,768 the full
    logits (8 GB in bf16 at minicpm-2b's vocab) are never made.
    """
    x = T.trunk(params, batch["tokens"], cfg)
    logits = T.head(params, x[:, -1], cfg)
    return torch.argmax(logits, dim=-1)


def lm_decode_step(params: Dict[str, Any], tokens: torch.Tensor, cache: Any,
                   cache_len: int, cfg: T.TransformerConfig):
    """One token for every sequence in the batch against a full KV cache.

    Returns (next tokens (B,), cache, new_len); the cache is updated in
    place (``transformer.decode_step``).
    """
    logits, cache, new_len = T.decode_step(params, tokens, cache, cache_len,
                                           cfg)
    return torch.argmax(logits[:, -1], dim=-1), cache, new_len
