"""Step functions per architecture family (counterpart of
``repro.launch.steps``): the LM, GNN and recsys steps.

Every train step takes its gradient with ``torch.autograd.grad`` over
detached leaves (``value_and_grad``) and applies ``adamw.apply_updates``,
which updates the parameters and moments in place.  The LM steps
differentiate ``transformer.loss_fn`` (the training route:
``online_attention``'s scan, ``remat`` per the config), the GNN step
``gnn_loss`` and the din step ``din.loss_fn``.  ``lm_train_step_sharded``
is the LM step on parameters and moments placed over a named mesh
(``distributed.sharding``), equal to the one-device step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..distributed import sharding as SH
from .mesh import NamedMesh
from ..models import dimenet as DIME
from ..models import din as DIN
from ..models import egnn as EGNN
from ..models import gin as GIN
from ..models import mace as MACE
from ..models import transformer as T
from ..models.gnn_common import GraphBatch
from ..optim import adamw
from ..tree import leaves, unflatten


def value_and_grad(loss_fn: Callable[..., torch.Tensor], params: Any,
                   *args) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(``loss_fn(params, *args)``, the gradient of every leaf of
    ``params`` in ``tree.leaves`` order, each in its leaf's dtype).  The
    leaves are detached views, so ``params`` need not require grad and no
    ``.grad`` is written.  A leaf the loss does not reach (egnn's last
    coordinate head, mace's last vector and tensor updates) gets a zero
    gradient, as ``jax.grad`` gives it."""
    flat = leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in flat]
        loss = loss_fn(unflatten(params, live), *args)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), list(grads)


def lm_train_step(params: Dict[str, Any], opt_state: adamw.AdamWState,
                  batch: Dict[str, torch.Tensor], cfg: T.TransformerConfig,
                  opt_cfg: adamw.AdamWConfig):
    """One AdamW step on ``batch["tokens"]``/``["labels"]`` (B, S).

    Returns (params, opt_state, {"loss", "grad_norm", "lr"}), each metric a
    0-d float32 tensor; ``params`` and the moments are updated in place.
    """
    loss, grads = value_and_grad(T.loss_fn, params, batch["tokens"],
                                 batch["labels"], cfg)
    params, opt_state, metrics = adamw.apply_updates(params, grads,
                                                     opt_state, opt_cfg)
    return params, opt_state, {"loss": loss, **metrics}


def _mean_grads(micro: Iterable[Tuple[Any, torch.Tensor, torch.Tensor]],
                n: int, cfg: T.TransformerConfig,
                device: Optional[torch.device] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The mean over the ``n`` (params, tokens, labels) of ``micro``, in
    order, of ``loss_fn``'s gradient and of its loss: each gradient is
    added into float32 buffers (the reference's scan carry; on
    ``device``, by default beside each leaf), which are then divided by
    ``n``.  Each item's params are let go before the next is drawn."""
    acc: Optional[List[torch.Tensor]] = None
    losses = []
    for params, tokens, labels in micro:
        loss, grads = value_and_grad(T.loss_fn, params, tokens, labels, cfg)
        del params
        if acc is None:
            acc = [torch.zeros(g.shape, dtype=torch.float32,
                               device=g.device if device is None else device)
                   for g in grads]
        for a, g in zip(acc, grads):
            a.add_(g.to(a.device))
        del grads
        losses.append(loss.to(acc[0].device))
    for a in acc:
        a.div_(n)
    return acc, torch.stack(losses).mean()


def lm_train_step_microbatched(params: Dict[str, Any],
                               opt_state: adamw.AdamWState,
                               batch: Dict[str, torch.Tensor],
                               cfg: T.TransformerConfig,
                               opt_cfg: adamw.AdamWConfig, n_micro: int):
    """Gradient accumulation over ``n_micro`` microbatches of B // n_micro
    rows, in order: each microbatch's gradient is added into float32
    buffers (the reference's scan carry), then divided by ``n_micro``.
    The loss is the microbatches' mean."""
    mb = batch["tokens"].shape[0] // n_micro
    grads, loss = _mean_grads(
        ((params, batch["tokens"][i * mb:(i + 1) * mb],
          batch["labels"][i * mb:(i + 1) * mb]) for i in range(n_micro)),
        n_micro, cfg)
    params, opt_state, metrics = adamw.apply_updates(params, grads,
                                                     opt_state, opt_cfg)
    return params, opt_state, {"loss": loss, **metrics}


# ---------------------------------------------------------------------------
# the LM over a named mesh
# ---------------------------------------------------------------------------

def lm_state_shardings(params: Any, cfg: T.TransformerConfig,
                       mesh: NamedMesh) -> Tuple[Any, adamw.AdamWState]:
    """Where a (params, AdamW state) pair lives on ``mesh``: params by
    ``lm_param_rules`` (as the reference's ``train_lm`` places them), each
    moment as its parameter, the step on every slot.  ``params`` needs
    shapes only (tensors, sharded tensors, or ``init_params`` on
    ``meta``); the result is the ``sharding_tree`` that
    ``CheckpointManager.restore`` takes."""
    p_sh = SH.shard_tree(SH.tree_specs(
        params, SH.lm_param_rules(mesh, moe=cfg.moe is not None), mesh),
        mesh)
    return p_sh, adamw.AdamWState(step=SH.NamedSharding(mesh, SH.P()),
                                  mu=p_sh, nu=p_sh)


def init_sharded_state(params: Any) -> adamw.AdamWState:
    """``adamw.init_state`` of parameters placed over a mesh: float32 zero
    moments sharded as their parameters, and step 0 on every slot."""
    mesh = SH.mesh_of(params)
    step = SH.device_put(
        torch.zeros((), dtype=torch.int32, device=mesh.slots[0]),
        SH.NamedSharding(mesh, SH.P()))
    return adamw.AdamWState(step=step,
                            mu=SH.zeros_like(params, torch.float32),
                            nu=SH.zeros_like(params, torch.float32))


def lm_train_step_sharded(params: Any, opt_state: adamw.AdamWState,
                          batch: Dict[str, torch.Tensor],
                          cfg: T.TransformerConfig,
                          opt_cfg: adamw.AdamWConfig, n_micro: int = 1):
    """One AdamW step on parameters and moments placed over a named mesh
    (``distributed.sharding.device_put``, ``init_sharded_state``).

    The batch splits by ``lm_batch_spec``: index ``j`` of the data axes
    takes rows ``j·B/|data|`` on.  For each index in order, the full
    parameters are gathered onto the device of its first slot, the
    gradient of its rows (in ``n_micro`` microbatches) is added into
    float32 buffers on slot 0's device, and the gathered copy is let go:
    ``lm_train_step_microbatched``'s accumulation over |data|·n_micro
    microbatches.  The mean's global norm is taken once, then every slot
    applies AdamW to its own shards with its slice of the gradient, so
    slots that hold copies of one slice stay bit-identical.  On a
    one-slot mesh this is ``lm_train_step`` (``_microbatched`` when
    ``n_micro`` > 1) on the tensors themselves: no gather, no copy.

    Returns (params, opt_state, {"loss", "grad_norm", "lr"}) as
    ``lm_train_step`` does, the metrics on slot 0's device; the shards
    are updated in place.
    """
    mesh = SH.mesh_of(params)
    if mesh.size == 1:
        p, s = SH.local(params, 0), SH.local(opt_state, 0)
        if n_micro > 1:
            _, s, metrics = lm_train_step_microbatched(p, s, batch, cfg,
                                                       opt_cfg, n_micro)
        else:
            _, s, metrics = lm_train_step(p, s, batch, cfg, opt_cfg)
        return params, opt_state._replace(
            step=opt_state.step.with_shards([s.step])), metrics
    rows_of = [mesh.slots[i] for i in SH.first_slots(mesh)]
    B = batch["tokens"].shape[0]
    if B % (len(rows_of) * n_micro):
        raise ValueError(f"a batch of {B} rows does not split over "
                         f"{len(rows_of)} data indices x {n_micro} "
                         f"microbatches")
    rows = B // len(rows_of)
    mb = rows // n_micro

    def micro():
        for j, dev in enumerate(rows_of):
            full = SH.gather(params, dev)
            tok = batch["tokens"][j * rows:(j + 1) * rows].to(dev)
            lab = batch["labels"][j * rows:(j + 1) * rows].to(dev)
            for k in range(n_micro):
                yield full, tok[k * mb:(k + 1) * mb], lab[k * mb:(k + 1) * mb]
            del full

    grads, loss = _mean_grads(micro(), len(rows_of) * n_micro, cfg,
                              mesh.slots[0])
    gnorm = adamw.global_norm(grads)
    flat = leaves(params)
    steps, metrics = [], None
    for i, dev in enumerate(mesh.slots):
        shard_grads = [g[x.index(i)].to(dev) for g, x in zip(grads, flat)]
        _, s, m = adamw.apply_updates(SH.local(params, i), shard_grads,
                                      SH.local(opt_state, i), opt_cfg,
                                      grad_norm=gnorm.to(dev))
        steps.append(s.step)
        if i == 0:
            metrics = m
    return params, opt_state._replace(
        step=opt_state.step.with_shards(steps)), {"loss": loss, **metrics}


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


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

_GNN = {"gin-tu": GIN, "egnn": EGNN, "dimenet": DIME, "mace": MACE}


def _rebatch(batch: Dict[str, torch.Tensor], n_graphs: int) -> GraphBatch:
    return GraphBatch(
        nodes=batch["nodes"], edge_src=batch["edge_src"],
        edge_dst=batch["edge_dst"], node_mask=batch["node_mask"],
        edge_mask=batch["edge_mask"], graph_id=batch["graph_id"],
        n_graphs=n_graphs, pos=batch.get("pos"),
        triplet_kj=batch.get("triplet_kj"),
        triplet_ji=batch.get("triplet_ji"),
        triplet_mask=batch.get("triplet_mask"))


def gnn_loss(params, batch, cfg, arch: str, n_graphs: int,
             node_level: bool) -> torch.Tensor:
    """Node level: the masked NLL of ``batch["labels"]`` over
    ``batch["label_mask"]`` (for egnn, dimenet and mace the per-graph
    outputs with ``n_graphs == n_nodes`` and ``graph_id`` the node index);
    graph level: the MSE to ``batch["energy"]``."""
    gb = _rebatch(batch, n_graphs)
    if arch == "gin-tu":
        if node_level:
            return GIN.loss_fn(params, gb, batch["labels"],
                               dataclasses.replace(cfg, graph_level=False),
                               batch.get("label_mask"))
        # graph-level regression (molecule shape): MSE on pooled readout
        out = GIN.forward(params, gb, cfg).float()
        return torch.mean(torch.square(out - batch["energy"].float()))
    if node_level:
        # equivariant models emit graph outputs; for node tasks we read out
        # per-node class scores from the last invariant features
        if arch == "egnn":
            out, _ = EGNN.forward(params, gb, cfg)
        elif arch == "mace":
            out, _ = MACE.forward(params, gb, cfg)
        else:
            out = DIME.forward(params, gb, cfg)
        logits = out.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1, batch["labels"].long()[:, None])[:, 0]
        nll = logz - gold
        m = batch["label_mask"]
        return torch.sum(nll * m) / torch.clamp(m.sum(), min=1.0)
    return _GNN[arch].loss_fn(params, gb, batch["energy"], cfg)


def gnn_train_step(params, opt_state: adamw.AdamWState,
                   batch: Dict[str, torch.Tensor], cfg, arch: str,
                   n_graphs: int, node_level: bool,
                   opt_cfg: adamw.AdamWConfig):
    """One AdamW step on ``gnn_loss``; returns (params, opt_state,
    {"loss", "grad_norm", "lr"})."""
    loss, grads = value_and_grad(gnn_loss, params, batch, cfg, arch,
                                 n_graphs, node_level)
    params, opt_state, metrics = adamw.apply_updates(params, grads,
                                                     opt_state, opt_cfg)
    return params, opt_state, {"loss": loss, **metrics}


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def din_train_step(params, opt_state: adamw.AdamWState,
                   batch: Dict[str, torch.Tensor], cfg: DIN.DINConfig,
                   opt_cfg: adamw.AdamWConfig):
    """One AdamW step on ``din.loss_fn`` against ``batch["label"]``."""
    loss, grads = value_and_grad(DIN.loss_fn, params, batch, batch["label"],
                                 cfg)
    params, opt_state, metrics = adamw.apply_updates(params, grads,
                                                     opt_state, opt_cfg)
    return params, opt_state, {"loss": loss, **metrics}


def din_serve_step(params, batch: Dict[str, torch.Tensor],
                   cfg: DIN.DINConfig) -> torch.Tensor:
    """CTR probabilities (B,)."""
    return torch.sigmoid(DIN.forward(params, batch, cfg))


def din_retrieval_step(params, batch: Dict[str, torch.Tensor],
                       cfg: DIN.DINConfig) -> torch.Tensor:
    """Scores of one user's history against every candidate (chunked)."""
    return DIN.score_candidates(params, batch, cfg)
