"""Autoregressive world-model training: next-token cross-entropy.

Port of gen3c_tpu/training/ar_train.py (the reference:
cosmos_predict1/autoregressive/training/): teacher-forced next-token
prediction over the video tokens, with the optional label smoothing and
z-loss. The forward is ``models.ar_transformer.train_hidden``: the cache-free
``ar_forward`` with gradients, each layer recomputed in the backward, its
self-attention K8 with K8bwd as the backward.

The logits are formed ``loss_chunk`` tokens at a time, each chunk's loss
terms recomputed in the backward: at the 4B's 12,800 tokens the fp32 logits
over 64,000 tokens are 3.3 GB, and their log-softmax and its gradient
several times that. The loss is each term's sum over the chunks divided by
the token count, the mean gen3c_tpu takes (sums in another order).

Over a (dp, tp) mesh (gen3c_tpu's one jitted step on parameters placed by
``shard_ar_params(mesh, params, "tp", fsdp_axis)``): ``make_sharded_ar_train_
step`` slices the batch over dp, runs the model ``parallel.sharding.
shard_ar_params`` cut (and ``shard_fsdp`` cut further over dp), and takes
Megatron's vocab-parallel cross entropy on the column-parallel LM head: each
tp rank forms the logits of its V/tp of the vocabulary only; the max (no
gradient), the sum of exps, the target's logit (from the rank that owns it)
and, for label smoothing, the sum of the logits are summed over tp
(``collectives.reduce_from_tp``: the loss is the same on every tp rank, and
each rank's backward reaches its own logits once). The accuracy's argmax
keeps the lowest index on a tie across ranks, as ``jnp.argmax`` does. No
rank gathers the fp32 logits.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gen3c_tpu_torch.models.ar_transformer import ARTransformer, _mm, train_hidden
from gen3c_tpu_torch.parallel import collectives, sharding
from gen3c_tpu_torch.parallel.mesh import Axis, Groups
from gen3c_tpu_torch.training.train_step import (OptState, Optimizer, all_reduce_grads,
                                                  global_norm, sharded_global_norm,
                                                  trainable_params)

LOSS_CHUNK_TOKENS = 2048  # 0.5 GB of fp32 logits a chunk at vocab 64,000


def _chunk_terms(model: ARTransformer, h: torch.Tensor, targets: torch.Tensor,
                 label_smoothing: float) -> torch.Tensor:
    """(sum of the tokens' NLL (smoothed), sum of their logsumexp^2, count of
    correct argmaxes) over one chunk of hidden states."""
    if model.tp is not None:
        return _vocab_parallel_terms(model, h, targets, label_smoothing, model.tp)
    logits = _mm(h, model.output).float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if label_smoothing > 0:
        nll = (1 - label_smoothing) * nll + label_smoothing * (-logp.mean(dim=-1))
    lse = torch.logsumexp(logits, dim=-1)
    correct = (torch.argmax(logits, dim=-1) == targets).float()
    return torch.stack([nll.sum(), (lse ** 2).sum(), correct.sum()])


def _vocab_parallel_terms(model: ARTransformer, h: torch.Tensor, targets: torch.Tensor,
                          label_smoothing: float, tp: Axis) -> torch.Tensor:
    """``_chunk_terms`` on this rank's V/tp columns of the logits
    (Megatron's vocab-parallel cross entropy); the same terms on every tp
    rank."""
    h = collectives.copy_to_tp(h, tp)  # each rank's head takes a part of dL/dh
    logits = _mm(h, model.output).float()
    n = logits.shape[-1]
    lo = tp.rank * n
    local_max = logits.detach().max(dim=-1).values
    gmax = collectives.all_reduce(local_max, tp, op="max")
    lse = torch.log(collectives.reduce_from_tp(
        torch.exp(logits - gmax[..., None]).sum(dim=-1), tp)) + gmax
    local = targets - lo
    inside = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    target_logit = collectives.reduce_from_tp(
        torch.where(inside, picked, torch.zeros_like(picked)), tp)
    nll = lse - target_logit
    if label_smoothing > 0:
        mean_logit = collectives.reduce_from_tp(logits.sum(dim=-1), tp) / model.cfg.vocab_size
        nll = (1 - label_smoothing) * nll + label_smoothing * (lse - mean_logit)
    correct = (vocab_parallel_argmax(logits.detach(), local_max, gmax, lo, tp)
               == targets).float()
    return torch.stack([nll.sum(), (lse ** 2).sum(), correct.sum()])


def vocab_parallel_argmax(logits: torch.Tensor, local_max: torch.Tensor, gmax: torch.Tensor,
                          lo: int, tp: Axis) -> torch.Tensor:
    """The argmax over the whole vocabulary of logits whose columns [lo, lo
    + V/tp) this rank holds, given each row's local and global max: the
    lowest index among the ranks holding the global max (``jnp.argmax``'s
    first occurrence), the same on every rank."""
    first = torch.argmax(logits, dim=-1) + lo  # the first local max
    none = torch.full_like(first, -(1 << 62))
    best = collectives.all_reduce(torch.where(local_max == gmax, -first, none), tp, op="max")
    return -best


def ar_loss(model: ARTransformer, tokens: torch.Tensor, context: Optional[torch.Tensor] = None,
            label_smoothing: float = 0.0, z_loss: float = 1e-4,
            loss_chunk: int = LOSS_CHUNK_TOKENS, num_targets: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The causal LM loss predicting tokens[:, 1:] from tokens[:, :-1]
    (B, L): the mean NLL (label-smoothed), plus z_loss times the mean
    squared logsumexp; metrics {"loss", "accuracy"}. num_targets: the count
    the sums are divided by (default this batch's B (L - 1); a dp rank's
    slice passes the global batch's, so that its loss is its share)."""
    h = train_hidden(model, tokens[:, :-1], context)
    targets = tokens[:, 1:]
    n = targets.numel() if num_targets is None else num_targets
    terms = 0
    for s in range(0, targets.shape[1], loss_chunk):
        args = (model, h[:, s:s + loss_chunk], targets[:, s:s + loss_chunk], label_smoothing)
        terms = terms + (checkpoint(_chunk_terms, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _chunk_terms(*args))
    loss = terms[0] / n
    if z_loss > 0:
        loss = loss + z_loss * (terms[1] / n)
    return loss, {"loss": loss, "accuracy": terms[2].detach() / n}


def _step(model: ARTransformer, opt_state: OptState, params: Dict[str, torch.Tensor],
          loss: torch.Tensor, metrics: dict, optimizer: Optimizer,
          reduce_grads: Callable, norm: Callable):
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    grads = {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)}
    reduce_grads(grads)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = norm(grads)
    optimizer.update(grads, opt_state, params, grad_norm=metrics["grad_norm"])
    return model, opt_state, metrics


def ar_train_step(model: ARTransformer, opt_state: OptState, tokens: torch.Tensor,
                  optimizer: Optimizer, context: Optional[torch.Tensor] = None, **loss_kwargs
                  ) -> Tuple[ARTransformer, OptState, Dict[str, torch.Tensor]]:
    """One optimizer step on ``ar_loss`` over every parameter (updated in
    place with the state): metrics {"loss", "accuracy", "grad_norm"}, the
    norm taken over the gradients before the update (optax.global_norm)."""
    params = trainable_params(model)
    loss, metrics = ar_loss(model, tokens, context, **loss_kwargs)
    return _step(model, opt_state, params, loss, metrics, optimizer, lambda g: None,
                 global_norm)


def make_sharded_ar_train_step(groups: Groups, optimizer: Optimizer, fsdp: bool = False):
    """``ar_train_step`` over this rank's (dp, tp) mesh (gen3c_tpu's jitted
    ``ar_train_step`` on ``shard_ar_params(make_mesh(dp, tp), params,
    fsdp_axis="dp" if fsdp else None)``): ``step(model, opt_state, tokens,
    context=None, **loss_kwargs) -> (model, opt_state, metrics)`` with the
    global batch on every rank. The model must be cut to this rank's tp
    shards first (``parallel.sharding.shard_ar_params``) and, with fsdp,
    over dp too (``shard_fsdp``), so that AdamW's moments live per shard
    (``opt_state`` from ``optimizer.init(sharding.named_leaves(model))``).

    Each dp rank takes its B/dp rows of the batch and its share of the
    global mean; the gradients are summed over the ranks that computed a
    part of them (``train_step.all_reduce_grads``: a tp shard's over dp, q's
    and k's norm scales over every rank, an FSDP shard's comes
    reduce-scattered over dp) and the clip's norm is the whole gradient's
    (``sharded_global_norm``). The metrics are the global batch's, the same
    on every rank."""
    leaves = {}

    def step(model: ARTransformer, opt_state: OptState, tokens: torch.Tensor,
             context: Optional[torch.Tensor] = None, **loss_kwargs):
        if leaves.get("model") is not model:
            if (model.tp.size if model.tp is not None else 1) != groups.tp.size:
                raise ValueError(f"the model is cut for tp={model.tp_size}, the mesh has "
                                 f"tp={groups.tp.size}: shard_ar_params(model, groups) first")
            cut = set(sharding.fsdp_leaves(model))
            if fsdp and groups.dp.size > 1 and not cut:
                raise ValueError("fsdp needs the model cut over dp first "
                                 "(parallel.sharding.shard_fsdp)")
            sharded = set(sharding.ar_sharded_leaves(model))
            leaves.update(model=model, tp_parts=sharding.ar_head_norm_leaves(model), fsdp=cut,
                          norm=(lambda g: sharded_global_norm(g, sharded, groups.tp, cut,
                                                              groups.dp))
                          if sharded or cut else global_norm)
        dp = groups.dp
        B = tokens.shape[0]
        if B % dp.size:
            raise ValueError(f"the batch of {B} does not split over dp={dp.size}")
        rows = slice(dp.rank * (B // dp.size), (dp.rank + 1) * (B // dp.size))
        params = {n: p.requires_grad_(True) for n, p in sharding.named_leaves(model).items()}
        loss, metrics = ar_loss(model, tokens[rows], None if context is None else context[rows],
                                num_targets=B * (tokens.shape[1] - 1), **loss_kwargs)
        if dp.size > 1:  # the global batch's loss and accuracy, on every rank
            metrics = {k: collectives.all_reduce(v.detach(), dp) for k, v in metrics.items()}
        def reduce_grads(grads):
            if groups.world.size > 1:
                all_reduce_grads(grads, groups, leaves["tp_parts"], leaves["fsdp"])

        return _step(model, opt_state, params, loss, metrics, optimizer, reduce_grads,
                     leaves["norm"])

    return step
