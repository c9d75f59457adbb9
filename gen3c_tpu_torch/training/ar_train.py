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
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gen3c_tpu_torch.models.ar_transformer import ARTransformer, _mm, train_hidden
from gen3c_tpu_torch.training.train_step import (OptState, Optimizer, global_norm,
                                                  trainable_params)

LOSS_CHUNK_TOKENS = 2048  # 0.5 GB of fp32 logits a chunk at vocab 64,000


def _chunk_terms(model: ARTransformer, h: torch.Tensor, targets: torch.Tensor,
                 label_smoothing: float) -> torch.Tensor:
    """(sum of the tokens' NLL (smoothed), sum of their logsumexp^2, count of
    correct argmaxes) over one chunk of hidden states."""
    logits = _mm(h, model.output).float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if label_smoothing > 0:
        nll = (1 - label_smoothing) * nll + label_smoothing * (-logp.mean(dim=-1))
    lse = torch.logsumexp(logits, dim=-1)
    correct = (torch.argmax(logits, dim=-1) == targets).float()
    return torch.stack([nll.sum(), (lse ** 2).sum(), correct.sum()])


def ar_loss(model: ARTransformer, tokens: torch.Tensor, context: Optional[torch.Tensor] = None,
            label_smoothing: float = 0.0, z_loss: float = 1e-4,
            loss_chunk: int = LOSS_CHUNK_TOKENS) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The causal LM loss predicting tokens[:, 1:] from tokens[:, :-1]
    (B, L): the mean NLL (label-smoothed), plus z_loss times the mean
    squared logsumexp; metrics {"loss", "accuracy"}."""
    h = train_hidden(model, tokens[:, :-1], context)
    targets = tokens[:, 1:]
    n = targets.numel()
    terms = 0
    for s in range(0, targets.shape[1], loss_chunk):
        args = (model, h[:, s:s + loss_chunk], targets[:, s:s + loss_chunk], label_smoothing)
        terms = terms + (checkpoint(_chunk_terms, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _chunk_terms(*args))
    loss = terms[0] / n
    if z_loss > 0:
        loss = loss + z_loss * (terms[1] / n)
    return loss, {"loss": loss, "accuracy": terms[2].detach() / n}


def ar_train_step(model: ARTransformer, opt_state: OptState, tokens: torch.Tensor,
                  optimizer: Optimizer, context: Optional[torch.Tensor] = None, **loss_kwargs
                  ) -> Tuple[ARTransformer, OptState, Dict[str, torch.Tensor]]:
    """One optimizer step on ``ar_loss`` over every parameter (updated in
    place with the state): metrics {"loss", "accuracy", "grad_norm"}, the
    norm taken over the gradients before the update (optax.global_norm)."""
    params = trainable_params(model)
    loss, metrics = ar_loss(model, tokens, context, **loss_kwargs)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    grads = {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = global_norm(grads)
    optimizer.update(grads, opt_state, params, grad_norm=metrics["grad_norm"])
    return model, opt_state, metrics
