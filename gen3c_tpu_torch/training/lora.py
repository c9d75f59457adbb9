"""LoRA fine-tuning of the DiT (port of gen3c_tpu/training/lora.py).

Low-rank adapters over a frozen base: every adapted weight W becomes
W + scale * (A @ B) and only the adapters train. The adapters are a dict
{path: {"a": (in, r), "b": (r, out)}} keyed by gen3c_tpu's parameter paths
(``blocks/3/fa/q/w``) in its (in, out) orientation, so the two packages'
adapters and layer-control plans compare one to one
(``bridge.lora_state_from_jax``); ``peft_control.port_name`` names the
port's (out, in) weight of each path.

The merge is per linear: while ``lora_attached`` holds, each adapted
weight of the net is recomputed from its base and adapters wherever it is
read (``torch.nn.utils.parametrize``). Under per-block remat the merged
weights of a block are therefore formed again in its recompute and none is
kept across blocks. The base's parameters are left bitwise as they were.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn as nn

from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT
from gen3c_tpu_torch.training.losses import edm_loss
from gen3c_tpu_torch.training.peft_control import port_name, vocabulary_paths
from gen3c_tpu_torch.training.train_step import (
    OptState,
    Optimizer,
    StepDraws,
    draw_step,
    global_norm,
)

DEFAULT_TARGETS = r"blocks/\d+/(fa|ca)/(q|k|v|out)/w$"
Adapters = Dict[str, Dict[str, torch.Tensor]]


def init_lora_params(generator: torch.Generator, base: GeneralDIT, rank: int = 16,
                     targets: str = DEFAULT_TARGETS, dtype: torch.dtype = torch.float32,
                     plan: Optional[Dict[str, Tuple[int, float]]] = None) -> Adapters:
    """A ~ N(0, 1) / r and B = 0 (so the net starts unchanged) for every
    weight whose path matches ``targets``, or for the paths of a
    layer-control ``plan`` with its ranks. Drawn from ``generator`` and put
    on the base's device."""
    pattern = re.compile(targets)
    named = dict(base.named_parameters())
    dev = next(base.parameters()).device
    lora: Adapters = {}
    for path in vocabulary_paths(base.cfg.num_blocks):
        if plan is not None:
            if path not in plan:
                continue
            r = plan[path][0]
        elif pattern.search(path):
            r = rank
        else:
            continue
        out_f, in_f = named[port_name(path)].shape
        a = torch.randn((in_f, r), generator=generator, device=generator.device, dtype=dtype) / r
        lora[path] = {"a": a.to(dev), "b": torch.zeros((r, out_f), dtype=dtype, device=dev)}
    if plan is not None and set(lora) != set(plan):
        raise ValueError(f"plan paths not found in the net: {sorted(set(plan) - set(lora))[:5]}")
    if not lora:
        raise ValueError(f"no parameters matched LoRA targets {targets!r}")
    return lora


def plan_scales(plan: Dict[str, Tuple[int, float]]) -> Dict[str, float]:
    """Per-path merge scales of a layer-control plan."""
    return {name: s for name, (_, s) in plan.items()}


def lora_leaves(lora: Adapters) -> Dict[str, torch.Tensor]:
    """The adapters as one flat dict {"<path>/a" | "<path>/b": tensor}: what
    the optimizer and its state take."""
    return {f"{path}/{k}": t for path, ab in lora.items() for k, t in ab.items()}


def merge_weight(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, s: float) -> torch.Tensor:
    """W + s * (A @ B) for a port weight W (out, in): (A @ B) in the
    adapters' dtype, cast to W's dtype and transposed to (out, in), scaled
    by s rounded to W's dtype, then added in W's dtype, each step rounding
    where gen3c_tpu's ``apply_lora`` does."""
    ab = (a @ b).to(w.dtype).t()
    return w + torch.tensor(s, dtype=w.dtype, device=w.device) * ab


def _scale_of(path: str, scale: float, scales: Optional[Dict[str, float]]) -> float:
    return scale if scales is None else scales.get(path, scale)


def apply_lora(base: nn.Module, lora: Adapters, scale: float = 1.0,
               scales: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """The merged weights {port parameter name: W + scale * A @ B} of every
    adapted weight (``scales``: per-path overrides, ``plan_scales``)."""
    named = dict(base.named_parameters())
    return {port_name(p): merge_weight(named[port_name(p)], ab["a"], ab["b"],
                                       _scale_of(p, scale, scales))
            for p, ab in lora.items()}


class _Merged(nn.Module):
    """The parametrization of one adapted weight: base -> merged."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, s: float):
        super().__init__()
        self.adapters = (a, b)  # a tuple: not registered as parameters of the net
        self.s = s

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        with torch.profiler.record_function("lora_merge"):  # a profiler range, else ~free
            return merge_weight(w, *self.adapters, self.s)


@contextlib.contextmanager
def lora_attached(base: nn.Module, lora: Adapters, scale: float = 1.0,
                  scales: Optional[Dict[str, float]] = None) -> Iterator[nn.Module]:
    """Within the block, every adapted linear of ``base`` reads its merged
    weight (formed anew at each read, so gradients reach the adapters);
    on exit the base's own parameters are back in place, untouched."""
    from torch.nn.utils import parametrize

    attached = []
    try:
        for path, ab in lora.items():
            mod_name, attr = port_name(path).rsplit(".", 1)
            mod = base.get_submodule(mod_name)
            if not isinstance(mod, nn.Linear):
                raise TypeError(f"{path}: LoRA adapts plain linears, not {type(mod).__name__}")
            parametrize.register_parametrization(
                mod, attr, _Merged(ab["a"], ab["b"], _scale_of(path, scale, scales)), unsafe=True)
            attached.append((mod, attr))
        yield base
    finally:
        for mod, attr in attached:
            parametrize.remove_parametrizations(mod, attr, leave_parametrized=False)


def lora_train_step(lora: Adapters, opt_state: OptState, base: GeneralDIT, batch: dict,
                    rng: Optional[torch.Generator], cfg: DiTConfig, optimizer: Optimizer,
                    scale: float = 1.0, remat: bool = False,
                    draws: Optional[StepDraws] = None) -> Tuple[Adapters, OptState, dict]:
    """One optimizer step of the adapters on the EDM loss, the base frozen
    (its parameters' requires_grad is turned off and their values are not
    touched). sigma and noise are drawn from ``rng`` (``draw_step``) unless
    ``draws`` gives them; the optimizer (``make_optimizer``, with its state
    from ``optimizer.init(lora_leaves(lora))``) updates the adapters in
    place. ``remat`` recomputes each block in the backward (gen3c_tpu's
    ``lora_train_step`` has no such option; the 7B at 56,320 tokens needs
    it, and it changes no bit). Returns (lora, opt_state, {"loss",
    "grad_norm"}), the grad-norm before the clip."""
    del cfg  # the net carries its config; kept for gen3c_tpu's signature
    dev = next(base.parameters()).device
    base.requires_grad_(False)
    batch = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()}
    x0 = batch["x0"].float()
    if draws is None:
        draws = draw_step(rng, x0.shape, False, False)
    sigma = draws.sigma.to(dev, torch.float32)
    noise = draws.noise.to(dev, torch.float32)
    leaves = lora_leaves(lora)
    for t in leaves.values():
        t.requires_grad_(True)

    def net_fn(x_in, c_noise, ctx):
        return base(x_in, c_noise, ctx, fps=24.0, remat=remat)

    with lora_attached(base, lora, scale), torch.enable_grad():
        loss, _ = edm_loss(net_fn, x0, sigma, noise, batch["crossattn_emb"],
                           batch["extra_channels"])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    grad_norm = global_norm(grads)
    optimizer.update(grads, opt_state, leaves, grad_norm=grad_norm)
    return lora, opt_state, {"loss": loss.detach(), "grad_norm": grad_norm}
