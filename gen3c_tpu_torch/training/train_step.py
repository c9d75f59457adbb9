"""One training step: EDM loss, grads, clip, AdamW, EMA, on one device or
over data- and context-parallel ranks.

Port of gen3c_tpu/training/train_step.py (``make_optimizer``,
``TrainState``, ``init_train_state``, ``train_step``,
``make_sharded_train_step``): the optax chain clip_by_global_norm ->
adamw(linear warmup) [-> MultiSteps] written out over a dict of
parameters, and the state updated in place (the JAX step is pure and
donates its state; here the parameters, moments and EMA are overwritten,
which keeps one copy of each on the card). The net is a GeneralDIT, an
ActionDiT (the batch's "action" goes into its forward) or a
MultiviewGeneralDIT (fps 24, the condition indicator repeated per view),
as ``_net`` picks in gen3c_tpu (:76-93).

Over a (dp, cp) mesh (``parallel.mesh.make_groups``; one process a rank,
each holding the whole state) the step is the one-device step of the
global batch: every rank draws the global draws from the same generator
and takes its slice of them and of the batch (B on dp; latent T of x0,
extra_channels and loss_mask on cp; an image batch is not split on cp, its
cp ranks repeat it), the DiT runs Ulysses self-attention across the cp
ranks, each rank's loss is its share of the global loss, and the loss and
gradients are summed over every rank before the clip, so that AdamW and
the EMA take the same step on every rank. Tensor and sequence parallelism
(ROADMAP item 15b) and FSDP (15c) are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from gen3c_tpu_torch.diffusion.scheduler import EDMEulerSchedule
from gen3c_tpu_torch.models.dit import DiTConfig
from gen3c_tpu_torch.models.dit_multiview import MultiviewDiTConfig
from gen3c_tpu_torch.parallel import collectives
from gen3c_tpu_torch.parallel.mesh import ITEM_15B, ITEM_15C, Groups
from gen3c_tpu_torch.training.ema import ema_update, power_ema_beta
from gen3c_tpu_torch.training.losses import (
    LogvarHead,
    condition_dropout,
    draw_condition_dropout,
    edm_loss,
    sample_condition_indicator,
    sample_sigma,
)
from gen3c_tpu_torch.utils import log

Tensors = Dict[str, torch.Tensor]


class NetWithLogvar(nn.Module):
    """The {"net", "logvar"} parameter tree that gen3c_tpu trains with
    ``loss_add_logvar``: the DiT and the Kendall logvar head."""

    def __init__(self, net: nn.Module, logvar: LogvarHead):
        super().__init__()
        self.net = net
        self.logvar = logvar


@dataclasses.dataclass
class OptState:
    """AdamW state: the update count (also the schedule's), the moments in
    the parameters' dtype, and MultiSteps' accumulation (k > 1 only)."""

    count: int
    mu: Tensors
    nu: Tensors
    mini_step: int = 0
    acc_grads: Optional[Tensors] = None


class Optimizer:
    """make_optimizer's chain: clip_by_global_norm(grad_clip), then AdamW
    (b1, b2, eps 1e-8, decoupled weight decay times the scheduled lr) with
    lr linear from 0 to ``lr`` over ``warmup_steps`` updates
    (optax.linear_schedule(0.0, lr, warmup_steps)); grad_accum_steps > 1
    averages that many gradients before each update (optax.MultiSteps).

    Like optax, the first update (count 0) has lr 0, and warmup_steps <= 0
    holds the lr at its initial value 0 for ever: optax's linear schedule
    is constant at init_value when it has no transition steps.
    """

    EPS = 1e-8  # optax.adamw's default

    def __init__(self, lr: float = 1e-4, weight_decay: float = 0.1,
                 betas: Tuple[float, float] = (0.9, 0.99), grad_clip: float = 1.0,
                 warmup_steps: int = 1000, grad_accum_steps: int = 1):
        self.lr, self.weight_decay, self.betas = lr, weight_decay, betas
        self.grad_clip, self.warmup_steps = grad_clip, warmup_steps
        self.grad_accum_steps = grad_accum_steps
        if warmup_steps <= 0:
            log.warning(f"warmup_steps={warmup_steps}: the learning rate stays 0 for every "
                        "step, as optax.linear_schedule(0.0, lr, 0) gives")

    def schedule(self, count: int) -> torch.Tensor:
        """The lr of update ``count`` (0-based), fp32."""
        if self.warmup_steps <= 0:
            return torch.tensor(0.0)
        c = min(max(count, 0), self.warmup_steps)
        frac = 1.0 - torch.tensor(c, dtype=torch.float32) / self.warmup_steps
        return (0.0 - self.lr) * frac + self.lr

    def init(self, params: Tensors) -> OptState:
        zeros = {n: torch.zeros_like(p) for n, p in params.items()}
        acc = ({n: torch.zeros_like(p) for n, p in params.items()}
               if self.grad_accum_steps > 1 else None)
        return OptState(count=0, mu=zeros, nu={n: torch.zeros_like(p) for n, p in params.items()},
                        acc_grads=acc)

    @torch.no_grad()
    def update(self, grads: Tensors, state: OptState, params: Tensors) -> None:
        """Apply one step to ``params`` and ``state`` in place."""
        k = self.grad_accum_steps
        if k > 1:
            for n, g in grads.items():  # running mean over the window
                acc = state.acc_grads[n]
                acc.add_((g.to(acc.dtype) - acc) / (state.mini_step + 1))
            emit = state.mini_step == k - 1
            state.mini_step = (state.mini_step + 1) % k
            if not emit:
                return
            grads = state.acc_grads
        self._adamw(grads, state, params)
        if k > 1:
            for acc in state.acc_grads.values():
                acc.zero_()

    def _adamw(self, grads: Tensors, state: OptState, params: Tensors) -> None:
        b1, b2 = self.betas
        g_norm = global_norm(grads)
        clip = bool(g_norm >= self.grad_clip)
        count = state.count + 1
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
        step_size = -self.schedule(state.count)
        for n, p in params.items():
            g = grads[n].float()
            if clip:
                g = (g / g_norm) * self.grad_clip
            mu = (1.0 - b1) * g + b1 * state.mu[n].float()
            nu = (1.0 - b2) * (g * g) + b2 * state.nu[n].float()
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS) + self.weight_decay * p.float()
            p.copy_(p.float() + step_size * upd)
            state.mu[n].copy_(mu)
            state.nu[n].copy_(nu)
        state.count = count


class AdamW(Optimizer):
    """optax.adamw(lr) (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 times
    the lr): a constant learning rate and no gradient clipping, the
    tokenizer and AR trainers' optimizer. Updates the parameters and state
    in place, the moments in the parameters' dtype."""

    def __init__(self, lr: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                 weight_decay: float = 1e-4):
        super().__init__(lr, weight_decay, (b1, b2), grad_clip=math.inf, warmup_steps=1)

    def schedule(self, count: int) -> torch.Tensor:
        return torch.tensor(self.lr, dtype=torch.float32)


def trainable_params(module: nn.Module) -> Dict[str, nn.Parameter]:
    """A module's parameters by name with gradients on (the port's modules
    keep them off for inference): the tokenizer and AR trainers' params."""
    return {n: p.requires_grad_(True) for n, p in module.named_parameters()}


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.1,
                   betas: Tuple[float, float] = (0.9, 0.99), grad_clip: float = 1.0,
                   warmup_steps: int = 1000, grad_accum_steps: int = 1) -> Optimizer:
    """AdamW + grad clip + linear warmup (see ``Optimizer``)."""
    return Optimizer(lr, weight_decay, betas, grad_clip, warmup_steps, grad_accum_steps)


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors.values()))


@dataclasses.dataclass
class TrainState:
    """params: the trained module (its parameters are the state's params);
    opt_state: AdamW's; ema_params: fp32 copies by parameter name; step:
    optimizer steps taken."""

    params: nn.Module
    opt_state: OptState
    ema_params: Tensors
    step: int

    def named_params(self) -> Dict[str, nn.Parameter]:
        return dict(self.params.named_parameters())

    def state_dict(self) -> Dict[str, Any]:
        """Every tensor of the state by name (for the checkpointer)."""
        o = self.opt_state
        return {"params": {n: p.detach() for n, p in self.params.named_parameters()},
                "mu": o.mu, "nu": o.nu, "acc_grads": o.acc_grads, "ema": self.ema_params,
                "count": o.count, "mini_step": o.mini_step, "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Copy a ``state_dict`` into this state's tensors, in place."""
        o = self.opt_state
        for dst, src in ((self.named_params(), sd["params"]), (o.mu, sd["mu"]),
                         (o.nu, sd["nu"]), (self.ema_params, sd["ema"]),
                         (o.acc_grads or {}, sd["acc_grads"] or {})):
            if set(dst) != set(src):
                raise KeyError(f"checkpoint keys differ: {sorted(set(dst) ^ set(src))[:8]}")
            for n, t in dst.items():
                t.copy_(src[n])
        o.count, o.mini_step = sd["count"], sd["mini_step"]
        self.step = int(sd["step"])


def init_train_state(params: nn.Module, optimizer: Optimizer) -> TrainState:
    """Turn the module's grads on; fp32 EMA copies; zero moments."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    return TrainState(params=params, opt_state=optimizer.init(named),
                      ema_params={n: p.detach().float().clone() for n, p in named.items()},
                      step=0)


@dataclasses.dataclass
class StepDraws:
    """Every random draw of one step (train_step.py:160-198 splits its key
    six ways for these): sigma (B,); noise like x0; the dropout keeps
    (keep_text (B,), keep_vid ()); the video-extend indicator (B, 1, T, 1,
    1), augment sigma (B,) before the multiplier, and augment noise like x0.
    Unused draws are None."""

    sigma: torch.Tensor
    noise: torch.Tensor
    keep_text: Optional[torch.Tensor] = None
    keep_vid: Optional[torch.Tensor] = None
    indicator: Optional[torch.Tensor] = None
    augment_sigma: Optional[torch.Tensor] = None
    augment_noise: Optional[torch.Tensor] = None


def draw_step(generator: torch.Generator, x0_shape, dropout: bool, video_extend: bool,
              text_dropout_rate: float = 0.0, video_cond_dropout_rate: float = 0.0,
              condition_location: str = "first_random_n", first_random_n_min: int = 0,
              first_random_n_max: int = 4, random_condition_rate: float = 0.5,
              n_views: int = 1) -> StepDraws:
    """A step's draws from ``generator`` (a CPU generator: the same draws
    on any device), x0_shape = (B, C, T, H, W); with n_views > 1 T holds
    the views, and the indicator's per-view pattern repeats for each."""
    B = x0_shape[0]
    d = StepDraws(sigma=sample_sigma(generator, B),
                  noise=torch.randn(tuple(x0_shape), generator=generator))
    if dropout:
        d.keep_text, d.keep_vid = draw_condition_dropout(
            generator, B, text_dropout_rate, video_cond_dropout_rate)
    if video_extend:
        d.indicator = sample_condition_indicator(
            generator, B, x0_shape[2] // n_views, location=condition_location,
            n_min=first_random_n_min, n_max=first_random_n_max, random_rate=random_condition_rate,
            n_views=n_views)
        d.augment_sigma = sample_sigma(generator, B)
        d.augment_noise = torch.randn(tuple(x0_shape), generator=generator)
    return d


def train_step(state: TrainState, batch: dict, rng: Optional[torch.Generator],
               cfg: DiTConfig, optimizer: Optimizer, schedule: EDMEulerSchedule = EDMEulerSchedule(),
               **options) -> Tuple[TrainState, dict]:
    """One optimizer step (gen3c_tpu's ``train_step``; see its docstring for
    the batch keys, and ``loss_and_grads`` for the options, ``groups``
    among them). The state is updated in place and returned. metrics: loss,
    grad_norm (before the clip), sigma_mean, as 0-d tensors on the
    parameters' device; under a mesh the global batch's, on every rank."""
    loss, grads, sigma = loss_and_grads(state.params, batch, rng, cfg, schedule, **options)
    params = state.named_params()
    grad_norm = global_norm(grads)
    optimizer.update(grads, state.opt_state, params)
    del grads
    state.step += 1
    ema_update(state.ema_params, params.items(), power_ema_beta(state.step))
    return state, {"loss": loss, "grad_norm": grad_norm, "sigma_mean": sigma.mean()}


def loss_and_grads(
    params: nn.Module,
    batch: dict,
    rng: Optional[torch.Generator],
    cfg: DiTConfig,
    schedule: EDMEulerSchedule = EDMEulerSchedule(),
    remat: bool = False,
    sp_sharding=None,
    loss_add_logvar: bool = False,
    text_dropout_rate: float = 0.0,
    video_cond_dropout_rate: float = 0.0,
    loss_reduce: str = "mean",
    loss_scale: float = 1.0,
    video_extend: bool = False,
    condition_location: str = "first_random_n",
    first_random_n_min: int = 0,
    first_random_n_max: int = 4,
    random_condition_rate: float = 0.5,
    augment_sigma_multiplier: float = 4.0,
    compute_loss_for_condition_region: bool = False,
    data_type: str = "video",
    draws: Optional[StepDraws] = None,
    groups: Optional[Groups] = None,
) -> Tuple[torch.Tensor, Tensors, torch.Tensor]:
    """The EDM loss of ``params`` (the module train_step trains) on one
    batch and its gradient by parameter name: (loss, grads, sigma).

    The options are gen3c_tpu train_step's: dropout, the video-extend
    condition region (sampled unless the batch has
    "condition_video_indicator"), the image leg (data_type="image": x0 may
    be (B, C, H, W), extra_channels may be absent), the logvar head
    (params a NetWithLogvar), remat. Random draws come from ``rng``
    (``draw_step``) unless ``draws`` gives them. A batch's "action" (B, 7)
    or (B, T_act, 7) conditions an ActionDiT; a MultiviewDiTConfig runs the
    multiview forward (remat per block, where gen3c_tpu remats the whole
    net: the same arithmetic).

    groups: this rank's (dp, cp) mesh (``make_sharded_train_step``). The
    batch and the draws are then the global ones, sliced here
    (``shard_step_inputs``); the loss, the gradients and the returned
    sigma are the global batch's, equal on every rank.
    """
    if sp_sharding is not None:
        raise NotImplementedError(f"sequence parallelism is not ported ({ITEM_15B})")
    multiview = isinstance(cfg, MultiviewDiTConfig)
    if multiview and batch.get("action") is not None:
        raise ValueError("action conditioning is for the single-stream DiT only, not multiview")
    if data_type == "image":
        video_extend = False
    dev = next(params.parameters()).device
    batch = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()}
    x0 = batch["x0"]
    if data_type == "image" and x0.ndim == 4:
        x0 = x0[:, :, None]
    B = x0.shape[0]
    dropout = text_dropout_rate > 0.0 or video_cond_dropout_rate > 0.0
    if draws is None:
        draws = draw_step(rng, x0.shape, dropout, video_extend,
                          text_dropout_rate, video_cond_dropout_rate, condition_location,
                          first_random_n_min, first_random_n_max, random_condition_rate,
                          cfg.n_views if multiview else 1)
    global_sigma = draws.sigma.to(dev, torch.float32)
    cp = None
    share = 1.0
    if groups is not None and groups.parallel:
        batch, draws, cp, share = shard_step_inputs(batch, draws, groups, cfg, data_type,
                                                    loss_reduce)
        x0 = batch["x0"]
        if data_type == "image" and x0.ndim == 4:
            x0 = x0[:, :, None]
        B = x0.shape[0]
    sigma = draws.sigma.to(dev, torch.float32)
    noise = draws.noise.to(dev, torch.float32)
    crossattn_emb = batch["crossattn_emb"]
    extra_channels = batch.get("extra_channels")
    if extra_channels is None:
        if data_type != "image":
            raise ValueError("video batches require extra_channels")
        extra_channels = torch.zeros((B, cfg.in_channels - x0.shape[1]) + tuple(x0.shape[2:]),
                                     dtype=x0.dtype, device=dev)
    video_keep = None
    if dropout:
        crossattn_emb, extra_channels, video_keep = condition_dropout(
            draws.keep_text.to(dev), draws.keep_vid.to(dev), crossattn_emb, extra_channels)
    indicator = augment_sigma = augment_noise = None
    if video_extend:
        indicator = batch.get("condition_video_indicator")
        if indicator is None:
            indicator = draws.indicator.to(dev)
        augment_sigma = draws.augment_sigma.to(dev) * augment_sigma_multiplier
        augment_noise = draws.augment_noise.to(dev)
        _, _, T, H, W = extra_channels.shape
        in_mask = indicator.to(extra_channels.dtype).expand(B, 1, T, H, W)
        if video_keep is not None:
            in_mask = in_mask * video_keep
        extra_channels = torch.cat([in_mask, extra_channels[:, 1:]], dim=1)

    net = params.net if loss_add_logvar else params
    kw = {} if multiview else {"action": batch.get("action")}
    if cp is not None:
        kw.update(cp=cp, cp_attn_impl="ulysses")

    def net_fn(x_in, c_noise, ctx):
        return net(x_in, c_noise, ctx, fps=24.0, remat=remat, **kw)

    named = dict(params.named_parameters())
    with torch.enable_grad():
        loss, _ = edm_loss(
            net_fn, x0, sigma, noise, crossattn_emb, extra_channels, schedule,
            logvar=params.logvar if loss_add_logvar else None,
            weights_per_sample=batch.get("weights_per_sample"),
            loss_mask=batch.get("loss_mask"), loss_reduce=loss_reduce, loss_scale=loss_scale,
            condition_video_indicator=indicator, augment_sigma=augment_sigma,
            augment_noise=augment_noise, video_cond_keep=video_keep,
            compute_loss_for_condition_region=compute_loss_for_condition_region)
        if share != 1.0:
            loss = loss * share
        grad_list = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), grad_list)}
    loss = loss.detach()
    if groups is not None and groups.parallel:
        loss = collectives.all_reduce(loss, groups.world)
        all_reduce_grads(grads, groups)
    return loss, grads, global_sigma


def shard_step_inputs(batch: dict, draws: StepDraws, groups: Groups, cfg: DiTConfig,
                      data_type: str, loss_reduce: str = "mean"
                      ) -> Tuple[dict, StepDraws, Optional[Any], float]:
    """This rank's slice of a global batch and of its global draws, as
    gen3c_tpu's ``make_sharded_train_step`` shards them (:315-330): every
    batch tensor on dp along B (x0, crossattn_emb, extra_channels,
    loss_mask, weights_per_sample, action, a given condition indicator);
    a video batch's x0, extra_channels, loss_mask and indicator on cp
    along latent T, with the draws of the same shapes (noise, augment
    noise, the indicator) cut the same way. An image batch (T = 1) is not
    split on cp: its cp ranks repeat it (gen3c_tpu :315-321). The shards
    must be equal (B % dp == 0, T % cp == 0).

    Returns (batch, draws, the cp axis for the DiT or None, share): the
    factor that makes this rank's loss its part of the global loss, so
    that the sum over the ranks is the one-device loss: 1 / (dp cp) of its
    local mean, and for loss_reduce "sum" (whose local loss counts only
    its own elements) cp times more for a split video batch."""
    dp, cp = groups.dp, groups.cp
    video = data_type != "image"
    x0 = batch["x0"]
    B = x0.shape[0]
    if B % dp.size:
        raise ValueError(f"the batch of {B} does not split over dp={dp.size}")
    if isinstance(cfg, MultiviewDiTConfig) and cp.size > 1:
        raise NotImplementedError(f"context parallelism for the multiview net is not ported "
                                  f"(ROADMAP item 15a covers the single-stream nets)")
    split_t = video and cp.size > 1
    if split_t:
        if cfg.attn_temporal_window is not None:
            raise ValueError("attn_temporal_window training requires cp=1 (the banded splash "
                             "kernel cannot partition the token axis; use dp/tp)")
        if cfg.num_heads % cp.size:
            raise ValueError(f"Ulysses needs the heads ({cfg.num_heads}) to divide the cp "
                             f"size ({cp.size})")
        if x0.shape[2] % cp.size:
            raise ValueError(f"latent T = {x0.shape[2]} does not split over cp={cp.size}")
    nb = B // dp.size
    b = slice(dp.rank * nb, (dp.rank + 1) * nb)

    def on_t(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """B on dp, and dim 2 (latent T) on cp for a split video batch."""
        if t is None:
            return None
        t = t[b] if t.shape[0] == B else t
        if split_t and t.ndim >= 3 and t.shape[2] > 1:
            nt = t.shape[2] // cp.size
            t = t[:, :, cp.rank * nt:(cp.rank + 1) * nt]
        return t

    local = {}
    for key, value in batch.items():
        if not torch.is_tensor(value):
            local[key] = value
        elif key in ("x0", "extra_channels", "loss_mask", "condition_video_indicator"):
            local[key] = on_t(value)
        else:
            local[key] = value[b] if value.ndim and value.shape[0] == B else value
    d = StepDraws(sigma=draws.sigma[b], noise=on_t(draws.noise),
                  keep_text=None if draws.keep_text is None else draws.keep_text[b],
                  keep_vid=draws.keep_vid, indicator=on_t(draws.indicator),
                  augment_sigma=None if draws.augment_sigma is None else draws.augment_sigma[b],
                  augment_noise=on_t(draws.augment_noise))
    share = 1.0 / (dp.size * cp.size)
    if loss_reduce == "sum" and split_t:
        share *= cp.size
    return local, d, (cp if split_t else None), share


GRAD_BUCKET_ELEMENTS = 1 << 26  # fp32 elements summed in one all-reduce (256 MiB)


@torch.no_grad()
def all_reduce_grads(grads: Tensors, groups: Groups) -> None:
    """Sum each gradient over every rank of the mesh, in place: the
    gradients in buckets of up to GRAD_BUCKET_ELEMENTS, each flattened to
    fp32, summed in one all-reduce and written back in the gradients'
    dtype (a bf16 gradient rounds once, after the sum)."""
    names = list(grads)
    i = 0
    while i < len(names):
        bucket, n = [], 0
        while i < len(names) and (not bucket or n + grads[names[i]].numel()
                                  <= GRAD_BUCKET_ELEMENTS):
            bucket.append(names[i])
            n += grads[names[i]].numel()
            i += 1
        flat = torch.cat([grads[k].reshape(-1).float() for k in bucket])
        flat = collectives.all_reduce(flat, groups.world)
        for k, part in zip(bucket, flat.split([grads[k].numel() for k in bucket])):
            grads[k].copy_(part.view_as(grads[k]))
        del flat


def make_sharded_train_step(groups: Groups, cfg: DiTConfig, optimizer: Optimizer,
                            remat: bool = False, fsdp_axis: Optional[str] = None,
                            sequence_parallel: bool = False, loss_add_logvar: bool = False,
                            text_dropout_rate: float = 0.0, video_cond_dropout_rate: float = 0.0,
                            loss_reduce: str = "mean", loss_scale: float = 1.0,
                            data_type: str = "video",
                            schedule: EDMEulerSchedule = EDMEulerSchedule(), **loss_kwargs):
    """The train step over this rank's (dp, cp) mesh (gen3c_tpu's
    ``make_sharded_train_step``, :249-345): ``step(state, batch, rng,
    draws=None) -> (state, metrics)`` with the global batch and the same
    generator (or the same injected global draws) on every rank;
    ``train_step`` with ``groups`` (see ``shard_step_inputs``). Self-
    attention under cp runs Ulysses: the all-to-all turns the sequence
    shard into H/cp heads of the whole sequence, K1cp's forward with lse and
    K4 run there. gen3c_tpu's step leaves cp to GSPMD and reads no
    ``cp_attn_impl``, so neither does this one. fsdp_axis (ROADMAP item 15c)
    and sequence_parallel (15b) raise NotImplementedError; a band with cp >
    1 raises as gen3c_tpu's does (:292-297)."""
    if fsdp_axis is not None:
        raise NotImplementedError(f"FSDP is not ported ({ITEM_15C})")
    if sequence_parallel:
        raise NotImplementedError(f"sequence parallelism is not ported ({ITEM_15B})")
    if groups.cfg.size != 1:
        raise ValueError("the train step's mesh has no cfg axis (cfg=1)")
    if cfg.attn_temporal_window is not None and groups.cp.size > 1:
        raise ValueError("attn_temporal_window training requires cp=1 (the banded splash "
                         "kernel cannot partition the token axis; use dp/tp)")

    def step(state: TrainState, batch: dict, rng: Optional[torch.Generator],
             draws: Optional[StepDraws] = None) -> Tuple[TrainState, dict]:
        return train_step(state, batch, rng, cfg, optimizer, schedule, remat=remat,
                          loss_add_logvar=loss_add_logvar, text_dropout_rate=text_dropout_rate,
                          video_cond_dropout_rate=video_cond_dropout_rate,
                          loss_reduce=loss_reduce, loss_scale=loss_scale, data_type=data_type,
                          draws=draws, groups=groups, **loss_kwargs)

    return step
