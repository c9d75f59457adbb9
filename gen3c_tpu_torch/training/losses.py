"""EDM training loss for the video diffusion model (port of
gen3c_tpu/training/losses.py).

Log-normal sigma sampling, the per-sample weight (sigma^2 +
sigma_data^2) / (sigma * sigma_data)^2, the MSE between the preconditioned
denoised prediction and the clean latent; the video-extend condition
region, the Kendall logvar head, loss masks and reductions. Random draws
come from an explicit ``torch.Generator`` (they cannot match ``jax.random``
bit for bit; the tests hand both packages the same draws).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from gen3c_tpu_torch.diffusion.scheduler import EDMEulerSchedule


class LogvarHead(nn.Module):
    """Learned per-sigma uncertainty head (losses.py ``init_logvar_params``):
    FourierFeatures(num_channels, normalize=True) -> Linear(num_channels, 1,
    bias=False). ``freqs`` and ``phases`` are parameters, as they are leaves
    of the JAX param tree (so they train too); ``w`` keeps JAX's (C, 1)."""

    def __init__(self, num_channels: int = 128, device=None):
        super().__init__()
        self.freqs = nn.Parameter(torch.empty(num_channels, device=device))
        self.phases = nn.Parameter(torch.empty(num_channels, device=device))
        self.w = nn.Parameter(torch.empty(num_channels, 1, device=device))

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "LogvarHead":
        """freqs ~ 2 pi N(0, 1), phases ~ 2 pi U(0, 1), w ~ U(+-1/sqrt(C))."""
        c = self.freqs.shape[0]
        dev = self.freqs.device
        self.freqs.copy_(2.0 * math.pi * torch.randn(c, generator=generator, device=dev))
        self.phases.copy_(2.0 * math.pi * torch.rand(c, generator=generator, device=dev))
        bound = 1.0 / math.sqrt(c)
        self.w.uniform_(-bound, bound, generator=generator)
        return self

    def forward(self, sigma: torch.Tensor) -> torch.Tensor:
        """(B,) log-variance at each sample's sigma (``logvar_fn``)."""
        c_noise = 0.25 * torch.log(sigma)
        feats = torch.cos(c_noise[:, None] * self.freqs[None, :] + self.phases[None, :]) \
            * math.sqrt(2.0)
        return (feats @ self.w)[:, 0]


def condition_dropout(
    keep_text: torch.Tensor,  # (B,) 0/1
    keep_vid: torch.Tensor,  # () 0/1
    crossattn_emb: torch.Tensor,  # (B, M, D)
    extra_channels: torch.Tensor,  # (B, C_extra, T, H, W)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-time CFG condition dropout (losses.py ``condition_dropout``)
    given its draws: text zeroed per sample, the whole condition block per
    batch. Returns (crossattn_emb, extra_channels, video_keep)."""
    keep_text = keep_text.to(crossattn_emb.dtype)
    keep_vid = keep_vid.to(extra_channels.dtype)
    return crossattn_emb * keep_text[:, None, None], extra_channels * keep_vid, keep_vid


def draw_condition_dropout(generator: torch.Generator, batch: int, text_rate: float,
                           video_cond_rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep_text (B,), keep_vid ()) as fp32 0/1: Bernoulli(1 - rate) per
    sample and one per batch."""
    keep_text = (torch.rand(batch, generator=generator) < 1.0 - text_rate).float()
    keep_vid = (torch.rand((), generator=generator) < 1.0 - video_cond_rate).float()
    return keep_text, keep_vid


def sample_condition_indicator(
    generator: torch.Generator,
    batch: int,
    latent_t: int,
    location: str = "first_random_n",
    n_min: int = 0,
    n_max: int = 4,
    random_rate: float = 0.5,
    n_views: int = 1,
) -> torch.Tensor:
    """(B, 1, n_views*T, 1, 1) condition-region indicator, fp32: the first n
    latent frames with n ~ U{n_min..n_max} per sample ("first_random_n"),
    i.i.d. Bernoulli(random_rate) frames ("random"), or the first and last
    n_max frames ("first_and_last_1"); repeated per view."""
    t = torch.arange(latent_t)[None, :]
    if location == "first_random_n":
        n = torch.randint(n_min, n_max + 1, (batch,), generator=generator)
        ind = (t < n[:, None]).float()
    elif location == "random":
        ind = (torch.rand((batch, latent_t), generator=generator) < random_rate).float()
    elif location == "first_and_last_1":
        ind = ((t < n_max) | (t >= latent_t - n_max)).float().expand(batch, latent_t)
    else:
        raise ValueError(f"Unknown condition_location {location}")
    if n_views > 1:
        ind = ind.repeat(1, n_views)
    return ind[:, None, :, None, None].contiguous()


def sample_sigma(generator: torch.Generator, batch: int, p_mean: float = 0.0,
                 p_std: float = 1.0) -> torch.Tensor:
    """EDM log-normal sigma: exp(p_mean + p_std * N(0, 1)), (B,) fp32."""
    return torch.exp(p_mean + p_std * torch.randn(batch, generator=generator))


def edm_loss(
    net_fn: Callable[..., torch.Tensor],
    x0: torch.Tensor,  # (B, C, T, H, W) clean latent
    sigma: torch.Tensor,  # (B,)
    noise: torch.Tensor,  # like x0
    crossattn_emb: torch.Tensor,
    extra_channels: torch.Tensor,  # (B, C_extra, T, H, W)
    schedule: EDMEulerSchedule = EDMEulerSchedule(),
    logvar: Optional[LogvarHead] = None,
    weights_per_sample: Optional[torch.Tensor] = None,
    loss_mask: Optional[torch.Tensor] = None,
    loss_reduce: str = "mean",
    loss_scale: float = 1.0,
    condition_video_indicator: Optional[torch.Tensor] = None,  # (B,1,T,1,1)
    augment_sigma: Optional[torch.Tensor] = None,
    augment_noise: Optional[torch.Tensor] = None,
    video_cond_keep: Optional[torch.Tensor] = None,
    compute_loss_for_condition_region: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scalar loss, per-sample EDM loss); gen3c_tpu's ``edm_loss``.

    net_fn(x_in, c_noise, crossattn_emb) is the denoiser. With ``logvar``
    the scalar is the Kendall loss edm * exp(-logvar) + logvar (the
    per-sample aux stays the raw EDM term). With
    ``condition_video_indicator`` the condition region of xt is replaced by
    the augment-corrupted clean latent, pre-scaled by c_in(aug)/c_in(sigma),
    and (unless compute_loss_for_condition_region) the prediction there by
    the clean latent, so the region adds no loss. "sum" sums each sample's
    elements before the batch mean.
    """
    s = sigma[:, None, None, None, None]
    x0 = x0.float()
    xt = x0 + s * noise
    if condition_video_indicator is not None:
        ind = condition_video_indicator.float()
        if augment_sigma is None:
            augment_sigma = torch.zeros_like(sigma)
        aug_s = augment_sigma[:, None, None, None, None]
        augment_latent = x0
        if augment_noise is not None:
            augment_latent = augment_latent + augment_noise * aug_s
        augment_latent = augment_latent * (schedule.c_in(aug_s) / schedule.c_in(s))
        if video_cond_keep is not None:
            augment_latent = augment_latent * video_cond_keep
        xt = ind * augment_latent + (1.0 - ind) * xt
    c_noise = 0.25 * torch.log(sigma)
    x_in = torch.cat([xt * schedule.c_in(s), extra_channels.to(xt.dtype)], dim=1)
    f = net_fn(x_in, c_noise, crossattn_emb).float()
    denoised = schedule.c_skip(s) * xt + schedule.c_out(s) * f
    if condition_video_indicator is not None and not compute_loss_for_condition_region:
        ind = condition_video_indicator.float()
        denoised = ind * x0 + (1.0 - ind) * denoised
    weight = (s ** 2 + schedule.sigma_data ** 2) / (s * schedule.sigma_data) ** 2
    mse = (denoised - x0) ** 2
    if loss_mask is not None:
        mse = mse * loss_mask.float()
    per_sample = torch.mean(weight * mse, dim=(1, 2, 3, 4))
    if weights_per_sample is not None:
        per_sample = per_sample * weights_per_sample.float()
    if logvar is not None:
        lv = logvar(sigma)
        kendall = per_sample * torch.exp(-lv) + lv
    else:
        kendall = per_sample
    if loss_reduce == "sum":
        return kendall.mean() * float(math.prod(x0.shape[1:])) * loss_scale, per_sample
    if loss_reduce != "mean":
        raise ValueError(f"Invalid loss_reduce: {loss_reduce}")
    return kendall.mean() * loss_scale, per_sample
