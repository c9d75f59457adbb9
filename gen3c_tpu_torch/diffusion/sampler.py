"""EDM-Euler video sampling with conditioned-region replacement and CFG.

Port of the exact path of gen3c_tpu/diffusion/sampler.py
``generate_samples`` (the ``body`` loop, :256-348, :600-603): each step
re-noises the condition region, runs ONE batched [cond | uncond] DiT
forward of size 2B, combines with CFG, replaces the condition region in
the output and takes an Euler step. The loop is a plain Python loop.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from gen3c_tpu_torch.diffusion.scheduler import EDMEulerSchedule


def arch_invariant_randn(shape, seed: Optional[int] = None) -> np.ndarray:
    """Architecture-invariant normal noise: numpy RandomState, so the port
    and the JAX package draw the same numbers."""
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def apply_cfg(out_cond: torch.Tensor, out_uncond: torch.Tensor, guidance: float) -> torch.Tensor:
    """cond + g * (cond - uncond)."""
    return out_cond + guidance * (out_cond - out_uncond)


@torch.no_grad()
def generate_samples(
    net_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    init_noise: torch.Tensor,  # (B, C, T, H, W) ~ N(0, 1)
    augment_noise: torch.Tensor,  # (B, C, T, H, W), fixed across steps
    crossattn_cond: torch.Tensor,  # (B, M, 1024)
    crossattn_uncond: torch.Tensor,
    gt_latent: torch.Tensor,  # (B, C, T, H, W)
    condition_video_indicator: torch.Tensor,  # (1, 1, T, 1, 1)
    condition_video_input_mask: torch.Tensor,  # (B, 1, T, H, W)
    pose_latent_cond: torch.Tensor,  # (B, P, T, H, W)
    pose_latent_uncond: torch.Tensor,
    num_steps: int = 35,
    guidance: float = 1.0,
    condition_augment_sigma: float = 0.001,
    schedule: EDMEulerSchedule = EDMEulerSchedule(),
    net_in_dtype: torch.dtype = torch.float32,
    on_step: Optional[Callable[[int], None]] = None,
) -> torch.Tensor:
    """Run the denoising loop; returns the final latent (B, C, T, H, W), fp32.

    net_fn(x_in, t_in, crossattn) -> raw DiT output for a 2B batch whose
    channels already carry [x, input mask, pose latent]. on_step(i) is
    called after each step (timing hooks).
    """
    sigmas = [float(s) for s in schedule.sigmas(num_steps)]
    c_noises = [float(t) for t in schedule.timesteps(num_steps)]
    B = init_noise.shape[0]
    xt = init_noise.float() * schedule.init_noise_sigma
    aug = condition_augment_sigma
    gt = gt_latent.float()
    indicator_base = condition_video_indicator.float()
    augment_latent = (gt + augment_noise.float() * aug) * schedule.c_in(aug)
    crossattn_both = torch.cat([crossattn_cond, crossattn_uncond], dim=0)
    t_in_shape = (2 * B,)

    for i in range(num_steps):
        sigma = sigmas[i]
        indicator = torch.zeros_like(indicator_base) if aug >= sigma else indicator_base
        c_in = schedule.c_in(sigma)
        new_xt = indicator * (augment_latent / c_in) + (1 - indicator) * xt
        x_scaled = (new_xt * c_in).to(net_in_dtype)
        mask = condition_video_input_mask.to(net_in_dtype)
        x_in = torch.cat([
            torch.cat([x_scaled, mask, pose_latent_cond.to(net_in_dtype)], dim=1),
            torch.cat([x_scaled, mask, pose_latent_uncond.to(net_in_dtype)], dim=1),
        ], dim=0)
        t_in = torch.full(t_in_shape, c_noises[i], dtype=torch.float32, device=xt.device)
        net_out = net_fn(x_in, t_in, crossattn_both).float()
        net_output = apply_cfg(net_out[:B], net_out[B:], guidance)
        latent_unscaled = schedule.reverse_precondition_output(gt, new_xt, sigma)
        new_output = indicator * latent_unscaled + (1 - indicator) * net_output
        xt = schedule.step(new_output, new_xt, sigma, sigmas[i + 1])
        if on_step is not None:
            on_step(i)
    return xt
