"""Condition containers and CFG pairing for GEN3C (port of
gen3c_tpu/models/conditioner.py): the conditioned pass uses the text
embeddings and pose latents, the unconditioned pass zeros (or the negative
prompt's embeddings) and zero pose latents; the first num_condition_t
latent frames are the condition region (with the last frame too for the
world interpolator's "first_and_last_1")."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class VideoExtendCondition:
    """Everything the denoiser consumes besides (x, t)."""

    crossattn_emb: torch.Tensor  # (B, M, 1024)
    gt_latent: Optional[torch.Tensor] = None  # (B, C, T, H, W)
    condition_video_indicator: Optional[torch.Tensor] = None  # (1, 1, T, 1, 1)
    condition_video_input_mask: Optional[torch.Tensor] = None  # (B, 1, T, H, W)
    condition_video_pose: Optional[torch.Tensor] = None  # (B, P, T, H, W)
    # False: the input mask is all zeros (the network is not told where the
    # condition region is), as the reference's input-frames guidance does
    video_cond_bool: bool = True


def add_condition_video_indicator_and_input_mask(
    latent_state: torch.Tensor, condition: VideoExtendCondition, num_condition_t: int,
    condition_location: str = "first_n",
) -> VideoExtendCondition:
    """Mark the condition region in latent time: the first num_condition_t
    frames ("first_n"), and also the last frame ("first_and_last_1", the
    world interpolator's); another location raises ValueError."""
    B, C, T, H, W = latent_state.shape
    indicator = torch.zeros((1, 1, T, 1, 1), dtype=latent_state.dtype, device=latent_state.device)
    indicator[:, :, :num_condition_t] = 1.0
    if condition_location == "first_and_last_1":
        indicator[:, :, -1:] = 1.0
    elif condition_location != "first_n":
        raise ValueError(f"Unknown condition_location {condition_location}")
    condition.gt_latent = latent_state
    condition.condition_video_indicator = indicator
    if condition.video_cond_bool:
        condition.condition_video_input_mask = indicator.expand(B, 1, T, H, W).clone()
    else:
        condition.condition_video_input_mask = torch.zeros(
            (B, 1, T, H, W), dtype=latent_state.dtype, device=latent_state.device)
    return condition


def make_condition_pair(
    latent_state: torch.Tensor,
    t5_embeddings: torch.Tensor,
    num_condition_t: int,
    pose_latent: Optional[torch.Tensor] = None,
    neg_t5_embeddings: Optional[torch.Tensor] = None,
):
    """(condition, uncondition) for classifier-free guidance."""
    cond = add_condition_video_indicator_and_input_mask(
        latent_state, VideoExtendCondition(crossattn_emb=t5_embeddings), num_condition_t)
    if pose_latent is not None:
        cond.condition_video_pose = pose_latent
    uncond_text = torch.zeros_like(t5_embeddings) if neg_t5_embeddings is None else neg_t5_embeddings
    uncond = add_condition_video_indicator_and_input_mask(
        latent_state, VideoExtendCondition(crossattn_emb=uncond_text), num_condition_t)
    if pose_latent is not None:
        uncond.condition_video_pose = torch.zeros_like(pose_latent)
    return cond, uncond
