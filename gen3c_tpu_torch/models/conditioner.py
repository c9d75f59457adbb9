"""Condition containers and CFG pairing for GEN3C (port of
gen3c_tpu/models/conditioner.py): the conditioned pass uses the text
embeddings and pose latents, the unconditioned pass zeros (or the negative
prompt's embeddings) and zero pose latents; the first num_condition_t
latent frames are the condition region."""

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


def add_condition_video_indicator_and_input_mask(
    latent_state: torch.Tensor, condition: VideoExtendCondition, num_condition_t: int,
) -> VideoExtendCondition:
    """Mark the first num_condition_t latent frames as the condition region."""
    B, C, T, H, W = latent_state.shape
    indicator = torch.zeros((1, 1, T, 1, 1), dtype=latent_state.dtype, device=latent_state.device)
    indicator[:, :, :num_condition_t] = 1.0
    condition.gt_latent = latent_state
    condition.condition_video_indicator = indicator
    condition.condition_video_input_mask = indicator.expand(B, 1, T, H, W).clone()
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
