"""The action-conditioned DiT of the robot post-training family.

Port of gen3c_tpu/models/dit_action.py: the video-extend GeneralDIT plus
two timm-Mlp action embedders under the reference's names,
``action_embedder_B_D`` (7 -> 4D -> D) and ``action_embedder_B_3D`` (7 ->
4D -> 3D), each fc1 -> tanh-form GELU -> fc2 with biases. Only the 3D one
reaches the forward (``GeneralDIT.forward(action=)`` adds it to the
AdaLN-LoRA vector); the B_D one is carried for checkpoint compatibility,
as in gen3c_tpu and the reference. Used by the video2world_action
experiments (``utils.registry``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT


@dataclasses.dataclass(frozen=True)
class ActionDiTConfig(DiTConfig):
    # a bridge robot action: [dx, dy, dz, droll, dpitch, dyaw, gripper]
    action_dim: int = 7


class Mlp(nn.Module):
    """timm's Mlp: fc1 -> GELU(tanh) -> fc2, both with biases."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(d_in, d_hidden, device=device, dtype=dtype)
        self.fc2 = nn.Linear(d_hidden, d_out, device=device, dtype=dtype)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "Mlp":
        """torch.nn.Linear's default init drawn from ``generator``: weights
        and biases uniform in +-1/sqrt(fan_in)."""
        for lin in (self.fc1, self.fc2):
            b = 1.0 / math.sqrt(lin.in_features)
            lin.weight.uniform_(-b, b, generator=generator)
            lin.bias.uniform_(-b, b, generator=generator)
        return self


class ActionDiT(GeneralDIT):
    """GeneralDIT with the two action embedders; ``forward(..., action=)``."""

    def __init__(self, cfg: ActionDiTConfig, device=None):
        super().__init__(cfg, device)
        D, dt = cfg.model_channels, cfg.dtype
        self.action_embedder_B_D = Mlp(cfg.action_dim, 4 * D, D, device, dt)
        self.action_embedder_B_3D = Mlp(cfg.action_dim, 4 * D, 3 * D, device, dt)
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "ActionDiT":
        """GeneralDIT's init, then the embedders' Linear defaults, all from
        ``generator``."""
        super().init_random(generator)
        self.action_embedder_B_D.init_random(generator)
        self.action_embedder_B_3D.init_random(generator)
        return self
