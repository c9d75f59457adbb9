"""Finite Scalar Quantization (FSQ) and the discrete video tokenizer.

Port of gen3c_tpu/models/fsq.py. The DV8x16x16 tokenizer quantizes a
6-channel latent with levels (8, 8, 8, 5, 5, 5), an implicit codebook of
64,000 codes, on top of the causal encoder/decoder of the continuous VAE
(``models/vae.py``). Each latent channel is squashed by tanh to a grid of L
levels and rounded (straight-through); a token is the mixed-radix integer
of the channels' digits.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from gen3c_tpu_torch.models.vae import CausalVAE, VAEConfig

DEFAULT_LEVELS = (8, 8, 8, 5, 5, 5)


def _levels(levels: Sequence[int], device) -> torch.Tensor:
    return torch.tensor(list(levels), dtype=torch.float32, device=device)


def _basis(levels: Sequence[int], device) -> torch.Tensor:
    lv = np.asarray(levels, np.int64)
    basis = np.concatenate([[1], np.cumprod(lv[:-1])]).astype(np.int32)
    return torch.from_numpy(basis).to(device)


def fsq_bound(z: torch.Tensor, levels: Sequence[int], eps: float = 1e-3) -> torch.Tensor:
    """tanh squash into the level grid: (L - 1)(1 + eps)/2 half-width, a
    half-step atan shift for even level counts (fsq.py ``fsq_bound``)."""
    lv = _levels(levels, z.device)
    half_l = (lv - 1) * (1 + eps) / 2.0
    offset = torch.where(lv % 2 == 0, torch.full_like(lv, 0.5), torch.zeros_like(lv))
    shift = torch.atan(offset / half_l)
    return torch.tanh(z + shift) * half_l - offset


def fsq_quantize(z: torch.Tensor, levels: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., C = len(levels)) -> (codes normalised by L // 2, int32 indices).
    The round is straight-through: the gradient of the codes is that of the
    bounded latent."""
    lv = np.asarray(levels, np.int64)
    half_width = torch.from_numpy((lv // 2).astype(np.float32)).to(z.device)
    bounded = fsq_bound(z, levels)
    rounded = torch.round(bounded)
    quantized = bounded + (rounded - bounded).detach()
    codes = quantized / half_width
    digits = torch.round(quantized.detach() + half_width).to(torch.int32)
    idx = (digits * _basis(levels, z.device)).sum(dim=-1, dtype=torch.int32)
    return codes, idx


def fsq_indices_to_codes(indices: torch.Tensor, levels: Sequence[int]) -> torch.Tensor:
    """Inverse of ``fsq_quantize``'s indices: (...) -> normalised codes (..., C)."""
    lv = np.asarray(levels, np.int64)
    basis = _basis(levels, indices.device)
    radix = torch.from_numpy(lv.astype(np.int32)).to(indices.device)
    digits = torch.div(indices[..., None].to(torch.int32), basis, rounding_mode="floor") % radix
    half_width = torch.from_numpy((lv // 2).astype(np.float32)).to(indices.device)
    return (digits.float() - half_width) / half_width


@dataclasses.dataclass(frozen=True)
class DiscreteVAEConfig(VAEConfig):
    """The DV tokenizer: an FSQ bottleneck over the VAE's latent."""

    levels: Tuple[int, ...] = DEFAULT_LEVELS

    @property
    def vocab_size(self) -> int:
        return int(np.prod(self.levels))


DV8x16x16 = DiscreteVAEConfig(
    latent_channels=len(DEFAULT_LEVELS),
    z_channels=len(DEFAULT_LEVELS),
    spatial_compression=16,
    temporal_compression=8,
    channels_mult=(2, 4, 4, 4),
)


class DiscreteVideoFSQTokenizer:
    """video <-> discrete token indices over a ``CausalVAE`` of a
    ``DiscreteVAEConfig`` (fsq.py ``DiscreteVideoFSQTokenizer``)."""

    def __init__(self, vae: CausalVAE, pixel_chunk_duration: int = 33):
        self.vae = vae
        self.cfg = vae.cfg
        self.pixel_chunk_duration = pixel_chunk_duration

    @property
    def latent_chunk_duration(self) -> int:
        return (self.pixel_chunk_duration - 1) // self.cfg.temporal_compression + 1

    @torch.no_grad()
    def encode(self, video: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 3, T, H, W) in [-1, 1] -> (codes (B, C, T', H', W'), indices
        (B, T', H', W') int32)."""
        z = self.vae.encode(video)
        codes, idx = fsq_quantize(torch.movedim(z, 1, -1), self.cfg.levels)
        return torch.movedim(codes, -1, 1), idx

    @torch.no_grad()
    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        """(B, T', H', W') int -> (B, 3, T, H, W)."""
        codes = fsq_indices_to_codes(indices, self.cfg.levels)
        return self.vae.decode(torch.movedim(codes, -1, 1))
