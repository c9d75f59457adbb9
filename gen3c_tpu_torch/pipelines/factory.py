"""Model presets and construction (port of gen3c_tpu/pipelines/factory.py).

"gen3c_7b" is GEN3C-Cosmos-7B at full width (28 blocks x 4096 channels,
32 heads x 128, bf16 DiT, fp32 CV8x8x8 VAE); "gen3c_tiny" is the same
topology at test size in fp32. No checkpoint loading yet: weights are a
seeded random init drawn on the target device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import torch

from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT
from gen3c_tpu_torch.models.gen3c import Gen3CModel
from gen3c_tpu_torch.models.vae import CV8x8x8, CausalVAE, VAEConfig, VideoTokenizer
from gen3c_tpu_torch.utils import log


@dataclasses.dataclass(frozen=True)
class Gen3CPreset:
    name: str
    dit: DiTConfig
    vae: VAEConfig
    height: int
    width: int
    chunk_size: int  # pixel frames per diffusion call
    frame_buffer_max: int = 2

    @property
    def state_shape(self) -> Tuple[int, int, int, int]:
        lat_t = (self.chunk_size - 1) // self.vae.temporal_compression + 1
        return (
            self.vae.latent_channels,
            lat_t,
            self.height // self.vae.spatial_compression,
            self.width // self.vae.spatial_compression,
        )


GEN3C_7B_PRESET = Gen3CPreset(
    name="gen3c_7b",
    dit=DiTConfig(in_channels=16 + 16 * 4 + 1, rope_t_extrapolation_ratio=2.0),
    vae=CV8x8x8,
    height=704,
    width=1280,
    chunk_size=121,
)

GEN3C_TINY_PRESET = Gen3CPreset(
    name="gen3c_tiny",
    dit=DiTConfig(
        in_channels=16 + 16 * 4 + 1,
        model_channels=96,
        num_blocks=2,
        num_heads=4,
        adaln_lora_dim=8,
        crossattn_emb_channels=1024,
        rope_t_extrapolation_ratio=2.0,
        dtype=torch.float32,
    ),
    vae=VAEConfig(
        channels=16,
        channels_mult=(2, 4, 4),
        num_res_blocks=1,
        attn_resolutions=(),
        resolution=256,
        patch_size=4,
        latent_channels=16,
        z_channels=16,
    ),
    height=96,
    width=160,
    chunk_size=9,
)

PRESETS = {p.name: p for p in (GEN3C_7B_PRESET, GEN3C_TINY_PRESET)}

# checkpoint files the JAX factory would load; the port cannot yet
_CHECKPOINT_FILES = (
    os.path.join("GEN3C-Cosmos-7B", "model.pt"),
    os.path.join("gen3c_tpu", "dit.npz"),
    os.path.join("gen3c_tpu", "vae.npz"),
    "Cosmos-Tokenize1-CV8x8x8-720p",
)


def build_gen3c_model(
    preset: Union[str, Gen3CPreset] = "gen3c_7b",
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    checkpoint_dir: Optional[str] = None,
) -> Tuple[Gen3CModel, Gen3CPreset]:
    """Build a Gen3CModel with seeded random weights on ``device``.

    dtype overrides the preset's DiT dtype (bf16 for 7B, fp32 for tiny);
    the VAE stays fp32. A checkpoint_dir that holds real weights raises:
    loading them is not ported yet, and silently ignoring them would
    change what the run means.
    """
    if isinstance(preset, str):
        preset = PRESETS[preset]
    if checkpoint_dir:
        found = [f for f in _CHECKPOINT_FILES if os.path.exists(os.path.join(checkpoint_dir, f))]
        if found:
            raise NotImplementedError(
                f"checkpoint loading is not ported yet (found {found} in {checkpoint_dir})"
            )
    if dtype is not None:
        preset = dataclasses.replace(preset, dit=dataclasses.replace(preset.dit, dtype=dtype))
    device = torch.device(device)
    log.warning(f"No checkpoint loading in this port; RANDOM init ({preset.name}, seed {seed}).")

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        net = GeneralDIT(preset.dit)
        vae = CausalVAE(preset.vae)
    net = net.to_empty(device=device).init_random(gen)
    vae = vae.to_empty(device=device).init_random(gen)
    net.eval()
    vae.eval()
    tokenizer = VideoTokenizer(vae, pixel_chunk_duration=preset.chunk_size,
                               spatial_resolution=(preset.height, preset.width))
    model = Gen3CModel(
        net=net,
        tokenizer=tokenizer,
        frame_buffer_max=preset.frame_buffer_max,
        chunk_size=preset.chunk_size,
        state_shape=preset.state_shape,
    )
    return model, preset
