"""Latent diffusion decoder of the AR world model, PyTorch/CUDA.

Port of gen3c_tpu/pipelines/diffusion_decoder.py (cosmos_predict1's
autoregressive/diffusion_decoder, the 7B "discrete_cond_on_token" node):

  * the AR tokens are embedded by a learned table (vocab 64,000, dim 32),
    each frame bilinearly resized from the token grid to the latent grid
    (``jax.image.resize``'s weights, ``ops/resize.py``) and concatenated
    to the noisy latent as 32 channels: the port's ``GeneralDIT`` with 48
    input channels (+ the padding mask), RoPE extrapolated 1.5x in H and W;
  * CFG's unconditioned half embeds token 0 everywhere (the conditioner's
    dropout), with zero T5 context on both halves by default;
  * EDM-Euler (sigma_max 80, sigma_min 0.02), guidance 1.8, 15 steps, the
    plain text2world loop of ``diffusion/sampler.generate_samples``;
  * a long token video is cut into chunks of (57 - 1) / 8 + 1 = 8 latent
    frames overlapping by 2, the last reflect-padded; each chunk is
    refined and decoded by the continuous CV8x8x8 tokenizer, and the pixel
    chunks are blended linearly over ``overlap`` frames.

The 7B decoder is checkpoint-gated, as in gen3c_tpu: ``build_dd_pipeline``
raises FileNotFoundError without <checkpoint_dir>/gen3c_tpu/dd_dit.npz and
the AR CLI then decodes with the DV tokenizer. ``make_dd_pipeline`` builds
a seeded one of any config (the tiny preset, the smoke, the timing run).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from gen3c_tpu_torch.diffusion.sampler import arch_invariant_randn, generate_samples
from gen3c_tpu_torch.diffusion.scheduler import EDMEulerSchedule
from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT
from gen3c_tpu_torch.models.vae import CV8x8x8, CausalVAE, VAEConfig, VideoTokenizer
from gen3c_tpu_torch.ops.resize import resize
from gen3c_tpu_torch.utils import checkpoint as ckpt
from gen3c_tpu_torch.utils import log
from gen3c_tpu_torch.utils.timing import Laps

TOKEN_VOCAB_SIZE = 64000  # diffusion_decoder_token_condition_voc_size
TOKEN_CONDITION_DIM = 32  # diffusion_decoder_token_condition_dim

# x (16) + token embedding (32); the net appends the padding-mask channel
DIFFUSION_DECODER_7B = DiTConfig(
    in_channels=16 + TOKEN_CONDITION_DIM,
    rope_h_extrapolation_ratio=1.5,
    rope_w_extrapolation_ratio=1.5,
    rope_t_extrapolation_ratio=1.0,
)
DIFFUSION_DECODER_TINY = DiTConfig(
    in_channels=16 + TOKEN_CONDITION_DIM,
    model_channels=96,
    num_blocks=2,
    num_heads=4,
    adaln_lora_dim=8,
    dtype=torch.float32,
)
# ar_tiny's continuous tokenizer: 8x spatial like DV_TINY (token_to_latent_scale 1)
CV_TINY = VAEConfig(channels=16, channels_mult=(2, 4, 4), num_res_blocks=1, attn_resolutions=(),
                    resolution=256, patch_size=4, latent_channels=16, z_channels=16)


@dataclasses.dataclass
class DDSamplingConfig:
    """DiffusionDecoderSamplingConfig (inference_config.py:53-77)."""

    guidance: float = 1.8
    sigma_min: float = 0.02
    num_steps: int = 15
    overlap: int = 2  # latent-frame overlap between token chunks
    dd_train_num_video_frames: int = 57
    max_iter: int = 99
    fps: int = 24


class DiffusionDecoderDiT(GeneralDIT):
    """The decoder's DiT: a GeneralDIT plus ``token_embedder`` (vocab, dim),
    kept in fp32 (bridge ``dd_state_from_jax``)."""

    def __init__(self, cfg: DiTConfig, vocab_size: int = TOKEN_VOCAB_SIZE,
                 token_dim: int = TOKEN_CONDITION_DIM, device=None):
        super().__init__(cfg, device)
        self.token_embedder = nn.Embedding(vocab_size, token_dim, device=device,
                                           dtype=torch.float32).requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "DiffusionDecoderDiT":
        """GeneralDIT's init, the token table N(0, 0.02) (the reference zeroes
        it before fine-tuning; random keeps the conditioning path alive)."""
        super().init_random(generator)
        self.token_embedder.weight.normal_(0.0, 0.02, generator=generator)
        return self


def split_with_overlap(tokens: torch.Tensor, num_frames: int, overlap: int = 2
                       ) -> List[torch.Tensor]:
    """(B, C, T, H, W) -> chunks of num_frames along T overlapping by
    ``overlap``; the last chunk is REFLECT-padded to full length, and a pad
    of at least the chunk's body raises ValueError (torch's reflect pad
    would)."""
    if overlap >= num_frames:
        raise ValueError(f"overlap {overlap} must be below num_frames {num_frames}")
    T = tokens.shape[2]
    step = num_frames - overlap
    chunks = []
    for start in range(0, max(T - overlap, 1), step):
        end = start + num_frames
        if end > T:
            pad = end - T
            body_len = T - start
            if pad >= body_len:
                raise ValueError(f"split_with_overlap: reflect pad {pad} >= chunk body "
                                 f"{body_len} (T={T}, num_frames={num_frames}, "
                                 f"overlap={overlap})")
            body = tokens[:, :, start:T]
            refl = body[:, :, body_len - 2 - pad + 1: body_len - 1].flip(2)
            chunks.append(torch.cat([body, refl], dim=2))
        else:
            chunks.append(tokens[:, :, start:end])
    return chunks


def linear_blend_video_list(videos: List[torch.Tensor], d: int) -> torch.Tensor:
    """Blend equal-length (B, C, t, H, W) videos with linspace(0, 1, d)
    weights over d overlapping frames (utils.py:61-119)."""
    if len(videos) < 2:
        raise ValueError("linear_blend_video_list needs at least two videos")
    t = videos[0].shape[2]
    out = [videos[0][:, :, : t - d]]
    weights = torch.linspace(0.0, 1.0, d, device=videos[0].device).reshape(1, 1, d, 1, 1)
    for i in range(1, len(videos)):
        out.append(videos[i - 1][:, :, t - d:] * (1 - weights) + videos[i][:, :, :d] * weights)
        if i < len(videos) - 1:
            if t - 2 * d > 0:
                out.append(videos[i][:, :, d: t - d])
        else:
            out.append(videos[i][:, :, d:])
    return torch.cat(out, dim=2)


def embed_tokens(token_embedding: torch.Tensor, token_indices: torch.Tensor,
                 latent_hw) -> torch.Tensor:
    """Embed (B, T', H', W') tokens with the (vocab, dim) table and resize
    each frame bilinearly to the latent grid: (B, dim, T', H, W)."""
    emb = token_embedding[token_indices.long()].permute(0, 1, 4, 2, 3)  # (B, T', D, H', W')
    B, T, D, Hs, Ws = emb.shape
    H, W = latent_hw
    resized = resize(emb.reshape(B * T, D, Hs, Ws), (B * T, D, H, W), "bilinear")
    return resized.reshape(B, T, D, H, W).permute(0, 2, 1, 3, 4)


@dataclasses.dataclass
class DiffusionDecoderPipeline:
    """AR tokens -> diffusion-refined video (inference.py:30-117)."""

    net: DiffusionDecoderDiT
    continuous_tokenizer: VideoTokenizer
    sigma_data: float = 0.5
    sampling: DDSamplingConfig = dataclasses.field(default_factory=DDSamplingConfig)
    # latent grid / token grid: 2 for DV8x16x16 tokens under CV8x8x8 latents
    token_to_latent_scale: int = 2

    @property
    def device(self) -> torch.device:
        return self.net.token_embedder.weight.device

    @torch.no_grad()
    def _refine_chunk(self, token_chunk: torch.Tensor, t5_embeddings: torch.Tensor, seed: int,
                      on_step=None) -> torch.Tensor:
        """One (B, 1, T', H', W') chunk through the EDM loop: its latent."""
        cfg = self.sampling
        B, _, T = token_chunk.shape[:3]
        H = token_chunk.shape[3] * self.token_to_latent_scale
        W = token_chunk.shape[4] * self.token_to_latent_scale
        C = self.continuous_tokenizer.latent_ch
        dev = self.device
        table = self.net.token_embedder.weight
        cond = embed_tokens(table, token_chunk[:, 0], (H, W))
        uncond = embed_tokens(table, torch.zeros_like(token_chunk[:, 0]), (H, W))
        shape = (B, C, T, H, W)
        init_noise = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
        net = self.net
        return generate_samples(
            lambda x, t, ctx: net(x, t, ctx, fps=24.0),
            init_noise=torch.from_numpy(init_noise).to(dev),
            augment_noise=torch.from_numpy(arch_invariant_randn(shape, seed)).to(dev),
            crossattn_cond=t5_embeddings,
            crossattn_uncond=t5_embeddings * 0.0,
            gt_latent=torch.zeros(shape, dtype=torch.float32, device=dev),
            condition_video_indicator=torch.zeros((1, 1, T, 1, 1), device=dev),
            condition_video_input_mask=None,
            pose_latent_cond=cond,
            pose_latent_uncond=uncond,
            num_steps=cfg.num_steps,
            guidance=cfg.guidance,
            schedule=EDMEulerSchedule(sigma_min=cfg.sigma_min),
            on_step=on_step,
        )

    def chunks(self, token_indices: torch.Tensor) -> List[torch.Tensor]:
        """The (B, 1, T', H', W') token chunks ``refine`` runs: the whole
        video when it is one chunk long, else ``split_with_overlap``
        (always for a short one, which is reflect-padded to a full chunk)."""
        cfg = self.sampling
        latent_frames = (cfg.dd_train_num_video_frames - 1) // 8 + 1
        token_5d = token_indices[:, None]
        if token_indices.shape[1] == latent_frames:
            return [token_5d]
        return split_with_overlap(token_5d, latent_frames, overlap=cfg.overlap)[: cfg.max_iter]

    @torch.no_grad()
    def refine(self, token_indices: torch.Tensor, t5_embeddings: Optional[torch.Tensor] = None,
               seed: int = 0, record: Optional[dict] = None) -> torch.Tensor:
        """(B, T', H', W') AR tokens -> refined video (B, 3, T, H, W) in [-1,
        1]. record, if given, receives each chunk's denoise-step ends and
        decode seconds ("step_s", "decode_s"; with a card, synchronised)."""
        B = token_indices.shape[0]
        dev = self.device
        token_indices = token_indices.to(dev)
        if t5_embeddings is None:
            t5_embeddings = torch.zeros((B, 512, 1024), dtype=torch.float32, device=dev)
        chunks = self.chunks(token_indices)
        pixels = []
        laps = Laps(dev, record)
        for i, chunk in enumerate(chunks):
            log.info(f"diffusion decoder: refining chunk {i + 1}/{len(chunks)}")
            laps.start()
            latent = self._refine_chunk(chunk, t5_embeddings.to(dev), seed,
                                        on_step=lambda *_: laps.lap("step_s"))
            laps.start()
            pixel = self.continuous_tokenizer.decode(latent / self.sigma_data)
            laps.lap("decode_s")
            pixels.append(pixel.clamp(-1.0, 1.0))
        if len(pixels) == 1:
            return pixels[0]
        return linear_blend_video_list(pixels, self.sampling.overlap)


def make_dd_pipeline(dit_cfg: DiTConfig = DIFFUSION_DECODER_7B, cv_cfg: VAEConfig = CV8x8x8,
                     sampling: Optional[DDSamplingConfig] = None, token_to_latent_scale: int = 2,
                     device="cuda", seed: int = 0,
                     vocab_size: int = TOKEN_VOCAB_SIZE) -> DiffusionDecoderPipeline:
    """A seeded decoder: the DiT and token table from ``seed``, the
    continuous tokenizer from ``seed + 7``, built on ``device``."""
    sampling = sampling or DDSamplingConfig()
    with torch.device("meta"):
        net = DiffusionDecoderDiT(dit_cfg, vocab_size=vocab_size)
        vae = CausalVAE(cv_cfg)
    net = net.to_empty(device=device).init_random(
        torch.Generator(device=device).manual_seed(seed)).eval()
    vae = vae.to_empty(device=device).init_random(
        torch.Generator(device=device).manual_seed(seed + 7)).eval()
    return DiffusionDecoderPipeline(
        net=net,
        continuous_tokenizer=VideoTokenizer(
            vae, pixel_chunk_duration=sampling.dd_train_num_video_frames),
        sampling=sampling, token_to_latent_scale=token_to_latent_scale)


def build_dd_pipeline(preset: str, device="cuda", seed: int = 0,
                      checkpoint_dir: Optional[str] = None) -> DiffusionDecoderPipeline:
    """The AR CLI's decoder (world_generation_pipeline.py:222-244).
    "ar_tiny": the tiny decoder over a tiny CV tokenizer at DV_TINY's 8x
    (token_to_latent_scale 1), seeded. Any other preset: the 7B, which needs
    <checkpoint_dir>/gen3c_tpu/dd_dit.npz (FileNotFoundError otherwise: a
    random 7B decoder would refine through noise weights) and takes the CV
    tokenizer from <checkpoint_dir>/gen3c_tpu/vae.npz, else a seeded one."""
    from gen3c_tpu_torch.bridge import dd_state_from_jax

    if preset == "ar_tiny":
        return make_dd_pipeline(DIFFUSION_DECODER_TINY, CV_TINY,
                                DDSamplingConfig(dd_train_num_video_frames=9, overlap=1), 1,
                                device, seed)
    dd_native = os.path.join(checkpoint_dir or "", "gen3c_tpu", "dd_dit.npz")
    if not (checkpoint_dir and os.path.exists(dd_native)):
        raise FileNotFoundError(
            f"diffusion-decoder checkpoint not found ({dd_native}); the full-size decoder is "
            "checkpoint-gated (convert the reference Cosmos-1.0-Diffusion-7B-Decoder weights "
            "and save them with utils.checkpoint.save_params_npz)")
    pipe = make_dd_pipeline(device=device, seed=seed)
    pipe.net.load_state_dict(dd_state_from_jax(ckpt.load_params_npz_tree(dd_native)))
    vae_native = os.path.join(checkpoint_dir, "gen3c_tpu", "vae.npz")
    if os.path.exists(vae_native):
        pipe.continuous_tokenizer.vae.load_state_dict(
            ckpt.vae_state_dict(ckpt.load_flat_npz(vae_native)))
    else:
        log.warning("diffusion decoder's continuous tokenizer: RANDOM init (no vae.npz)")
    return pipe
