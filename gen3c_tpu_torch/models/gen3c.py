"""Gen3CModel: the GEN3C denoiser wrapper (port of gen3c_tpu/models/gen3c.py).

Latents are scaled by sigma_data; the warped buffers and their masks are
VAE-encoded per buffer into the pose latent; sampling is the EDM-Euler
loop with batched CFG, or the dpm2m / res2ab multistep solvers, with the
JAX package's guidance interval, CFG rescale and step caching (the whole
output, or a span of blocks), on one device or, when the model carries
process groups with a cp, cfg or tp axis of size > 1, context-, CFG- and
tensor-parallel over them (``parallel.cp.cp_generate_samples``), with
sequence parallelism where ``sequence_parallel`` is set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gen3c_tpu_torch.diffusion.sampler import arch_invariant_randn, generate_samples
from gen3c_tpu_torch.diffusion.scheduler import EDMEulerSchedule
from gen3c_tpu_torch.models.conditioner import make_condition_pair
from gen3c_tpu_torch.models.dit import GeneralDIT
from gen3c_tpu_torch.models.vae import VideoTokenizer
from gen3c_tpu_torch.parallel.mesh import Groups

DEFAULT_AUGMENT_SIGMA = 0.001


@dataclasses.dataclass
class Gen3CModel:
    """GEN3C-Cosmos-7B wrapper: DiT + tokenizer + schedule."""

    net: GeneralDIT
    tokenizer: VideoTokenizer
    sigma_data: float = 0.5
    frame_buffer_max: int = 2
    chunk_size: int = 121  # pixel frames per diffusion call
    state_shape: Tuple[int, int, int, int] = (16, 16, 88, 160)
    schedule: EDMEulerSchedule = dataclasses.field(default_factory=EDMEulerSchedule)
    # this rank's cfg, cp and tp axes (parallel.mesh.make_groups); None: one device
    groups: Optional[Groups] = None
    # Megatron-SP in the cp x tp denoise (needs a tp axis of size > 1)
    sequence_parallel: bool = False

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    # ----- tokenizer plumbing -----

    def encode(self, state: torch.Tensor) -> torch.Tensor:
        return self.tokenizer.encode(state) * self.sigma_data

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        return self.tokenizer.decode(latent / self.sigma_data)

    def compute_num_latent_frames(self, num_input_frames: int) -> int:
        pcd = self.tokenizer.pixel_chunk_duration
        lcd = self.tokenizer.latent_chunk_duration
        n = num_input_frames // pcd * lcd
        rem = num_input_frames % lcd
        if rem == 1:
            n += 1
        elif rem > 1:
            n += 1 + (num_input_frames % pcd - 1) // 8
        return n

    def create_condition_latent_from_input_frames(
        self, input_frames: torch.Tensor, num_frames_condition: int = 1
    ) -> torch.Tensor:
        """Last num_frames_condition frames, zero-padded to the pixel chunk,
        encoded. input_frames: (B, 3, T, H, W) in [-1, 1]."""
        B, C, T, H, W = input_frames.shape
        if T < num_frames_condition:
            raise ValueError(f"{T} input frames < {num_frames_condition} condition frames")
        cond = input_frames[:, :, -num_frames_condition:]
        pad = torch.zeros((B, C, self.tokenizer.pixel_chunk_duration - num_frames_condition, H, W),
                          dtype=input_frames.dtype, device=input_frames.device)
        return self.encode(torch.cat([cond, pad], dim=2))

    def encode_warped_frames(self, condition_state: torch.Tensor,
                             condition_state_mask: torch.Tensor) -> torch.Tensor:
        """(B, F, N, 3, H, W) warps + (B, F, N, 1, H, W) masks -> pose latent
        (B, 32 * frame_buffer_max, T', H/8, W/8), zero-padded past N."""
        if condition_state.ndim != 6:
            raise ValueError(f"expected (B, F, N, C, H, W), got {tuple(condition_state.shape)}")
        N = condition_state.shape[2]
        latents = []
        for i in range(N):
            video = condition_state[:, :, i].transpose(1, 2)
            mvideo = (condition_state_mask[:, :, i] * 2.0 - 1.0).repeat(1, 1, 3, 1, 1).transpose(1, 2)
            latents.append(self.encode(video))
            latents.append(self.encode(mvideo))
        for _ in range(self.frame_buffer_max - N):
            latents.append(torch.zeros_like(latents[-2]))
            latents.append(torch.zeros_like(latents[-1]))
        return torch.cat(latents, dim=1)

    def generate_samples(
        self,
        t5_embeddings: torch.Tensor,  # (B, 512, 1024)
        condition_latent: torch.Tensor,  # (B, 16, T, H, W), sigma_data-scaled
        pose_latent: torch.Tensor,
        num_condition_t: int = 1,
        guidance: float = 1.0,
        num_steps: int = 35,
        seed: int = 1,
        neg_t5_embeddings: Optional[torch.Tensor] = None,
        step_cache_interval: int = 1,
        step_cache_threshold: float = 0.0,
        guidance_interval: Optional[Sequence[float]] = None,
        cfg_rescale: float = 0.0,
        on_step=None,
        solver: str = "euler",
    ) -> torch.Tensor:
        """The GEN3C denoise; returns the latent (B, 16, T, H', W'), fp32.

        guidance_interval=(sigma_lo, sigma_hi) restricts CFG to the steps
        whose sigma lies inside it; the sampling options are those of
        ``diffusion.sampler.generate_samples``. With the net's
        ``cache_block_span`` set and step_cache_interval > 1 the skipped
        steps run the blocks outside the span (span caching,
        gen3c_tpu/models/gen3c.py:352-420); a threshold with it raises."""
        B = condition_latent.shape[0]
        state_shape = tuple(self.state_shape)
        dev = condition_latent.device
        if condition_latent.shape[2] < state_shape[1]:
            pad_t = state_shape[1] - condition_latent.shape[2]
            condition_latent = torch.cat([
                condition_latent,
                torch.zeros(condition_latent.shape[:2] + (pad_t,) + condition_latent.shape[3:],
                            dtype=condition_latent.dtype, device=dev),
            ], dim=2)
        cond, uncond = make_condition_pair(
            condition_latent, t5_embeddings, num_condition_t,
            pose_latent=pose_latent, neg_t5_embeddings=neg_t5_embeddings,
        )
        # the JAX package draws both from a fresh RandomState(seed): the
        # same numbers
        init_noise = np.random.RandomState(seed).standard_normal((B,) + state_shape)
        augment_noise = arch_invariant_randn((B,) + state_shape, seed)

        inputs = dict(
            init_noise=torch.from_numpy(init_noise.astype(np.float32)).to(dev),
            augment_noise=torch.from_numpy(augment_noise).to(dev),
            crossattn_cond=cond.crossattn_emb,
            crossattn_uncond=uncond.crossattn_emb,
            gt_latent=cond.gt_latent,
            condition_video_indicator=cond.condition_video_indicator,
            condition_video_input_mask=cond.condition_video_input_mask,
            pose_latent_cond=cond.condition_video_pose,
            pose_latent_uncond=uncond.condition_video_pose,
            num_steps=num_steps,
            guidance=guidance,
            condition_augment_sigma=DEFAULT_AUGMENT_SIGMA,
            schedule=self.schedule,
            net_in_dtype=self.net.cfg.dtype,
            step_cache_interval=step_cache_interval,
            step_cache_threshold=step_cache_threshold,
            guidance_interval=guidance_interval,
            cfg_rescale=cfg_rescale,
            on_step=on_step,
            solver=solver,
        )
        if self.groups is not None and self.groups.parallel:
            # gen3c_tpu/models/gen3c.py:317-350: every rank holds the global noise
            from gen3c_tpu_torch.parallel.cp import cp_generate_samples

            return cp_generate_samples(self.groups, self.net,
                                       sequence_parallel=self.sequence_parallel, **inputs)
        span = self.net.cfg.cache_block_span is not None and step_cache_interval > 1
        if span and step_cache_threshold > 0:
            raise ValueError("step_cache_block_span and step_cache_threshold are mutually "
                             "exclusive caching policies; pick one")
        net_fn, net_fn_skip = dit_net_fns(self.net, span)
        return generate_samples(net_fn, net_fn_skip=net_fn_skip, **inputs)


def dit_net_fns(net: GeneralDIT, span: bool, cp=None, tp=None, sp: bool = False):
    """(net_fn, net_fn_skip) for the sampler: the DiT at fps 24 (in its cp,
    tp and sp modes on their axes), and with span caching the refresh
    forward that also returns the span's delta and the skip forward that
    re-applies it (gen3c.py ``_dit_net_fn_span_*``, parallel/cp.py's
    ``_cp[_tp[_sp]]_span_*``); net_fn_skip is None without."""
    kw = dict(fps=24.0, cp=cp, tp=tp, sp=sp)
    if not span:
        return (lambda x, t, ctx: net(x, t, ctx, **kw)), None
    return ((lambda x, t, ctx: net(x, t, ctx, return_span_delta=True, **kw)),
            (lambda x, t, ctx, delta: net(x, t, ctx, span_delta=delta, **kw)))
