"""Gen3cPipeline: one generation chunk, end to end (port of
gen3c_tpu/pipelines/gen3c_pipeline.py).

  prompt -> T5 embedding (the text encoder's, or zeros without one)
  seed frames -> condition latent (zero-padded chunk encode)
  warped buffers + masks -> per-buffer VAE latents (pose conditioning)
  -> EDM-Euler denoise with batched CFG -> VAE decode -> uint8 frames

A text guardrail (``aux.guardrail.GuardrailRunner``) refuses a prompt before
any encode, a video guardrail the decoded frames after the decode (its
post-processing, the face blur, applied to the uint8 frames it passes):
``generate`` then returns None.

Sampling is Euler, dpm2m or res2ab (``solver``) with the JAX package's
guidance interval, CFG rescale and step caching (fixed-interval, adaptive,
or of a span of blocks when the model's DiT has one).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gen3c_tpu_torch.models.gen3c import Gen3CModel
from gen3c_tpu_torch.models.t5 import DummyT5TextEncoder
from gen3c_tpu_torch.utils import log
from gen3c_tpu_torch.utils.timing import synchronize


def video_to_uint8(video: torch.Tensor) -> np.ndarray:
    """(B, 3, T, H, W) in [-1, 1] -> (T, H, W, 3) uint8 of batch entry 0,
    converted on the device (truncation, as the JAX package's astype)."""
    u8 = ((video[0] + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
    return u8.permute(1, 2, 3, 0).cpu().numpy()


@dataclasses.dataclass
class Gen3cPipeline:
    model: Gen3CModel
    # encode_prompts(prompt) -> (embeddings, mask), e.g. models.t5's
    # T5TextEncoder; None: zero embeddings (DummyT5TextEncoder)
    text_encoder: Optional[object] = None
    # aux.guardrail.GuardrailRunner-like: run(prompt) -> bool; run(frames)
    # -> the post-processed frames, or None when blocked
    text_guardrail: Optional[object] = None
    video_guardrail: Optional[object] = None
    guidance: float = 1.0
    num_steps: int = 35
    step_cache_interval: int = 1
    step_cache_threshold: float = 0.0
    # (sigma_lo, sigma_hi): CFG only on steps inside the interval
    guidance_interval: Optional[Sequence[float]] = None
    cfg_rescale: float = 0.0
    seed: int = 0
    # the denoise's integration rule: euler, dpm2m or res2ab
    solver: str = "euler"

    def __post_init__(self):
        if self.text_encoder is None:
            self.text_encoder = DummyT5TextEncoder()
        # seconds of the last generate(): encode_prompt (the prompt and the
        # negative prompt), encode_condition, encode_warps,
        # denoise_steps (one {"seconds", "cfg", "refresh"} per step: whether
        # the step ran CFG or condition-only, and whether it ran the network
        # or reused the step cache), decode; and its final latent
        self.last_timings: dict = {}
        self.last_samples: Optional[torch.Tensor] = None

    def _encode_prompt(self, prompt: str) -> torch.Tensor:
        emb, _ = self.text_encoder.encode_prompts(prompt)
        return torch.from_numpy(emb).to(self.model.device)

    @torch.no_grad()
    def generate(
        self,
        prompt: str,
        image_frames,  # (B, 3, T_seed, H, W) in [-1, 1], numpy or tensor
        rendered_warp_images: torch.Tensor,  # (B, F, N, 3, H, W)
        rendered_warp_masks: torch.Tensor,  # (B, F, N, 1, H, W)
        negative_prompt: Optional[str] = None,
        seed: Optional[int] = None,
    ) -> Optional[Tuple[np.ndarray, str]]:
        """Generate one chunk: ((T, H, W, 3) uint8 frames, prompt), or None
        when a guardrail blocks the prompt or the video."""
        if self.text_guardrail is not None and not self.text_guardrail.run(prompt):
            log.warning("Guardrail blocked the prompt.")
            return None
        dev = self.model.device
        timings = {"denoise_steps": []}
        t0 = time.perf_counter()
        t5_emb = self._encode_prompt(prompt)
        neg_emb = self._encode_prompt(negative_prompt) if negative_prompt else None
        synchronize(dev)
        timings["encode_prompt"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        frames = torch.as_tensor(image_frames).to(device=dev, dtype=torch.float32)
        condition_latent = self.model.create_condition_latent_from_input_frames(
            frames, num_frames_condition=frames.shape[2])
        num_condition_t = self.model.compute_num_latent_frames(frames.shape[2])
        synchronize(dev)
        t1 = time.perf_counter()
        timings["encode_condition"] = t1 - t0

        pose_latent = self.model.encode_warped_frames(
            torch.as_tensor(rendered_warp_images).to(dev),
            torch.as_tensor(rendered_warp_masks).to(dev))
        synchronize(dev)
        t2 = time.perf_counter()
        timings["encode_warps"] = t2 - t1
        log.info(f"encode: seed latent {t1 - t0:.2f}s, warp buffers {t2 - t1:.2f}s")

        last = [t2]

        def on_step(i, cfg, refresh):
            synchronize(dev)
            now = time.perf_counter()
            timings["denoise_steps"].append({"seconds": now - last[0], "cfg": cfg,
                                             "refresh": refresh})
            last[0] = now

        log.info(f"Denoising ({self.num_steps} steps, CFG batched)...")
        samples = self.model.generate_samples(
            t5_embeddings=t5_emb,
            condition_latent=condition_latent,
            pose_latent=pose_latent,
            num_condition_t=num_condition_t,
            guidance=self.guidance,
            num_steps=self.num_steps,
            seed=self.seed if seed is None else seed,
            neg_t5_embeddings=neg_emb,
            step_cache_interval=self.step_cache_interval,
            step_cache_threshold=self.step_cache_threshold,
            guidance_interval=self.guidance_interval,
            cfg_rescale=self.cfg_rescale,
            on_step=on_step,
            solver=self.solver,
        )
        del pose_latent
        t3 = time.perf_counter()
        video = self.model.decode(samples)
        frames_u8 = video_to_uint8(video)
        timings["decode"] = time.perf_counter() - t3
        self.last_timings = timings
        self.last_samples = samples
        steps = [f"{s['seconds']:.2f}{'' if s['cfg'] else 'c'}{'' if s['refresh'] else '*'}"
                 for s in timings["denoise_steps"]]
        log.info(f"denoise steps {steps}s (c: condition-only, *: cached), "
                 f"decode {timings['decode']:.2f}s")
        if self.video_guardrail is not None:
            frames_u8 = self.video_guardrail.run(frames_u8)
            if frames_u8 is None:
                log.warning("Guardrail blocked the generated video.")
                return None
        return frames_u8, prompt
