"""Gen3cPipeline: one generation chunk, end to end (port of
gen3c_tpu/pipelines/gen3c_pipeline.py).

  prompt -> T5 embedding (zeros while the prompt encoder is not ported)
  seed frames -> condition latent (zero-padded chunk encode)
  warped buffers + masks -> per-buffer VAE latents (pose conditioning)
  -> EDM-Euler denoise with batched CFG -> VAE decode -> uint8 frames

Only the exact sampling path is ported (Euler, CFG on every step, no
step caching); the CLI refuses the JAX package's other sampling options.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from gen3c_tpu_torch.models.gen3c import Gen3CModel
from gen3c_tpu_torch.models.t5 import DummyT5TextEncoder
from gen3c_tpu_torch.utils import log


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def video_to_uint8(video: torch.Tensor) -> np.ndarray:
    """(B, 3, T, H, W) in [-1, 1] -> (T, H, W, 3) uint8 of batch entry 0,
    converted on the device (truncation, as the JAX package's astype)."""
    u8 = ((video[0] + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
    return u8.permute(1, 2, 3, 0).cpu().numpy()


@dataclasses.dataclass
class Gen3cPipeline:
    model: Gen3CModel
    guidance: float = 1.0
    num_steps: int = 35
    seed: int = 0

    def __post_init__(self):
        # zero text embeddings until the T5 encoder is ported
        self.text_encoder = DummyT5TextEncoder()
        # seconds of the last generate(): encode_condition, encode_warps,
        # denoise_steps (one per step), decode; and its final latent
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
    ) -> Tuple[np.ndarray, str]:
        """Generate one chunk: ((T, H, W, 3) uint8 frames, prompt)."""
        dev = self.model.device
        timings = {"denoise_steps": []}
        t5_emb = self._encode_prompt(prompt)
        neg_emb = self._encode_prompt(negative_prompt) if negative_prompt else None

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

        def on_step(i):
            synchronize(dev)
            now = time.perf_counter()
            timings["denoise_steps"].append(now - last[0])
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
            on_step=on_step,
        )
        del pose_latent
        t3 = time.perf_counter()
        video = self.model.decode(samples)
        frames_u8 = video_to_uint8(video)
        timings["decode"] = time.perf_counter() - t3
        self.last_timings = timings
        self.last_samples = samples
        log.info(f"denoise steps {['%.2f' % s for s in timings['denoise_steps']]}s, "
                 f"decode {timings['decode']:.2f}s")
        return frames_u8, prompt
