"""Multiview text-to-world / video-to-world generation (Sample-AV), PyTorch/CUDA CLI.

Port of gen3c_tpu/pipelines/text2world_multiview.py: one diffusion pass of
the multiview DiT (``models.dit_multiview``) yields V synchronized camera
views, stacked on the latent-T axis, each view with its own prompt (the
per-view T5 embeddings concatenated on the context axis). CFG's negative
condition is the frame-repeat embedding: the conditioned rows get 0, the
unconditioned rows frame_repeat_negative_condition / 10 (the
conditioner's scaling), with zero text. video2world conditions the first
latent frame of every view on one seed image. Each view is decoded on its
own by the GEN3C CV8x8x8 tokenizer, whose chunk is the preset's frames.

The presets are the Sample-AV 7B (28 blocks x 4096, 32 x 128 heads, bf16,
6 views, 57 frames a view at 480x848: 76,320 tokens) at 16 / 17 input
channels, and a tiny fp32 one with 3 views. The DiT loads from
``<checkpoint_dir>/gen3c_tpu/<preset>.npz`` (gen3c_tpu's tree, e.g. from
``models.convert.convert_multiview_dit_state_dict`` and
``utils.checkpoint.save_params_npz``), else it is a seeded random init.

Usage:
  python -m gen3c_tpu_torch.pipelines.text2world_multiview --prompt "..." \\
      --prompt_left "..." [--model_preset cosmos_t2w_mv_tiny --device cpu]
  python -m gen3c_tpu_torch.pipelines.text2world_multiview --mode video2world \\
      --input_image_path img.png
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from gen3c_tpu_torch.bridge import multiview_state_from_jax
from gen3c_tpu_torch.diffusion.sampler import (
    arch_invariant_randn,
    generate_samples,
    guidance_interval_steps,
)
from gen3c_tpu_torch.diffusion.scheduler import EDMEulerSchedule
from gen3c_tpu_torch.models.dit_multiview import (
    FADITV2_MULTIVIEW_7B,
    MultiviewDiTConfig,
    MultiviewGeneralDIT,
)
from gen3c_tpu_torch.models.vae import VAEConfig, VideoTokenizer
from gen3c_tpu_torch.pipelines import factory
from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET, GEN3C_TINY_PRESET
from gen3c_tpu_torch.training.train import build_net
from gen3c_tpu_torch.utils import checkpoint as ckpt
from gen3c_tpu_torch.utils import io as io_utils
from gen3c_tpu_torch.utils import log
from gen3c_tpu_torch.utils.timing import synchronize

VIEW_NAMES = ("front", "left", "right", "back", "back_left", "back_right")

DEFAULT_PROMPTS = {
    "front": "The video is captured from a camera mounted on a car. The "
             "camera is facing forward.",
    "left": "The video is captured from a camera mounted on a car. The "
            "camera is facing to the left.",
    "right": "The video is captured from a camera mounted on a car. The "
             "camera is facing to the right.",
    "back": "The video is captured from a camera mounted on a car. The "
            "camera is facing backwards.",
    "back_left": "The video is captured from a camera mounted on a car. "
                 "The camera is facing the rear left side.",
    "back_right": "The video is captured from a camera mounted on a car. "
                  "The camera is facing the rear right side.",
}


@dataclasses.dataclass(frozen=True)
class MultiviewPreset:
    name: str
    dit: MultiviewDiTConfig
    vae: VAEConfig
    height: int = 480
    width: int = 848
    num_video_frames: int = 57  # per view

    @property
    def state_shape(self):
        """The latent (C, V*T', H', W'): views stacked on the frame axis."""
        lat_t = (self.num_video_frames - 1) // self.vae.temporal_compression + 1
        return (self.vae.latent_channels, self.dit.n_views * lat_t,
                self.height // self.vae.spatial_compression,
                self.width // self.vae.spatial_compression)


MV_T2W_7B = MultiviewPreset(name="cosmos_t2w_mv_7b",
                            dit=dataclasses.replace(FADITV2_MULTIVIEW_7B, in_channels=16),
                            vae=GEN3C_7B_PRESET.vae)
MV_V2W_7B = dataclasses.replace(MV_T2W_7B, name="cosmos_v2w_mv_7b",
                                dit=dataclasses.replace(MV_T2W_7B.dit, in_channels=17))
MV_T2W_TINY = MultiviewPreset(
    name="cosmos_t2w_mv_tiny",
    dit=MultiviewDiTConfig(in_channels=16, model_channels=64, num_blocks=1, num_heads=2,
                           adaln_lora_dim=8, n_views=3, view_condition_dim=3,
                           add_repeat_frame_embedding=True, dtype=torch.float32),
    vae=GEN3C_TINY_PRESET.vae, height=32, width=48, num_video_frames=9)
MV_V2W_TINY = dataclasses.replace(MV_T2W_TINY, name="cosmos_v2w_mv_tiny",
                                  dit=dataclasses.replace(MV_T2W_TINY.dit, in_channels=17))

MV_PRESETS = {p.name: p for p in (MV_T2W_7B, MV_V2W_7B, MV_T2W_TINY, MV_V2W_TINY)}


@dataclasses.dataclass
class MultiviewModel:
    """The multiview DiT and the tokenizer; latents scaled by sigma_data."""

    net: MultiviewGeneralDIT
    tokenizer: VideoTokenizer
    sigma_data: float = 0.5

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def encode(self, state: torch.Tensor) -> torch.Tensor:
        return self.tokenizer.encode(state) * self.sigma_data

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        return self.tokenizer.decode(latent / self.sigma_data)


def build_model(preset: MultiviewPreset, device="cuda", seed: int = 1,
                checkpoint_dir: Optional[str] = None) -> MultiviewModel:
    """The preset's model on ``device``: the GEN3C tokenizer of its size
    (``factory.build_tokenizer``, chunk = the preset's frames), and the
    multiview DiT from ``<checkpoint_dir>/gen3c_tpu/<preset>.npz`` or a
    random init from ``seed`` (with a warning)."""
    device = factory.resolve_device(device)
    gen3c = GEN3C_TINY_PRESET if "tiny" in preset.name else GEN3C_7B_PRESET
    tokenizer = factory.build_tokenizer(
        dataclasses.replace(gen3c, vae=preset.vae, height=preset.height, width=preset.width,
                            chunk_size=preset.num_video_frames),
        device, checkpoint_dir=checkpoint_dir)
    native = os.path.join(checkpoint_dir or "", "gen3c_tpu", f"{preset.name}.npz")
    if checkpoint_dir and os.path.isfile(native):
        with torch.device("meta"):
            net = MultiviewGeneralDIT(preset.dit)
        net = net.to_empty(device=device)
        net.load_state_dict(multiview_state_from_jax(ckpt.load_params_npz_tree(native)))
        log.info(f"loaded multiview DiT weights from {native}")
    else:
        log.warning(f"multiview DiT running with RANDOM-INIT weights (no {native}; convert a "
                    "Sample-AV checkpoint with models.convert.convert_multiview_dit_state_dict "
                    "and save it there) - output will be noise")
        net = build_net(preset.dit, device, seed)
    return MultiviewModel(net=net.eval(), tokenizer=tokenizer)


@torch.no_grad()
def generate_multiview_world(
    model: MultiviewModel,
    preset: MultiviewPreset,
    t5_embeddings,  # (1, V*M, 1024): the views' embeddings concatenated, numpy or tensor
    guidance: float = 7.0,
    guidance_interval=None,
    num_steps: int = 35,
    seed: int = 1,
    frame_repeat_negative_condition: float = 10.0,
    condition_latent: Optional[torch.Tensor] = None,  # v2w: (1, 16, T', H', W')
    num_condition_t: int = 1,
    step_cache_interval: int = 1,
    step_cache_threshold: float = 0.0,
    on_step: Optional[Callable[[int, bool, bool], None]] = None,
    record: Optional[dict] = None,
) -> List[np.ndarray]:
    """One multiview diffusion pass -> V videos (T, H, W, 3) uint8.

    A v2w net conditions the first num_condition_t latent frames of every
    view on condition_latent. The initial noise is numpy's
    RandomState(seed), the augment noise ``arch_invariant_randn`` of the
    same seed. ``record`` receives the final latent ("latent", on the CPU)
    and each view's decode seconds ("decode_seconds").

    A guidance interval that leaves a step out raises ValueError before
    any forward: the frame-repeat condition always has the CFG pair's 2
    rows, so a condition-only step (batch 1) cannot take it; gen3c_tpu
    fails on the same input inside its first such step."""
    cfg = preset.dit
    dev = model.device
    V = cfg.n_views
    C, VT, Hl, Wl = preset.state_shape
    Tl = VT // V
    state = (1, C, VT, Hl, Wl)
    schedule = EDMEulerSchedule()
    if guidance_interval is not None and guidance_interval_steps(
            schedule, num_steps, guidance_interval) != (0, num_steps):
        raise ValueError(
            f"guidance_interval {tuple(guidance_interval)} leaves some of the {num_steps} steps "
            "condition-only, and the multiview net's frame-repeat condition always carries the "
            "CFG pair's 2 rows (a condition-only step runs batch 1); gen3c_tpu fails on the "
            "same input. Use no interval, or one that holds every step's sigma")

    is_v2w = cfg.in_channels > 16
    gt = torch.zeros(state, dtype=torch.float32, device=dev)
    indicator = torch.zeros((1, 1, VT, 1, 1), dtype=torch.float32, device=dev)
    if is_v2w and condition_latent is not None:
        cond = condition_latent[:, :, :num_condition_t].float().to(dev)
        for v in range(V):
            gt[:, :, v * Tl:v * Tl + cond.shape[2]] = cond
            indicator[:, :, v * Tl:v * Tl + cond.shape[2]] = 1.0
    in_mask = indicator.expand(1, 1, VT, Hl, Wl) if is_v2w else None
    frame_repeat = torch.cat([
        torch.zeros((1, V), dtype=torch.float32, device=dev),
        torch.full((1, V), frame_repeat_negative_condition / 10.0, dtype=torch.float32,
                   device=dev)])

    def net_fn(x_in, t_in, ctx):
        return model.net(x_in, t_in, ctx, fps=24.0, frame_repeat=frame_repeat)

    emb = torch.as_tensor(np.asarray(t5_embeddings), dtype=torch.float32).to(dev)
    init_noise = np.random.RandomState(seed).standard_normal(state).astype(np.float32)
    samples = generate_samples(
        net_fn,
        init_noise=torch.from_numpy(init_noise).to(dev),
        augment_noise=torch.from_numpy(arch_invariant_randn(state, seed)).to(dev),
        crossattn_cond=emb,
        crossattn_uncond=torch.zeros_like(emb),
        gt_latent=gt,
        condition_video_indicator=indicator,
        condition_video_input_mask=in_mask,
        num_steps=num_steps,
        guidance=guidance,
        schedule=schedule,
        step_cache_interval=step_cache_interval,
        step_cache_threshold=step_cache_threshold,
        on_step=on_step,
    )
    record = {} if record is None else record
    record["latent"] = samples.cpu()
    seconds = record.setdefault("decode_seconds", [])
    videos = []
    for v in range(V):
        synchronize(dev)
        t0 = time.perf_counter()
        vid = model.decode(samples[:, :, v * Tl:(v + 1) * Tl])[0]
        u8 = ((vid + 1) / 2 * 255).clamp(0, 255).to(torch.uint8).permute(1, 2, 3, 0)
        videos.append(u8.cpu().numpy())
        seconds.append(time.perf_counter() - t0)
    return videos


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Multiview text2world / video2world (Sample-AV, "
                                            "PyTorch/CUDA)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda = cuda:$LOCAL_RANK, cuda:N or cpu)")
    p.add_argument("--mode", choices=["text2world", "video2world"], default="text2world")
    p.add_argument("--model_preset", type=str, default="cosmos_t2w_mv_7b",
                   choices=sorted(MV_PRESETS))
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    for name in VIEW_NAMES:
        flag = "--prompt" if name == "front" else f"--prompt_{name}"
        p.add_argument(flag, type=str, default=DEFAULT_PROMPTS[name])
    p.add_argument("--input_image_path", type=str, default=None,
                   help="video2world: seed image for every view's frame 0")
    p.add_argument("--guidance", type=float, default=7.0)
    p.add_argument("--guidance_interval", type=float, nargs=2, default=None,
                   metavar=("SIGMA_LO", "SIGMA_HI"),
                   help="must hold every step's sigma: the frame-repeat negative condition "
                        "has no condition-only form (see generate_multiview_world)")
    p.add_argument("--num_steps", type=int, default=35)
    p.add_argument("--frame_repeat_negative_condition", type=float, default=10.0)
    p.add_argument("--step_cache_interval", type=int, default=1)
    p.add_argument("--step_cache_threshold", type=float, default=0.0,
                   help="> 0: adaptive step caching; overrides --step_cache_interval")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--disable_prompt_encoder", action="store_true", default=True)
    p.add_argument("--enable_prompt_encoder", dest="disable_prompt_encoder",
                   action="store_false",
                   help="encode the prompts with T5-11B from <checkpoint_dir>/google-t5/t5-11b "
                        "or the local Hugging Face cache (needs transformers); default: zeros")
    p.add_argument("--video_save_folder", type=str, default="outputs/")
    p.add_argument("--video_save_name", type=str, default="multiview")
    p.add_argument("--fps", type=int, default=24)
    return p


def resolve_preset(args) -> MultiviewPreset:
    """The preset the flags name; video2world takes the v2w one."""
    preset = MV_PRESETS[args.model_preset]
    if args.mode == "video2world" and not preset.dit.in_channels > 16:
        preset = MV_PRESETS[preset.name.replace("t2w", "v2w")]
    return preset


def demo(args, built: Optional[MultiviewModel] = None, record: Optional[dict] = None
         ) -> List[str]:
    """Run the CLI; returns the saved videos' paths, one a view. ``built``
    is a MultiviewModel of the resolved preset to reuse; ``record``
    receives the views' frames ("videos"), each denoise step's seconds and
    kind ("steps") and what ``generate_multiview_world`` records."""
    preset = resolve_preset(args)
    V = preset.dit.n_views
    model = built if built is not None else build_model(
        preset, args.device, seed=args.seed, checkpoint_dir=args.checkpoint_dir)
    args.device = str(model.device)
    prompts = [getattr(args, "prompt" if n == "front" else f"prompt_{n}")
               for n in VIEW_NAMES[:V]]
    enc = factory.build_text_encoder(args, model.device)
    if enc is None:
        t5 = np.zeros((1, V * 512, 1024), np.float32)
    else:
        t5 = np.concatenate([enc.encode_prompts(pr)[0] for pr in prompts], axis=1)

    condition_latent = None
    if args.mode == "video2world":
        if not args.input_image_path:
            raise ValueError("video2world needs --input_image_path")
        img = io_utils.read_image_bcthw(args.input_image_path, preset.height, preset.width)
        pad = np.concatenate([img] + [np.zeros_like(img)] * (preset.num_video_frames - 1), axis=2)
        condition_latent = model.encode(torch.from_numpy(pad).to(model.device))

    log.info(f"multiview {args.mode}: {V} views x {preset.num_video_frames} frames @ "
             f"{preset.width}x{preset.height}")
    record = {} if record is None else record
    steps = record.setdefault("steps", [])
    synchronize(model.device)
    last = [time.perf_counter()]

    def on_step(i, cfg, refresh):
        synchronize(model.device)
        now = time.perf_counter()
        steps.append({"seconds": now - last[0], "cfg": cfg, "refresh": refresh})
        last[0] = now

    videos = generate_multiview_world(
        model, preset, t5, guidance=args.guidance, guidance_interval=args.guidance_interval,
        num_steps=args.num_steps, seed=args.seed,
        frame_repeat_negative_condition=args.frame_repeat_negative_condition,
        condition_latent=condition_latent, step_cache_interval=args.step_cache_interval,
        step_cache_threshold=args.step_cache_threshold, on_step=on_step, record=record)
    record["videos"] = videos
    os.makedirs(args.video_save_folder, exist_ok=True)
    paths = []
    for name, vid in zip(VIEW_NAMES[:V], videos):
        out = os.path.join(args.video_save_folder, f"{args.video_save_name}_{name}")
        paths.append(io_utils.save_video(vid, args.fps, out))
        log.info(f"saved {name} view -> {paths[-1]}")
    return paths


def main(argv=None) -> List[str]:
    return demo(create_parser().parse_args(argv))


if __name__ == "__main__":
    main()
