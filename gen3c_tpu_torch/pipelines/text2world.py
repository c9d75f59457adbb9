"""Text-to-world and video-to-world generation, PyTorch/CUDA CLI.

Port of gen3c_tpu/pipelines/text2world.py, the Cosmos-Predict1 entry
points GEN3C is built on, on the same single-stream GeneralDIT:

  * text2world: prompt -> T5 embedding (zeros without the prompt encoder)
    -> EDM denoise with CFG (default guidance 7) -> VAE decode -> a
    121-frame video; the DiT takes the 16 latent channels alone.
  * video2world: a seed image or video's last frames condition the first
    latent frames, replaced each step, and the DiT takes a 17th channel,
    the condition mask.

The presets are the 7B at full width (28 blocks x 4096, 32 x 128 heads,
bf16, 704x1280, 121 frames) and a tiny fp32 one; their RoPE is not
extrapolated in time (GEN3C's is, 2.0). With no checkpoint in
``--checkpoint_dir`` the weights are a seeded random init, as for GEN3C;
a checkpoint laid out as the factory reads it loads when it is there.

Usage:
  python -m gen3c_tpu_torch.pipelines.text2world --prompt "..." \
      [--model_preset cosmos_t2w_tiny --device cpu] [--solver dpm2m]
  python -m gen3c_tpu_torch.pipelines.text2world --mode video2world \
      --input_image_path img.png --prompt "..."
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from gen3c_tpu_torch.diffusion.sampler import arch_invariant_randn, generate_samples
from gen3c_tpu_torch.models.gen3c import dit_net_fns
from gen3c_tpu_torch.models.t5 import DummyT5TextEncoder
from gen3c_tpu_torch.pipelines import factory
from gen3c_tpu_torch.pipelines.factory import GEN3C_7B_PRESET, GEN3C_TINY_PRESET, Gen3CPreset
from gen3c_tpu_torch.pipelines.gen3c_pipeline import video_to_uint8
from gen3c_tpu_torch.utils import io as io_utils
from gen3c_tpu_torch.utils import log
from gen3c_tpu_torch.utils.timing import synchronize

# t2w: 16 latent channels in; v2w: + 1 condition-mask channel
COSMOS_T2W_7B = Gen3CPreset(
    name="cosmos_t2w_7b",
    dit=dataclasses.replace(GEN3C_7B_PRESET.dit, in_channels=16, rope_t_extrapolation_ratio=1.0),
    vae=GEN3C_7B_PRESET.vae,
    height=704,
    width=1280,
    chunk_size=121,
)
COSMOS_V2W_7B = dataclasses.replace(
    COSMOS_T2W_7B, name="cosmos_v2w_7b",
    dit=dataclasses.replace(COSMOS_T2W_7B.dit, in_channels=17))
COSMOS_T2W_TINY = dataclasses.replace(
    COSMOS_T2W_7B, name="cosmos_t2w_tiny",
    dit=dataclasses.replace(GEN3C_TINY_PRESET.dit, in_channels=16, rope_t_extrapolation_ratio=1.0),
    vae=GEN3C_TINY_PRESET.vae, height=96, width=160, chunk_size=9)
COSMOS_V2W_TINY = dataclasses.replace(
    COSMOS_T2W_TINY, name="cosmos_v2w_tiny",
    dit=dataclasses.replace(COSMOS_T2W_TINY.dit, in_channels=17))

T2W_PRESETS = {p.name: p for p in (COSMOS_T2W_7B, COSMOS_V2W_7B, COSMOS_T2W_TINY,
                                   COSMOS_V2W_TINY)}


@torch.no_grad()
def generate_world(
    model,
    preset: Gen3CPreset,
    t5_embeddings,  # (1, 512, 1024), numpy or tensor
    guidance: float = 7.0,
    num_steps: int = 35,
    seed: int = 1,
    neg_t5_embeddings=None,
    condition_latent: Optional[torch.Tensor] = None,  # video2world: (1, 16, T', H', W')
    num_condition_t: int = 0,
    step_cache_interval: int = 1,
    step_cache_threshold: float = 0.0,
    solver: str = "euler",
    guidance_interval=None,
    on_step=None,
) -> np.ndarray:
    """The t2w / v2w denoise and decode; returns (T, H, W, 3) uint8.

    Without a condition latent the condition region is empty (zeros); a
    short one is zero-padded to the chunk's latent frames. The indicator
    marks the first num_condition_t latent frames, and only a v2w net
    (17 input channels) also gets it as its input mask. The initial noise
    is numpy's RandomState(seed), the condition's augment noise
    ``arch_invariant_randn`` of the same seed."""
    dev = model.device
    state_shape = tuple(preset.state_shape)
    B = 1
    C, T, Hl, Wl = state_shape
    is_v2w = preset.dit.in_channels > 16
    if condition_latent is None:
        condition_latent = torch.zeros((B, C, T, Hl, Wl), dtype=torch.float32, device=dev)
    elif condition_latent.shape[2] < T:
        pad = T - condition_latent.shape[2]
        condition_latent = torch.cat([condition_latent, condition_latent.new_zeros(
            condition_latent.shape[:2] + (pad,) + condition_latent.shape[3:])], dim=2)
    indicator = torch.zeros((1, 1, T, 1, 1), dtype=torch.float32, device=dev)
    indicator[:, :, :num_condition_t] = 1.0
    in_mask = indicator.expand(B, 1, T, Hl, Wl) if is_v2w else None
    init_noise = np.random.RandomState(seed).standard_normal((B,) + state_shape).astype(np.float32)
    emb = torch.as_tensor(np.asarray(t5_embeddings), dtype=torch.float32).to(dev)
    neg = (torch.zeros_like(emb) if neg_t5_embeddings is None
           else torch.as_tensor(np.asarray(neg_t5_embeddings), dtype=torch.float32).to(dev))
    net_fn, _ = dit_net_fns(model.net, span=False)
    samples = generate_samples(
        net_fn,
        init_noise=torch.from_numpy(init_noise).to(dev),
        augment_noise=torch.from_numpy(arch_invariant_randn((B,) + state_shape, seed)).to(dev),
        crossattn_cond=emb,
        crossattn_uncond=neg,
        gt_latent=condition_latent,
        condition_video_indicator=indicator,
        condition_video_input_mask=in_mask,
        num_steps=num_steps,
        guidance=guidance,
        schedule=model.schedule,
        step_cache_interval=step_cache_interval,
        step_cache_threshold=step_cache_threshold,
        solver=solver,
        guidance_interval=(tuple(float(v) for v in guidance_interval)
                           if guidance_interval else None),
        on_step=on_step,
    )
    return video_to_uint8(model.decode(samples))


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Cosmos text2world / video2world (PyTorch/CUDA)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda = cuda:$LOCAL_RANK, cuda:N or cpu)")
    p.add_argument("--mode", choices=["text2world", "video2world"], default="text2world")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--model_preset", type=str, default=None, choices=sorted(T2W_PRESETS))
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--input_image_path", type=str, default=None)
    p.add_argument("--num_input_frames", type=int, default=1)
    p.add_argument("--solver", default="euler", choices=("euler", "dpm2m", "res2ab"),
                   help="denoise integration rule at equal network cost")
    p.add_argument("--step_cache_interval", type=int, default=1,
                   help="> 1: run the DiT every Nth step after a 2-step warmup and before "
                        "a 2-step tail, reusing its output between")
    p.add_argument("--step_cache_threshold", type=float, default=0.0,
                   help="> 0: adaptive step caching; overrides --step_cache_interval")
    p.add_argument("--guidance", type=float, default=7.0)
    p.add_argument("--num_steps", type=int, default=35)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--seed", type=int, default=1)
    factory.add_prompt_encoder_flags(p)
    p.add_argument("--video_save_name", type=str, default="output")
    p.add_argument("--video_save_folder", type=str, default="outputs/")
    p.add_argument("--quantize_int8", action="store_true",
                   help="int8 weight-only DiT (dequantized bf16 matmuls)")
    p.add_argument("--quantize_w8a8", action="store_true",
                   help="int8 DiT weights and per-token int8 activations (kernels K7q + K7)")
    p.add_argument("--offload_diffusion_transformer", action="store_true",
                   help="accepted and ignored: the DiT stays on the device")
    p.add_argument("--offload_tokenizer", action="store_true",
                   help="accepted and ignored: the VAE stays on the device")
    p.add_argument("--attn_temporal_window", type=int, default=None,
                   help="band self-attention (kernel K3): each latent frame attends to "
                        "frames within +/- N plus the first")
    return p


def build_model(args, preset: Gen3CPreset):
    """The model the flags ask for on ``args.device``; the offload flags are
    logged as ignored (the 7B stays resident: offload is not ported)."""
    for flag, what in (("offload_diffusion_transformer", "the DiT"),
                       ("offload_tokenizer", "the VAE")):
        if getattr(args, flag, False):
            log.info(f"--{flag}: ignored, {what} stays on the device (offload is not ported)")
    quantize = "w8a8" if args.quantize_w8a8 else ("int8" if args.quantize_int8 else False)
    model, preset = factory.build_gen3c_model(
        preset, device=args.device, seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        quantize=quantize, attn_temporal_window=getattr(args, "attn_temporal_window", None))
    args.device = str(model.device)
    return model, preset


def demo(args, built: Optional[tuple] = None, record: Optional[dict] = None) -> str:
    """Run the CLI; returns the saved video's path. ``built`` is a (model,
    preset) pair to reuse; ``record`` receives the frames ("video", uint8
    (T, H, W, 3)) and each denoise step's seconds and kind ("steps")."""
    preset_name = args.model_preset or (
        "cosmos_t2w_7b" if args.mode == "text2world" else "cosmos_v2w_7b")
    model, preset = built if built is not None else build_model(args, T2W_PRESETS[preset_name])
    enc = factory.build_text_encoder(args, model.device) or DummyT5TextEncoder()
    emb, _ = enc.encode_prompts(args.prompt)
    neg = enc.encode_prompts(args.negative_prompt)[0] if args.negative_prompt else None

    condition_latent, num_condition_t = None, 0
    if args.mode == "video2world":
        if not args.input_image_path:
            raise ValueError("video2world needs --input_image_path (image or video)")
        ext = args.input_image_path.rsplit(".", 1)[-1].lower()
        if ext in ("mp4", "mov", "avi", "gif", "webm"):
            frames, _ = io_utils.read_video_bcthw(args.input_image_path, preset.height,
                                                  preset.width)
            frames = frames[:, :, -args.num_input_frames:]
        else:
            frames = io_utils.read_image_bcthw(args.input_image_path, preset.height, preset.width)
        condition_latent = model.create_condition_latent_from_input_frames(
            torch.from_numpy(np.ascontiguousarray(frames)).to(model.device),
            num_frames_condition=frames.shape[2])
        num_condition_t = model.compute_num_latent_frames(frames.shape[2])

    record = {} if record is None else record
    steps = record.setdefault("steps", [])
    synchronize(model.device)
    last = [time.perf_counter()]

    def on_step(i, cfg, refresh):
        synchronize(model.device)
        now = time.perf_counter()
        steps.append({"seconds": now - last[0], "cfg": cfg, "refresh": refresh})
        last[0] = now

    video = generate_world(
        model, preset, emb, guidance=args.guidance,
        guidance_interval=getattr(args, "guidance_interval", None), num_steps=args.num_steps,
        seed=args.seed, neg_t5_embeddings=neg, condition_latent=condition_latent,
        num_condition_t=num_condition_t, step_cache_interval=args.step_cache_interval,
        step_cache_threshold=args.step_cache_threshold, solver=args.solver, on_step=on_step)
    record["video"] = video
    path = os.path.join(args.video_save_folder, f"{args.video_save_name}.mp4")
    path = io_utils.save_video(video, args.fps, path)
    log.info(f"Saved video to {path}")
    return path


def main(argv=None) -> str:
    return demo(create_parser().parse_args(argv))


if __name__ == "__main__":
    main()
