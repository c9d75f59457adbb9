"""World interpolator: the video between two key frames, PyTorch/CUDA CLI.

Port of gen3c_tpu/pipelines/world_interpolator.py (the reference's
world_interpolator.py): the condition location is "first_and_last_1", so
the first and the last latent frames are pinned to the two ends, each
encoded as its own zero-padded chunk, and the sampler fills the middle
with the reference interpolator's default solver, res2ab. The text
embeddings are zeros: as in the JAX package, ``--prompt`` is accepted and
not used.

Usage:
  python -m gen3c_tpu_torch.pipelines.world_interpolator \
      --first_image a.png --last_image b.png [--model_preset cosmos_v2w_tiny --device cpu]
  python -m gen3c_tpu_torch.pipelines.world_interpolator --input_video clip.mp4 \
      [--frame_stride 1] [--num_frame_pairs N]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from gen3c_tpu_torch.diffusion.sampler import arch_invariant_randn, generate_samples
from gen3c_tpu_torch.models.conditioner import (VideoExtendCondition,
                                                add_condition_video_indicator_and_input_mask)
from gen3c_tpu_torch.models.gen3c import dit_net_fns
from gen3c_tpu_torch.pipelines.gen3c_pipeline import video_to_uint8
from gen3c_tpu_torch.pipelines.text2world import T2W_PRESETS, build_model
from gen3c_tpu_torch.utils import io as io_utils
from gen3c_tpu_torch.utils import log
from gen3c_tpu_torch.utils.timing import synchronize


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Cosmos world interpolator (PyTorch/CUDA)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda = cuda:$LOCAL_RANK, cuda:N or cpu)")
    p.add_argument("--first_image", type=str, default=None)
    p.add_argument("--last_image", type=str, default=None)
    p.add_argument("--input_video", type=str, default=None,
                   help="interpolate between consecutive frame pairs of this video, chaining "
                        "the segments with one frame of overlap")
    p.add_argument("--num_frame_pairs", type=int, default=None,
                   help="pairs to process (default: frames // stride - 1)")
    p.add_argument("--frame_stride", type=int, default=1,
                   help="stride between the frames of each pair")
    p.add_argument("--model_preset", type=str, default="cosmos_v2w_7b",
                   choices=sorted(T2W_PRESETS))
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--prompt", type=str, default="",
                   help="accepted and not used: the interpolator's text embeddings are zeros")
    p.add_argument("--guidance", type=float, default=7.0)
    p.add_argument("--guidance_interval", type=float, nargs=2, default=None,
                   metavar=("SIGMA_LO", "SIGMA_HI"),
                   help="run CFG only on steps whose sigma lies in [LO, HI]")
    p.add_argument("--num_steps", type=int, default=35)
    p.add_argument("--solver", default="res2ab", choices=("euler", "dpm2m", "res2ab"),
                   help="the reference interpolator samples with the exponential-integrator "
                        "AB2 multistep (res2ab); euler and dpm2m for comparison")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--video_save_name", type=str, default="output")
    p.add_argument("--video_save_folder", type=str, default="outputs/")
    p.add_argument("--quantize_int8", action="store_true")
    p.add_argument("--quantize_w8a8", action="store_true")
    p.add_argument("--offload_diffusion_transformer", action="store_true",
                   help="accepted and ignored: the DiT stays on the device")
    return p


def demo(args, built: Optional[tuple] = None, record: Optional[dict] = None) -> str:
    """Run the CLI; returns the saved video's path. ``built`` is a (model,
    preset) pair to reuse; ``record`` receives the frames ("video") and
    each segment's denoise step seconds ("step_seconds")."""
    preset = T2W_PRESETS[args.model_preset]
    if preset.dit.in_channels < 17:
        raise ValueError("interpolation needs a v2w preset (17 input channels)")
    model, preset = built if built is not None else build_model(args, preset)
    h, w = preset.height, preset.width
    record = {} if record is None else record
    if args.input_video:
        # each (i * stride, i * stride + stride) frame pair, the segments
        # chained without their duplicated first frame
        video_in, _ = io_utils.read_video_bcthw(args.input_video, h, w)
        n_frames = video_in.shape[2]
        stride = args.frame_stride
        n_pairs = args.num_frame_pairs or max(n_frames // stride - 1, 1)
        segments = []
        for i in range(n_pairs):
            a, b = i * stride, i * stride + stride
            if b >= n_frames:
                break
            log.info(f"Processing frame pair {i + 1} / {n_pairs}...")
            seg = _interpolate_pair(model, preset, video_in[:, :, a:a + 1],
                                    video_in[:, :, b:b + 1], args, seed=args.seed + i,
                                    record=record)
            segments.append(seg if not segments else seg[1:])
        video = np.concatenate(segments, axis=0)
    else:
        if not (args.first_image and args.last_image):
            raise SystemExit("provide --input_video OR --first_image + --last_image")
        first = io_utils.read_image_bcthw(args.first_image, h, w)
        last = io_utils.read_image_bcthw(args.last_image, h, w)
        video = _interpolate_pair(model, preset, first, last, args, seed=args.seed,
                                  record=record)
    record["video"] = video
    path = os.path.join(args.video_save_folder, f"{args.video_save_name}.mp4")
    path = io_utils.save_video(video, args.fps, path)
    log.info(f"Saved interpolated video to {path}")
    return path


@torch.no_grad()
def _interpolate_pair(model, preset, first: np.ndarray, last: np.ndarray, args, seed: int,
                      record: Optional[dict] = None) -> np.ndarray:
    """One chunk pinned to ``first`` and ``last`` ((1, 3, 1, H, W) in [-1,
    1]) -> (T, H, W, 3) uint8."""
    C, T, Hl, Wl = preset.state_shape
    B = 1
    dev = model.device
    lat_first = model.create_condition_latent_from_input_frames(
        torch.from_numpy(np.ascontiguousarray(first)).to(dev), 1)
    lat_last = model.create_condition_latent_from_input_frames(
        torch.from_numpy(np.ascontiguousarray(last)).to(dev), 1)
    gt = torch.cat([lat_first[:, :, :1], lat_first.new_zeros((B, C, T - 2, Hl, Wl)),
                    lat_last[:, :, :1]], dim=2)
    cond = VideoExtendCondition(crossattn_emb=torch.zeros((B, 512, 1024), device=dev))
    cond = add_condition_video_indicator_and_input_mask(gt, cond, num_condition_t=1,
                                                        condition_location="first_and_last_1")
    init_noise = np.random.RandomState(seed).standard_normal((B, C, T, Hl, Wl)).astype(np.float32)
    synchronize(dev)
    seconds, last_t = [], [time.perf_counter()]

    def on_step(i, cfg, refresh):
        synchronize(dev)
        now = time.perf_counter()
        seconds.append(now - last_t[0])
        last_t[0] = now

    net_fn, _ = dit_net_fns(model.net, span=False)
    samples = generate_samples(
        net_fn,
        init_noise=torch.from_numpy(init_noise).to(dev),
        augment_noise=torch.from_numpy(arch_invariant_randn((B, C, T, Hl, Wl), seed)).to(dev),
        crossattn_cond=cond.crossattn_emb,
        crossattn_uncond=torch.zeros_like(cond.crossattn_emb),
        gt_latent=cond.gt_latent,
        condition_video_indicator=cond.condition_video_indicator,
        condition_video_input_mask=cond.condition_video_input_mask,
        num_steps=args.num_steps,
        guidance=args.guidance,
        schedule=model.schedule,
        guidance_interval=tuple(args.guidance_interval) if args.guidance_interval else None,
        solver=args.solver,
        on_step=on_step,
    )
    if record is not None:
        record.setdefault("step_seconds", []).append(seconds)
    return video_to_uint8(model.decode(samples))


def main(argv=None) -> str:
    return demo(create_parser().parse_args(argv))


if __name__ == "__main__":
    main()
