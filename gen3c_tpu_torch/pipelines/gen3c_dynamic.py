"""Dynamic-scene video-to-video generation (GEN3C), PyTorch/CUDA CLI.

Port of gen3c_tpu/pipelines/gen3c_dynamic.py: a video with per-frame depth
and poses (a ViPE clip, a packaged .npz/.pt file or a distributed
directory) -> ``Cache4D`` (one cache frame per video frame, never updated:
the depth of every frame is known) -> generation along a preset camera
trajectory, chunked 121*N-1 frames with one frame of overlap, target
frame t rendered from video frame t. The flag names are the JAX CLI's,
plus ``--device``; every --parallel strategy runs, one process per rank
under ``torchrun``.

Usage:
  python -m gen3c_tpu_torch.pipelines.gen3c_dynamic \
      --input_video_path clip.npz --trajectory left --device cuda \
      [--foreground_masking] [--model_preset gen3c_tiny] [--perf_preset fast]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch

from gen3c_tpu_torch.cache import Cache4D
from gen3c_tpu_torch.ops.camera import CAMERA_ROTATIONS, TRAJECTORY_TYPES, generate_camera_trajectory
from gen3c_tpu_torch.parallel.mesh import process_rank
from gen3c_tpu_torch.pipelines import data_loaders, factory
from gen3c_tpu_torch.pipelines.chunked import compose_buffer_video, run_chunked_generation
from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline
from gen3c_tpu_torch.utils import log
from gen3c_tpu_torch.utils.io import IncrementalVideoSaver


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GEN3C dynamic video (PyTorch/CUDA)")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--model_preset", type=str, default="gen3c_7b", choices=sorted(factory.PRESETS))
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--vipe_path", type=str, default=None)
    p.add_argument("--vipe_starting_frame_idx", type=int, default=0)
    p.add_argument("--input_video_path", type=str, default=None,
                   help="distributed dir / packaged .pt or .npz")
    p.add_argument("--video_save_name", type=str, default="output")
    p.add_argument("--solver", default="euler", choices=("euler", "dpm2m", "res2ab"),
                   help="denoise integration rule at equal network cost (multistep: "
                        "dpm2m, res2ab; not with step caching)")
    p.add_argument("--video_save_folder", type=str, default="outputs/")
    p.add_argument("--guidance", type=float, default=1.0)
    p.add_argument("--num_steps", type=int, default=35)
    p.add_argument("--num_video_frames", type=int, default=121)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--seed", type=int, default=1)
    factory.add_prompt_encoder_flags(p)
    p.add_argument("--trajectory", type=str, default="none", choices=sorted(TRAJECTORY_TYPES))
    p.add_argument("--camera_rotation", type=str, default="center_facing",
                   choices=sorted(CAMERA_ROTATIONS))
    p.add_argument("--movement_distance", type=float, default=0.3)
    p.add_argument("--filter_points_threshold", type=float, default=0.05)
    p.add_argument("--foreground_masking", action="store_true",
                   help="cull splatted pixels behind the depth-boundary mesh (kernel K6)")
    p.add_argument("--save_buffer", action="store_true")
    factory.add_perf_flags(p)
    return p


def load_scene(args, preset, device) -> Tuple[Cache4D, torch.Tensor, torch.Tensor, np.ndarray]:
    """The clip the flags name as a Cache4D on ``device``, the camera
    trajectory (1, T, 4, 4) and (1, T, 3, 3), and the seed frame (1, 3, 1,
    H, W) in [-1, 1]."""
    if args.vipe_path is not None:
        image, depth, mask, w2c, k = data_loaders.load_vipe_data(
            args.vipe_path, starting_frame_idx=args.vipe_starting_frame_idx,
            resize_hw=(preset.height + 16, preset.width), crop_hw=(preset.height, preset.width),
            num_frames=args.num_video_frames)
    elif args.input_video_path:
        image, depth, mask, w2c, k = data_loaders.load_data_auto_detect(args.input_video_path)
    else:
        raise ValueError("need --vipe_path or --input_video_path")
    n = min(len(image), args.num_video_frames)
    cache = Cache4D(
        input_image=torch.from_numpy(image[:n]),
        input_depth=torch.from_numpy(depth[:n]),
        input_mask=torch.from_numpy(mask[:n]) if mask is not None else None,
        input_w2c=torch.from_numpy(w2c[:n]),
        input_intrinsics=torch.from_numpy(k[:n]),
        input_format=["F", "C", "H", "W"],
        filter_points_threshold=args.filter_points_threshold,
        foreground_masking=args.foreground_masking,
        device=device,
    )
    w2cs, ks = generate_camera_trajectory(
        trajectory_type=args.trajectory, initial_w2c=w2c[0], initial_intrinsics=k[0],
        num_frames=args.num_video_frames, movement_distance=args.movement_distance,
        camera_rotation=args.camera_rotation, center_depth=1.0, device=device)
    seed_frames = image[0:1].astype(np.float32)[None].transpose(1, 2, 0, 3, 4)
    return cache, w2cs, ks, seed_frames


def demo(args, built: Optional[tuple] = None, record: Optional[dict] = None) -> str:
    """Run the CLI; returns the path of the saved video. ``built`` is a
    (model, preset) pair from ``factory.build_from_args`` on the same flags,
    to reuse a model already on the device; ``record`` receives
    ``run_chunked_generation``'s seconds per chunk ("render", "update",
    "generate"), the last chunk's ``pipeline.last_timings`` ("pipeline")
    and the frames saved ("video", uint8 (T, H, W', 3))."""
    factory.apply_perf_preset(args)
    model, preset = built if built is not None else factory.build_from_args(args)
    factory.validate_num_frames(args.num_video_frames, preset.chunk_size)
    pipeline = Gen3cPipeline(
        model=model, text_encoder=factory.build_text_encoder(args, model.device),
        guidance=args.guidance, num_steps=args.num_steps, seed=args.seed,
        step_cache_interval=args.step_cache_interval,
        guidance_interval=tuple(args.guidance_interval) if args.guidance_interval else None,
        cfg_rescale=args.cfg_rescale, solver=args.solver)
    cache, w2cs, ks, seed_frames = load_scene(args, preset, torch.device(args.device))
    record = {} if record is None else record
    saver = IncrementalVideoSaver(args.fps)
    video, all_warps = run_chunked_generation(
        pipeline, cache, w2cs, ks, seed_frames, prompt=args.prompt,
        negative_prompt=args.negative_prompt or None,
        update_cache_with_depth=None,  # the depth of every frame is known
        use_start_frame_idx=True, save_buffer=args.save_buffer, timings=record,
        on_chunk=(None if args.save_buffer or process_rank() != 0
                  else lambda done, total, v: saver.update(v)))
    record["pipeline"] = pipeline.last_timings
    final = compose_buffer_video(video, all_warps, preset.height, preset.width)
    record["video"] = final
    if process_rank() != 0:  # every rank holds the video; rank 0 writes it
        return ""
    save_path = saver.save(final, os.path.join(args.video_save_folder,
                                               f"{args.video_save_name}.mp4"))
    log.info(f"Saved video to {save_path}")
    return save_path


if __name__ == "__main__":
    demo(create_parser().parse_args())
