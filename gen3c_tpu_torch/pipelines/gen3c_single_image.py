"""Single image -> camera-controlled video (GEN3C), PyTorch/CUDA CLI.

Port of gen3c_tpu/pipelines/gen3c_single_image.py: image -> depth -> 3D
cache -> preset trajectory -> chunked autoregressive generation (121*N-1
frames, one frame of overlap, cache updated from the re-estimated depth of
each chunk's last frame) -> video file. The flag names are the JAX CLI's;
a flag whose feature is not ported raises NotImplementedError.

Usage:
  python -m gen3c_tpu_torch.pipelines.gen3c_single_image \
      --input_image_path image.png --trajectory left --device cuda \
      [--model_preset gen3c_tiny]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gen3c_tpu.utils import io as io_utils
from gen3c_tpu_torch.cache.cache3d import Cache3DBuffer
from gen3c_tpu_torch.ops.camera import CAMERA_ROTATIONS, TRAJECTORY_TYPES, generate_camera_trajectory
from gen3c_tpu_torch.pipelines.chunked import compose_buffer_video, run_chunked_generation
from gen3c_tpu_torch.pipelines.depth import make_depth_estimator
from gen3c_tpu_torch.pipelines.factory import PRESETS, build_gen3c_model
from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline
from gen3c_tpu_torch.utils import log


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GEN3C single-image (PyTorch/CUDA)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--model_preset", type=str, default="gen3c_7b", choices=sorted(PRESETS))
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--input_image_path", type=str, required=True)
    p.add_argument("--video_save_name", type=str, default="output")
    p.add_argument("--video_save_folder", type=str, default="outputs/")
    p.add_argument("--guidance", type=float, default=1.0)
    p.add_argument("--guidance_interval", type=float, nargs=2, default=None,
                   metavar=("SIGMA_LO", "SIGMA_HI"), help="not ported yet")
    p.add_argument("--perf_preset", choices=["exact", "fast"], default="exact",
                   help="only 'exact' is ported")
    p.add_argument("--cfg_rescale", type=float, default=0.0, help="> 0 not ported yet")
    p.add_argument("--num_steps", type=int, default=35)
    p.add_argument("--solver", default="euler", choices=("euler", "dpm2m", "res2ab"),
                   help="only euler is ported")
    p.add_argument("--step_cache_interval", type=int, default=1, help="> 1 not ported yet")
    p.add_argument("--step_cache_block_span", type=int, nargs=2, default=None,
                   metavar=("LO", "HI"), help="not ported yet")
    p.add_argument("--step_cache_span_dtype", type=str, default="bf16",
                   choices=["bf16", "int8"], help="not ported yet")
    p.add_argument("--step_cache_threshold", type=float, default=0.0, help="> 0 not ported yet")
    p.add_argument("--attn_temporal_window", type=int, default=None,
                   help="band attention (kernel K3), not ported yet")
    p.add_argument("--cp_attn", type=str, default=None,
                   choices=["allgather", "ring", "ulysses"], help="not ported yet")
    p.add_argument("--num_video_frames", type=int, default=121,
                   help="(N-1) %% (chunk-1) must be 0")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--t5_backend", type=str, default="jax", choices=["jax", "torch"],
                   help="used only with the prompt encoder, which is not ported yet")
    p.add_argument("--disable_prompt_encoder", action="store_true", default=True)
    p.add_argument("--enable_prompt_encoder", dest="disable_prompt_encoder",
                   action="store_false", help="not ported yet")
    p.add_argument("--trajectory", type=str, default="left", choices=sorted(TRAJECTORY_TYPES))
    p.add_argument("--camera_rotation", type=str, default="center_facing",
                   choices=sorted(CAMERA_ROTATIONS))
    p.add_argument("--movement_distance", type=float, default=0.3)
    p.add_argument("--noise_aug_strength", type=float, default=0.0)
    p.add_argument("--frame_buffer_max", type=int, default=2)
    p.add_argument("--filter_points_threshold", type=float, default=0.05)
    p.add_argument("--foreground_masking", action="store_true", help="not ported yet")
    p.add_argument("--save_buffer", action="store_true")
    p.add_argument("--batch_input_path", type=str, default=None,
                   help="JSONL with one {\"prompt\",\"visual_input\"} per line")
    p.add_argument("--depth_source", type=str, default="auto",
                   choices=["auto", "moge", "file", "heuristic"])
    p.add_argument("--depth_path", type=str, default=None)
    p.add_argument("--parallel", type=str, default="cp", help="multi-device: not ported yet")
    p.add_argument("--num_devices", "--num_gpus", type=int, default=1, dest="num_devices",
                   help="> 1 not ported yet")
    # offload flags of the reference CLI; the text-encoder, upsampler and
    # guardrail ones change nothing here (as in the JAX package)
    for flag in ("offload_diffusion_transformer", "offload_tokenizer",
                 "offload_text_encoder_model", "offload_prompt_upsampler",
                 "offload_guardrail_models", "disable_guardrail",
                 "disable_prompt_upsampler"):
        p.add_argument(f"--{flag}", action="store_true")
    p.add_argument("--quantize_int8", action="store_true", help="not ported yet")
    p.add_argument("--quantize_w8a8", action="store_true", help="not ported yet")
    return p


def check_ported(args) -> None:
    """Raise NotImplementedError naming each set flag whose feature this
    port does not have."""
    unported = {
        "--quantize_int8": args.quantize_int8,
        "--quantize_w8a8": args.quantize_w8a8,
        "--step_cache_interval": args.step_cache_interval != 1,
        "--step_cache_block_span": args.step_cache_block_span is not None,
        "--step_cache_span_dtype": args.step_cache_span_dtype != "bf16",
        "--step_cache_threshold": args.step_cache_threshold > 0,
        "--attn_temporal_window": args.attn_temporal_window is not None,
        "--guidance_interval": args.guidance_interval is not None,
        "--solver": args.solver != "euler",
        "--cfg_rescale": args.cfg_rescale > 0,
        "--num_devices": args.num_devices > 1,
        "--parallel": args.parallel != "cp",
        "--cp_attn": args.cp_attn is not None,
        "--foreground_masking": args.foreground_masking,
        "--enable_prompt_encoder": not args.disable_prompt_encoder,
        "--perf_preset": args.perf_preset != "exact",
        "--offload_diffusion_transformer": args.offload_diffusion_transformer,
        "--offload_tokenizer": args.offload_tokenizer,
    }
    for flag, used in unported.items():
        if used:
            raise NotImplementedError(f"{flag} is not ported to gen3c_tpu_torch yet")


def validate_args(args, chunk_size: int) -> None:
    n = args.num_video_frames
    if n < chunk_size or (n - 1) % (chunk_size - 1):
        raise ValueError(
            f"num_video_frames must be {chunk_size} + k*{chunk_size - 1} (got {n})")


def demo(args) -> str:
    check_ported(args)
    device = torch.device(args.device)
    model, preset = build_gen3c_model(args.model_preset, device=device, seed=args.seed,
                                      checkpoint_dir=args.checkpoint_dir)
    validate_args(args, preset.chunk_size)
    pipeline = Gen3cPipeline(model=model, guidance=args.guidance, num_steps=args.num_steps,
                             seed=args.seed)
    if args.batch_input_path:
        inputs = io_utils.read_prompts_from_file(args.batch_input_path)
    else:
        inputs = [{"prompt": args.prompt, "visual_input": args.input_image_path}]
    save_path = ""
    for i, d in enumerate(inputs):
        name = str(i) if args.batch_input_path else args.video_save_name
        save_path = _generate_one(args, preset, pipeline, device, d.get("visual_input"),
                                  d.get("prompt", ""), name)
    return save_path


def _generate_one(args, preset, pipeline, device, image_path, prompt, save_name) -> str:
    h, w = preset.height, preset.width
    image_b3thw = io_utils.read_image_bcthw(image_path, h, w)
    image_hwc01 = (image_b3thw[0, :, 0].transpose(1, 2, 0) + 1.0) / 2.0
    estimator = make_depth_estimator(args.depth_source, args.depth_path)
    depth, intrinsics, _ = estimator(image_hwc01)
    w2c0 = np.eye(4, dtype=np.float32)
    cache = Cache3DBuffer(
        frame_buffer_max=args.frame_buffer_max,
        noise_aug_strength=args.noise_aug_strength,
        seed=args.seed,
        input_image=torch.from_numpy(image_b3thw[:, :, 0]),
        input_depth=torch.from_numpy(np.asarray(depth, np.float32)[None, None]),
        input_w2c=torch.from_numpy(w2c0[None]),
        input_intrinsics=torch.from_numpy(np.asarray(intrinsics, np.float32)[None]),
        filter_points_threshold=args.filter_points_threshold,
        device=device,
    )
    w2cs, ks = generate_camera_trajectory(
        trajectory_type=args.trajectory,
        initial_w2c=w2c0,
        initial_intrinsics=intrinsics,
        num_frames=args.num_video_frames,
        movement_distance=args.movement_distance,
        camera_rotation=args.camera_rotation,
        center_depth=1.0,
        device=device,
    )
    video, all_warps = run_chunked_generation(
        pipeline, cache, w2cs, ks,
        seed_frames=image_b3thw[:, :, :1],
        prompt=prompt,
        negative_prompt=args.negative_prompt or None,
        update_cache_with_depth=estimator,
        save_buffer=args.save_buffer,
    )
    final_video = compose_buffer_video(video, all_warps, h, w)
    save_path = io_utils.save_video(final_video, args.fps,
                                    os.path.join(args.video_save_folder, f"{save_name}.mp4"))
    log.info(f"Saved video to {save_path}")
    return save_path


if __name__ == "__main__":
    demo(create_parser().parse_args())
