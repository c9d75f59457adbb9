"""Single image -> camera-controlled video (GEN3C), PyTorch/CUDA CLI.

Port of gen3c_tpu/pipelines/gen3c_single_image.py: image -> depth -> 3D
cache -> preset trajectory -> chunked autoregressive generation (121*N-1
frames, one frame of overlap, cache updated from the re-estimated depth of
each chunk's last frame) -> video file. The flag names are the JAX CLI's,
plus ``--device``; every --parallel strategy runs, one process per rank
under ``torchrun``.

Usage:
  python -m gen3c_tpu_torch.pipelines.gen3c_single_image \
      --input_image_path image.png --trajectory left --device cuda \
      [--model_preset gen3c_tiny] [--perf_preset fast]

On N devices, one process per device, as the reference runs it:
  torchrun --nproc_per_node N -m gen3c_tpu_torch.pipelines.gen3c_single_image \
      --num_gpus N --parallel cp --cp_attn ulysses ...
Every rank renders, encodes and denoises its share; rank 0 alone logs and
writes the video.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.cache.cache3d import Cache3DBuffer
from gen3c_tpu_torch.ops.camera import CAMERA_ROTATIONS, TRAJECTORY_TYPES, generate_camera_trajectory
from gen3c_tpu_torch.parallel.mesh import process_rank
from gen3c_tpu_torch.pipelines import factory
from gen3c_tpu_torch.pipelines.chunked import compose_buffer_video, run_chunked_generation
from gen3c_tpu_torch.pipelines.depth import make_depth_estimator
from gen3c_tpu_torch.pipelines.factory import PRESETS
from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline
from gen3c_tpu_torch.utils import log
from gen3c_tpu_torch.utils.io import (IncrementalVideoSaver, read_image_bcthw,
                                      read_prompts_from_file)
from gen3c_tpu_torch.utils.timing import synchronize


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GEN3C single-image (PyTorch/CUDA)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda = cuda:$LOCAL_RANK, cuda:N or cpu)")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--model_preset", type=str, default="gen3c_7b", choices=sorted(PRESETS))
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--negative_prompt", type=str, default="")
    p.add_argument("--input_image_path", type=str, required=True)
    p.add_argument("--video_save_name", type=str, default="output")
    p.add_argument("--video_save_folder", type=str, default="outputs/")
    p.add_argument("--guidance", type=float, default=1.0)
    p.add_argument("--guidance_interval", type=float, nargs=2, default=None,
                   metavar=("SIGMA_LO", "SIGMA_HI"),
                   help="run CFG only on steps whose sigma lies in [LO, HI] "
                        "(arXiv:2404.07724); the others run the conditioned "
                        "forward alone. Default: CFG on every step")
    p.add_argument("--perf_preset", choices=["exact", "fast"], default="exact",
                   help="'fast' = W8A8 + band window 2 + step-cache interval 2 + "
                        "guidance interval 1.75..81; explicit flags win")
    p.add_argument("--cfg_rescale", type=float, default=0.0,
                   help="phi in [0, 1]: blend in the CFG output rescaled to the "
                        "cond branch's std (arXiv:2305.08891); 0 = plain CFG")
    p.add_argument("--num_steps", type=int, default=35)
    p.add_argument("--solver", default="euler", choices=("euler", "dpm2m", "res2ab"),
                   help="denoise integration rule at equal network cost: euler, or the "
                        "multistep dpm2m (DPM-Solver++(2M)) or res2ab (exponential-"
                        "integrator AB2); not with step caching")
    p.add_argument("--step_cache_interval", type=int, default=1,
                   help="> 1: run the DiT every Nth step after a 2-step warmup "
                        "and before a 2-step tail, reusing its output between")
    p.add_argument("--step_cache_block_span", type=int, nargs=2, default=None,
                   metavar=("LO", "HI"),
                   help="with --step_cache_interval > 1: span caching, the skipped steps "
                        "run only the DiT blocks outside [LO, HI) and re-apply the span's "
                        "cached residual (python -m gen3c_tpu_torch.scripts."
                        "rank_block_contributions recommends a span). The carry is the "
                        "CFG batch's tokens: 2 x 56,320 x 4096 bf16 = 0.92 GB at the 7B")
    p.add_argument("--step_cache_span_dtype", type=str, default="bf16",
                   choices=["bf16", "int8"],
                   help="the span carry: bf16 (the token dtype) or int8 codes with "
                        "per-token fp32 scales (0.46 GB + 0.45 MB at the 7B)")
    p.add_argument("--step_cache_threshold", type=float, default=0.0,
                   help="> 0: adaptive step caching, refresh when the latent's "
                        "accumulated relative drift exceeds it (overrides "
                        "--step_cache_interval)")
    p.add_argument("--attn_temporal_window", type=int, default=None,
                   help="band self-attention (kernel K3): each latent frame "
                        "attends to frames within +/- N plus the seed frame")
    p.add_argument("--num_video_frames", type=int, default=121,
                   help="(N-1) %% (chunk-1) must be 0")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--seed", type=int, default=1)
    factory.add_prompt_encoder_flags(p)
    p.add_argument("--trajectory", type=str, default="left", choices=sorted(TRAJECTORY_TYPES))
    p.add_argument("--camera_rotation", type=str, default="center_facing",
                   choices=sorted(CAMERA_ROTATIONS))
    p.add_argument("--movement_distance", type=float, default=0.3)
    p.add_argument("--noise_aug_strength", type=float, default=0.0)
    p.add_argument("--frame_buffer_max", type=int, default=2)
    p.add_argument("--filter_points_threshold", type=float, default=0.05)
    p.add_argument("--foreground_masking", action="store_true",
                   help="cull splatted pixels behind the depth-boundary mesh (kernel K6)")
    p.add_argument("--save_buffer", action="store_true")
    p.add_argument("--batch_input_path", type=str, default=None,
                   help="JSONL with one {\"prompt\",\"visual_input\"} per line")
    p.add_argument("--depth_source", type=str, default="auto",
                   choices=["auto", "moge_jax", "moge", "file", "heuristic"],
                   help="auto: --depth_path, else MoGe from $GEN3C_MOGE_CHECKPOINT "
                        "(moge_jax), else the moge package, else the heuristic")
    p.add_argument("--depth_path", type=str, default=None)
    p.add_argument("--timings_json", type=str, default=None,
                   help="write the run's seconds, kernel launches and peak memory "
                        "to this JSON file (rank 0)")
    factory.add_parallel_flags(p)
    # offload flags of the reference CLI: none changes anything here (the
    # DiT and VAE ones log that they are ignored; the others, as in the JAX
    # package, are silent)
    for flag in ("offload_diffusion_transformer", "offload_tokenizer",
                 "offload_text_encoder_model", "offload_prompt_upsampler",
                 "offload_guardrail_models", "disable_guardrail",
                 "disable_prompt_upsampler"):
        p.add_argument(f"--{flag}", action="store_true")
    p.add_argument("--quantize_int8", action="store_true",
                   help="int8 weight-only DiT (dequantized bf16 matmuls)")
    p.add_argument("--quantize_w8a8", action="store_true",
                   help="int8 DiT weights and per-token int8 activations "
                        "(kernels K7q + K7)")
    return p


def demo(args, record: Optional[dict] = None) -> str:
    """Run the CLI; returns the path of the saved video. ``record`` (and the
    file ``--timings_json``) receives the seconds of the model build
    ("build": weights and quantization), of the text encoder's
    ("build_text_encoder") and of the whole call ("entry_point"), the
    device's peak GiB ("peak_gib", None on the CPU) and, for the last
    input: the seed frame's depth estimate ("seed_depth"), the device's
    peak before the first chunk ("setup_peak_gib"),
    ``run_chunked_generation``'s lists with an entry a chunk ("render",
    "depth", "update", "generate", "pipeline": the chunk's encodes, denoise
    steps and decode, "chunk_launches", "chunk_peak_gib") and its seconds in
    all ("chunked_generation"), the frames generated ("frames"), the kernel
    launches from the seed frame's depth to the last chunk ("launches") and
    the video's save ("save")."""
    record = {} if record is None else record
    t0 = time.perf_counter()
    model, preset = factory.build_from_args(args)
    device = torch.device(args.device)
    synchronize(device)
    record["build"] = time.perf_counter() - t0
    factory.validate_num_frames(args.num_video_frames, preset.chunk_size)
    t1 = time.perf_counter()
    text_encoder = factory.build_text_encoder(args, device)
    record["build_text_encoder"] = time.perf_counter() - t1
    pipeline = Gen3cPipeline(
        model=model, text_encoder=text_encoder, guidance=args.guidance,
        num_steps=args.num_steps, seed=args.seed,
        step_cache_interval=args.step_cache_interval,
        step_cache_threshold=args.step_cache_threshold,
        guidance_interval=tuple(args.guidance_interval) if args.guidance_interval else None,
        cfg_rescale=args.cfg_rescale, solver=args.solver)
    if args.batch_input_path:
        inputs = read_prompts_from_file(args.batch_input_path)
    else:
        inputs = [{"prompt": args.prompt, "visual_input": args.input_image_path}]
    save_path = ""
    for i, d in enumerate(inputs):
        name = str(i) if args.batch_input_path else args.video_save_name
        save_path = _generate_one(args, preset, pipeline, device, d.get("visual_input"),
                                  d.get("prompt", ""), name, record)
    record["entry_point"] = time.perf_counter() - t0
    if device.type == "cuda":
        record["peak_gib"] = max([torch.cuda.max_memory_allocated(device) / 2 ** 30,
                                  record.get("setup_peak_gib", 0.0)]
                                 + [p for p in record.get("chunk_peak_gib", []) if p])
    else:
        record["peak_gib"] = None
    if args.timings_json and process_rank() == 0:
        with open(args.timings_json, "w") as f:
            json.dump(record, f)
    return save_path


def _generate_one(args, preset, pipeline, device, image_path, prompt, save_name,
                  record: dict) -> str:
    h, w = preset.height, preset.width
    image_b3thw = read_image_bcthw(image_path, h, w)
    image_hwc01 = (image_b3thw[0, :, 0].transpose(1, 2, 0) + 1.0) / 2.0
    estimator = make_depth_estimator(args.depth_source, args.depth_path, device=str(device))
    launches = dict(kernels.launch_counts)
    t0 = time.perf_counter()
    depth, intrinsics, _ = estimator(image_hwc01)
    record["seed_depth"] = time.perf_counter() - t0
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
        foreground_masking=args.foreground_masking,
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
    if device.type == "cuda":
        record["setup_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    # each finished chunk's frames are JPEG-encoded while the next denoises;
    # not with --save_buffer, whose composed frames all differ
    saver = IncrementalVideoSaver(args.fps)
    on_chunk = (None if args.save_buffer or process_rank() != 0
                else lambda done, total, v: saver.update(v))
    timings = {}
    t0 = time.perf_counter()
    video, all_warps = run_chunked_generation(
        pipeline, cache, w2cs, ks,
        seed_frames=image_b3thw[:, :, :1],
        prompt=prompt,
        negative_prompt=args.negative_prompt or None,
        update_cache_with_depth=estimator,
        save_buffer=args.save_buffer,
        timings=timings,
        on_chunk=on_chunk,
    )
    chunk_peaks, chunk_launches = timings.pop("peak_gib"), timings.pop("launches")
    record.update(timings, chunked_generation=time.perf_counter() - t0,
                  chunk_peak_gib=chunk_peaks, chunk_launches=chunk_launches,
                  frames=int(video.shape[0]),
                  launches={k: n - launches[k] for k, n in kernels.launch_counts.items()})
    if process_rank() != 0:  # every rank holds the video; rank 0 writes it
        return ""
    t0 = time.perf_counter()
    final_video = compose_buffer_video(video, all_warps, h, w)
    save_path = saver.save(final_video, os.path.join(args.video_save_folder, f"{save_name}.mp4"))
    record["save"] = time.perf_counter() - t0
    log.info(f"Saved video to {save_path}")
    return save_path


if __name__ == "__main__":
    demo(create_parser().parse_args())
