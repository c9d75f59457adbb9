"""Multiview sparse-image novel-view synthesis (GEN3C), PyTorch/CUDA CLI.

Port of gen3c_tpu/pipelines/gen3c_multiview.py: N posed RGBD key frames
(an .npz, ``data_loaders.load_multiview_npz``) -> ``Cache3DBufferSelector``
(each chunk keeps the ``--frame_buffer_max`` buffers whose renders cover
the most of its targets) -> generation along the stored trajectory
(w2cs_all / Ks_all), chunked with one frame of overlap. The flag names are
the JAX CLI's, plus ``--device``; every --parallel strategy runs, one
process per rank under ``torchrun``.

Usage:
  python -m gen3c_tpu_torch.pipelines.gen3c_multiview --npz_path data.npz \
      --device cuda [--foreground_masking] [--model_preset gen3c_tiny]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch

from gen3c_tpu_torch.cache import Cache3DBufferSelector
from gen3c_tpu_torch.parallel.mesh import process_rank
from gen3c_tpu_torch.pipelines import factory
from gen3c_tpu_torch.pipelines.chunked import compose_buffer_video, run_chunked_generation
from gen3c_tpu_torch.pipelines.data_loaders import load_multiview_npz
from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline
from gen3c_tpu_torch.utils import log
from gen3c_tpu_torch.utils.io import IncrementalVideoSaver


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GEN3C multiview NVS (PyTorch/CUDA)")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--model_preset", type=str, default="gen3c_7b", choices=sorted(factory.PRESETS))
    p.add_argument("--npz_path", type=str, required=True)
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--negative_prompt", type=str, default="")
    factory.add_prompt_encoder_flags(p)
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
    p.add_argument("--frame_buffer_max", type=int, default=2)
    p.add_argument("--filter_points_threshold", type=float, default=0.05)
    p.add_argument("--foreground_masking", action="store_true",
                   help="cull splatted pixels behind the depth-boundary mesh (kernel K6)")
    p.add_argument("--save_buffer", action="store_true")
    factory.add_perf_flags(p)
    return p


def load_scene(args, device) -> Tuple[Cache3DBufferSelector, torch.Tensor, torch.Tensor,
                                      np.ndarray]:
    """The key frames as a Cache3DBufferSelector on ``device``, the stored
    trajectory (1, T, 4, 4) and (1, T, 3, 3) cut to ``--num_video_frames``,
    and the first key frame as the seed (1, 3, 1, H, W)."""
    d = load_multiview_npz(args.npz_path)
    cache = Cache3DBufferSelector(
        frame_buffer_max=args.frame_buffer_max,
        input_image=torch.from_numpy(d["images"][None]),  # (1, N, C, H, W)
        input_depth=torch.from_numpy(d["depths"][None]),
        input_mask=torch.from_numpy(d["masks"][None]) if d["masks"] is not None else None,
        input_w2c=torch.from_numpy(d["w2cs"][None]),
        input_intrinsics=torch.from_numpy(d["ks"][None]),
        input_format=["B", "N", "C", "H", "W"],
        filter_points_threshold=args.filter_points_threshold,
        foreground_masking=args.foreground_masking,
        device=device,
    )
    w2cs = torch.from_numpy(d["w2cs_all"][:args.num_video_frames][None]).to(device)
    ks = torch.from_numpy(d["ks_all"][:args.num_video_frames][None]).to(device)
    seed_frames = d["images"][0][None, :, None].astype(np.float32)
    return cache, w2cs, ks, seed_frames


def demo(args, built: Optional[tuple] = None, record: Optional[dict] = None) -> str:
    """Run the CLI; returns the path of the saved video. ``built`` and
    ``record`` as in ``gen3c_dynamic.demo``; ``record["selections"]`` gets
    the buffers each chunk's render kept."""
    factory.apply_perf_preset(args)
    model, preset = built if built is not None else factory.build_from_args(args)
    factory.validate_num_frames(args.num_video_frames, preset.chunk_size)
    pipeline = Gen3cPipeline(
        model=model, text_encoder=factory.build_text_encoder(args, model.device),
        guidance=args.guidance, num_steps=args.num_steps, seed=args.seed,
        step_cache_interval=args.step_cache_interval,
        guidance_interval=tuple(args.guidance_interval) if args.guidance_interval else None,
        cfg_rescale=args.cfg_rescale, solver=args.solver)
    cache, w2cs, ks, seed_frames = load_scene(args, torch.device(args.device))
    record = {} if record is None else record
    saver = IncrementalVideoSaver(args.fps)
    video, all_warps = run_chunked_generation(
        pipeline, cache, w2cs, ks, seed_frames, prompt=args.prompt,
        negative_prompt=args.negative_prompt or None, update_cache_with_depth=None,
        save_buffer=args.save_buffer, timings=record,
        on_chunk=(None if args.save_buffer or process_rank() != 0
                  else lambda done, total, v: saver.update(v)))
    record["pipeline"] = pipeline.last_timings
    record["selections"] = cache.selections
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
