"""Autoregressive chunked generation and buffer-video assembly (port of
gen3c_tpu/pipelines/chunked.py).

Generate a chunk; for each further chunk estimate the depth of the last
frame, insert it into the 3D cache (``update_cache``), re-render the warp
buffers for the next window (one frame of overlap) and generate again.
The chain runs serially: the JAX package's overlap thread hid a slow host
fetch that this port does not have. ``on_chunk`` reports each finished
chunk (serving's progress and partial results, the CLIs' incremental
save) and ``cancel_event`` stops the loop between chunks.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.utils import log
from gen3c_tpu_torch.utils.timing import synchronize


class GenerationCancelled(Exception):
    """Raised when a cancel_event is set between AR chunks."""


def run_chunked_generation(
    pipeline,
    cache,
    w2cs: torch.Tensor,  # (1, T_total, 4, 4)
    ks: torch.Tensor,  # (1, T_total, 3, 3)
    seed_frames: np.ndarray,  # (1, 3, T_seed, H, W) in [-1, 1]
    prompt: str,
    negative_prompt: Optional[str] = None,
    update_cache_with_depth: Optional[Callable] = None,  # depth estimator or None
    use_start_frame_idx: bool = False,  # Cache4D: chunk c renders its own source frames
    save_buffer: bool = False,
    timings: Optional[dict] = None,
    on_chunk: Optional[Callable] = None,  # (chunks_done, num_chunks, video_so_far)
    cancel_event=None,  # threading.Event-like, polled between chunks
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Returns (video (T, H, W, 3) uint8, list of warp buffers).

    ``on_chunk(chunks_done, num_chunks, video_so_far)`` is called after
    every finished chunk. ``cancel_event.is_set()`` is polled before the
    first render and before each later chunk, and raises
    ``GenerationCancelled``: a running chunk finishes first. A chunk that
    the pipeline's guardrails block raises ``RuntimeError``.

    ``use_start_frame_idx`` renders the window [start, end) of a
    per-frame cache (``Cache4D``) from its own source frames.

    ``timings``, if given, receives lists with one entry a chunk:
    "render" (cache render), "generate", "pipeline" (the chunk's
    ``pipeline.last_timings``: prompt, seed and warp encodes, every denoise
    step, decode), "launches" (kernel launches by id from the render to
    the end of generate) and "peak_gib" (the device's peak from the
    chunk's start, None on the CPU); and from the second chunk on "depth"
    (the estimator on the last frame) and "update" (``update_cache``, the
    depth alignment included).
    """
    chunk = pipeline.model.chunk_size
    t_total = w2cs.shape[1]
    if (t_total - 1) % (chunk - 1):
        raise ValueError(f"{t_total} frames do not chain in chunks of {chunk}")
    num_iters = (t_total - 1) // (chunk - 1)
    timings = {} if timings is None else timings
    for key in ("render", "depth", "update", "generate", "pipeline", "launches", "peak_gib"):
        timings.setdefault(key, [])
    dev = cache.device

    def chunk_start():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        return dict(kernels.launch_counts)

    def chunk_end(before):
        timings["pipeline"].append(pipeline.last_timings)
        timings["launches"].append({k: n - before[k] for k, n in kernels.launch_counts.items()})
        timings["peak_gib"].append(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                                   if dev.type == "cuda" else None)

    def render(start: int, end: int):
        t0 = time.perf_counter()
        wi, wm = cache.render_cache(w2cs[:, start:end], ks[:, start:end],
                                    start_frame_idx=start if use_start_frame_idx else 0)
        synchronize(dev)
        timings["render"].append(time.perf_counter() - t0)
        return wi, wm

    def generate(seed, wi, wm):
        t0 = time.perf_counter()
        out = pipeline.generate(prompt=prompt, image_frames=seed, rendered_warp_images=wi,
                                rendered_warp_masks=wm, negative_prompt=negative_prompt)
        if out is None:
            raise RuntimeError("Generation blocked by guardrail")
        timings["generate"].append(time.perf_counter() - t0)
        return out[0]

    def check_cancel():
        if cancel_event is not None and cancel_event.is_set():
            raise GenerationCancelled()

    check_cancel()
    log.info(f"Generating frames 0 - {chunk}")
    before = chunk_start()
    warp_images, warp_masks = render(0, chunk)
    all_warps = [warp_images.cpu().numpy()] if save_buffer else []
    video = generate(seed_frames, warp_images, warp_masks)
    del warp_images, warp_masks
    chunk_end(before)
    if on_chunk is not None:
        on_chunk(1, num_iters, video)

    for it in range(1, num_iters):
        start = it * (chunk - 1)
        end = start + chunk
        check_cancel()
        log.info(f"Generating frames {start} - {end}")
        last = video[-1].astype(np.float32) / 255.0  # (H, W, 3) in [0, 1]
        before = chunk_start()
        if update_cache_with_depth is not None:
            t0 = time.perf_counter()
            pred_depth, _, _ = update_cache_with_depth(last)
            synchronize(dev)
            timings["depth"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            cache.update_cache(
                new_image=torch.from_numpy((last.transpose(2, 0, 1)[None] * 2 - 1).astype(np.float32)),
                new_depth=torch.from_numpy(np.asarray(pred_depth, np.float32)[None, None]),
                new_w2c=w2cs[:, start],
                new_intrinsics=ks[:, start],
            )
            synchronize(dev)
            timings["update"].append(time.perf_counter() - t0)
        warp_images, warp_masks = render(start, end)
        if save_buffer:
            all_warps.append(warp_images[:, 1:].cpu().numpy())
        seed = (last.transpose(2, 0, 1)[None, :, None] * 2 - 1).astype(np.float32)
        video_new = generate(seed, warp_images, warp_masks)
        del warp_images, warp_masks
        chunk_end(before)
        video = np.concatenate([video, video_new[1:]], axis=0)
        if on_chunk is not None:
            on_chunk(it + 1, num_iters, video)
    return video, all_warps


def compose_buffer_video(video: np.ndarray, all_warps: List[np.ndarray], h: int,
                         w: int) -> np.ndarray:
    """Stack the warp buffers left of the generated video."""
    if not all_warps:
        return video
    n_max = max(t.shape[2] for t in all_warps)
    padded = []
    for t in all_warps:
        tb = t[0]  # (T, n, C, H, W)
        if tb.shape[1] < n_max:
            pad = np.full((tb.shape[0], n_max - tb.shape[1], *tb.shape[2:]), -1.0, tb.dtype)
            tb = np.concatenate([tb, pad], axis=1)
        padded.append(tb)
    buf = np.concatenate(padded, axis=0)  # (T, n, C, H, W)
    buf = buf.transpose(0, 3, 1, 4, 2).reshape(buf.shape[0], h, n_max * w, 3)
    buf = ((buf * 0.5 + 0.5) * 255).clip(0, 255).astype(np.uint8)
    return np.concatenate([buf, video], axis=2)
