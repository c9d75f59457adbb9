"""Serving-side inference models: the abstract interface, a deterministic
debug model, and the GEN3C persistent model (port of
gen3c_tpu/serving/models.py).

  * InferenceModel: seed_model, run_inference (with the AR loop's
    ``on_chunk`` progress and ``cancel_event``), clear_cache, metadata,
    get_latest_rgb, get_point_cloud;
  * DebugInferenceModel: a deterministic fake (gradient test frames, ones
    depth) that serves the whole API without a model;
  * Gen3cPersistentModel: GEN3C built once on ``device`` and kept there
    across requests; seeded from one image (depth from the depth
    estimator) or N posed RGBD frames, it runs ``run_chunked_generation``
    over each request's camera path, and renders instant previews of the
    seeded cache (kernel K5, or the host rasterizer of
    ``native/point_raster`` with GEN3C_PREVIEW_NATIVE=1).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from gen3c_tpu_torch.pipelines.chunked import GenerationCancelled
from gen3c_tpu_torch.serving.api_types import (
    InferenceRequest,
    InferenceResult,
    SeedingRequest,
    SeedingResult,
)
from gen3c_tpu_torch.utils import log


def _resize_images_bhwc(images: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bicubic resize of (B, H, W, C) float images, channel by channel
    (Pillow's convolution resamplers antialias when they shrink, as the
    reference's torchvision resize with antialias=True)."""
    from PIL import Image

    b, _, _, c = images.shape
    out = np.empty((b, h, w, c), np.float32)
    for i in range(b):
        for ch in range(c):
            im = Image.fromarray(images[i, :, :, ch].astype(np.float32), mode="F")
            out[i, :, :, ch] = np.asarray(im.resize((w, h), Image.BICUBIC))
    return out


def _resize_depths_bhw(depths: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize of (B, H, W) float depth maps: metric depth is
    interpolated, not averaged down."""
    from PIL import Image

    out = np.empty((depths.shape[0], h, w), np.float32)
    for i in range(depths.shape[0]):
        im = Image.fromarray(depths[i].astype(np.float32), mode="F")
        out[i] = np.asarray(im.resize((w, h), Image.BILINEAR))
    return out


class InferenceModel:
    """Abstract serving model."""

    def seed_model(self, req: SeedingRequest) -> SeedingResult:
        raise NotImplementedError

    def run_inference(
        self,
        req: InferenceRequest,
        on_chunk=None,  # (chunks_done, num_chunks, frames_so_far uint8)
        cancel_event=None,  # threading.Event; honoured between chunks
    ) -> InferenceResult:
        raise NotImplementedError

    def clear_cache(self) -> None:
        pass

    def metadata(self) -> dict:
        return {"model": type(self).__name__}

    def get_latest_rgb(self) -> Optional[np.ndarray]:
        return getattr(self, "_latest_rgb", None)

    def get_point_cloud(self, max_points: int = 200_000):
        """(points (N, 3) float32 in world space, colors (N, 3) uint8) of
        the seeded 3D cache: the web viewer's preview geometry."""
        raise NotImplementedError


class DebugInferenceModel(InferenceModel):
    """Deterministic in-memory fake: a gradient test image per frame, ones
    depth for seeding."""

    def __init__(self, resolution=(64, 96)):
        self.h, self.w = resolution
        self.seeded = False
        self._latest_rgb = None

    def seed_model(self, req: SeedingRequest) -> SeedingResult:
        self.seeded = True
        n = len(req)
        h, w = req.images.shape[1:3]
        self._latest_rgb = np.asarray(req.images[0])
        return SeedingResult.from_request(req, fallback_depths=np.ones((n, h, w), np.float32))

    def run_inference(self, req: InferenceRequest, on_chunk=None,
                      cancel_event=None) -> InferenceResult:
        if cancel_event is not None and cancel_event.is_set():
            raise GenerationCancelled()
        n = len(req)
        w, h = req.resolution()
        t = np.linspace(0, 1, n)[:, None, None]
        yy = np.linspace(0, 1, h)[None, :, None]
        xx = np.linspace(0, 1, w)[None, None, :]
        frames = np.stack([xx + 0 * yy + 0 * t, yy + 0 * xx + 0 * t, t + 0 * xx + 0 * yy],
                          axis=-1)
        images = (np.broadcast_to(frames, (n, h, w, 3)) * 255).astype(np.uint8)
        if on_chunk is not None:  # one "chunk": the whole progress at once
            on_chunk(1, 1, images)
        self._latest_rgb = images[-1]
        return InferenceResult(
            request_id=req.request_id,
            cameras_to_world=req.cameras_to_world,
            focal_lengths=req.focal_lengths,
            principal_points=req.principal_points,
            resolutions=req.resolutions,
            images=images,
            depths=np.ones((n, h, w), np.float32) if req.return_depths else None,
        )

    def get_point_cloud(self, max_points: int = 200_000):
        return _subsample(*_debug_point_cloud(), max_points)

    def metadata(self) -> dict:
        return {
            "model": "DebugInferenceModel",
            "seeded": self.seeded,
            "inference_resolution": [self.w, self.h],
            "mean_inference_time_per_frame": 0.0,
        }


class Gen3cPersistentModel(InferenceModel):
    """GEN3C built once on ``device`` and serving many seeding and
    inference requests.

    ``num_devices`` > 1 raises NotImplementedError: the port's context
    parallelism runs one process per rank, and a server process driving
    several cards is not ported (ROADMAP item 15d). ``offload_dit`` is
    accepted and logs that the DiT stays on the device, as the CLIs'
    offload flags do. ``quantize`` ("int8", "w8a8") and
    ``attn_temporal_window`` build the DiT as the CLIs do.
    """

    def __init__(
        self,
        model_preset: str = "gen3c_7b",
        checkpoint_dir: Optional[str] = "checkpoints",
        num_steps: int = 35,
        guidance: float = 1.0,
        seed: int = 0,
        depth_source: str = "auto",
        quantize=False,
        step_cache_interval: int = 1,
        step_cache_threshold: float = 0.0,
        num_devices: int = 1,
        parallel: str = "cp",
        offload_dit: Optional[bool] = None,
        attn_temporal_window: Optional[int] = None,
        cp_attn: Optional[str] = None,
        guidance_interval: Optional[tuple] = None,
        cfg_rescale: float = 0.0,
        device="cuda",
    ):
        from gen3c_tpu_torch.parallel.mesh import ITEM_15D
        from gen3c_tpu_torch.pipelines.depth import make_depth_estimator
        from gen3c_tpu_torch.pipelines.factory import build_gen3c_model
        from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline

        if num_devices > 1:
            raise NotImplementedError(
                f"num_devices={num_devices}: a server process over several devices is not "
                f"ported to gen3c_tpu_torch yet ({ITEM_15D})")
        if offload_dit:
            log.info("offload_dit: ignored, the DiT stays on the device (offload is not ported)")
        t0 = time.perf_counter()
        self.model, self.preset = build_gen3c_model(
            model_preset, device=device, seed=seed, checkpoint_dir=checkpoint_dir,
            quantize=quantize, attn_temporal_window=attn_temporal_window, parallel=parallel,
            cp_attn=cp_attn)
        self.device = self.model.device
        self.quantize = quantize
        self.pipeline = Gen3cPipeline(
            model=self.model, guidance=guidance, num_steps=num_steps,
            step_cache_interval=step_cache_interval, step_cache_threshold=step_cache_threshold,
            guidance_interval=(tuple(float(v) for v in guidance_interval)
                               if guidance_interval else None),
            cfg_rescale=float(cfg_rescale), seed=seed)
        self.depth_estimator = make_depth_estimator(depth_source, device=str(self.device))
        log.info(f"serving model ready in {time.perf_counter() - t0:.1f}s "
                 "(build + pipeline + depth)")
        self.cache = None
        self._native_pc = None  # the host preview's point cloud, kept until the next seed
        self.seeding_request: Optional[SeedingRequest] = None
        self._latest_rgb = None
        self._inference_times = []
        # run_chunked_generation's per-chunk seconds, launches and peaks of
        # the last request, a cancelled one included
        self.last_timings: dict = {}

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def _cameras(self, req: InferenceRequest):
        """(w2cs (1, F, 4, 4), Ks (1, F, 3, 3)) on the device, K at the
        inference resolution."""
        target_res = np.tile([[self.preset.width, self.preset.height]], (len(req), 1))
        return (self._tensor(req.world_to_cameras())[None],
                self._tensor(req.intrinsics_matrix(for_resolutions=target_res))[None])

    def seed_model(self, req: SeedingRequest) -> SeedingResult:
        from gen3c_tpu_torch.cache import Cache3DBuffer, Cache4D

        h, w = self.preset.height, self.preset.width
        images = req.images.astype(np.float32)
        if images.max() > 1.5:
            images = images / 255.0
        n = len(req)
        w2cs = req.world_to_cameras().astype(np.float32)
        # the cache, depths and intrinsics live at the inference resolution:
        # the seeds are resized and K scaled to (w, h)
        ks = req.intrinsics_matrix(for_resolutions=np.tile([[w, h]], (n, 1))).astype(np.float32)
        if images.shape[1] != h or images.shape[2] != w:
            images = _resize_images_bhwc(images, h, w)
        depths_in = None
        if req.depths is not None:
            depths_in = req.depths.astype(np.float32)
            if depths_in.shape[1:] != (h, w):
                depths_in = _resize_depths_bhw(depths_in, h, w)
        masks_in = None
        if getattr(req, "masks", None) is not None:
            masks_in = req.masks.astype(np.float32)
            if masks_in.shape[1:] != (h, w):  # binary validity: resize, threshold again
                masks_in = _resize_depths_bhw(masks_in, h, w) > 0.5
            masks_in = masks_in.astype(np.float32)
        if depths_in is None:
            depths = np.stack([self.depth_estimator(images[i])[0] for i in range(n)])
        else:
            depths = depths_in

        imgs_bchw = images.transpose(0, 3, 1, 2) * 2 - 1
        common = dict(input_image=self._tensor(imgs_bchw),
                      input_depth=self._tensor(depths[:, None]),
                      input_mask=None if masks_in is None else self._tensor(masks_in[:, None]),
                      input_w2c=self._tensor(w2cs), input_intrinsics=self._tensor(ks),
                      device=self.device)
        if n == 1:
            self.cache = Cache3DBuffer(frame_buffer_max=self.preset.frame_buffer_max, **common)
        else:
            self.cache = Cache4D(input_format=["F", "C", "H", "W"], **common)
        self.seeding_request = req
        self._native_pc = None
        self._latest_rgb = (images[0] * 255).astype(np.uint8)
        self._seed_frame = imgs_bchw[0:1][:, :, None]  # (1, 3, 1, H, W)
        return SeedingResult.from_request(req, fallback_depths=depths)

    def run_inference(self, req: InferenceRequest, on_chunk=None,
                      cancel_event=None) -> InferenceResult:
        from gen3c_tpu_torch.cache import Cache3DBuffer, Cache4D
        from gen3c_tpu_torch.pipelines.chunked import run_chunked_generation

        assert self.cache is not None, "seed the model first"
        t0 = time.perf_counter()
        chunk = self.model.chunk_size
        # pad the camera path so that (n - 1) % (chunk - 1) == 0; the result
        # is trimmed back to the request's frames
        n_padded = max(chunk, ((len(req) - 1 + chunk - 2) // (chunk - 1)) * (chunk - 1) + 1)
        req.pad_to_frame_count(n_padded)
        w2cs, ks = self._cameras(req)
        self.last_timings = {}
        video, _ = run_chunked_generation(
            self.pipeline, self.cache, w2cs, ks, self._seed_frame, prompt=req.prompt or "",
            update_cache_with_depth=(self.depth_estimator
                                     if isinstance(self.cache, Cache3DBuffer) else None),
            use_start_frame_idx=isinstance(self.cache, Cache4D),
            timings=self.last_timings, on_chunk=on_chunk, cancel_event=cancel_event)
        video = video[:n_padded]
        depths_out = None
        if req.return_depths:
            depths_out = np.stack([self.depth_estimator(f / 255.0)[0] for f in video])
        result = InferenceResult(
            request_id=req.request_id,
            cameras_to_world=req.cameras_to_world,
            focal_lengths=req.focal_lengths,
            principal_points=req.principal_points,
            resolutions=req.resolutions,
            images=video,
            depths=depths_out,
            runtime_ms=(time.perf_counter() - t0) * 1000,
        )
        result.trim_to_original_frame_count(req.frame_count_without_padding)
        self._latest_rgb = result.images[-1]
        self._inference_times.append((time.perf_counter() - t0) / max(len(result), 1))
        return result

    def render_preview(self, req: InferenceRequest) -> InferenceResult:
        """The seeded cache rendered along the camera path without
        diffusion: K5's splat on the device, or, with
        GEN3C_PREVIEW_NATIVE=1 and the host library built, the z-buffered
        point rasterizer of ``native/point_raster`` (GEN3C_PREVIEW_POINT_RADIUS,
        GEN3C_PREVIEW_SPP sub-pixel jittered passes accumulated in
        ``native/render_buffer``)."""
        assert self.cache is not None, "seed the model first"
        t0 = time.perf_counter()
        frames = None
        if os.environ.get("GEN3C_PREVIEW_NATIVE", "0") == "1":
            frames = self._native_preview(req)
        if frames is None:
            w2cs, ks = self._cameras(req)
            px, _ = self.cache.render_cache(w2cs, ks)
            frames = px[0, :, 0].permute(0, 2, 3, 1).cpu().numpy()
            frames = ((frames + 1) / 2 * 255).clip(0, 255).astype(np.uint8)
        return InferenceResult(
            request_id=req.request_id,
            cameras_to_world=req.cameras_to_world,
            focal_lengths=req.focal_lengths,
            principal_points=req.principal_points,
            resolutions=req.resolutions,
            images=frames,
            runtime_ms=(time.perf_counter() - t0) * 1000,
        )

    def _native_preview(self, req: InferenceRequest) -> Optional[np.ndarray]:
        """(F, H, W, 3) uint8 from the host rasterizer, or None when its
        library does not build here."""
        from gen3c_tpu_torch.native import point_raster as pr

        if not pr.available():
            return None
        if self._native_pc is None:  # the cache's geometry changes only on seeding
            self._native_pc = self.get_point_cloud(max_points=2_000_000)
        pts, cols = self._native_pc
        h, w = self.preset.height, self.preset.width
        w2c_np = req.world_to_cameras().astype(np.float32)
        ks_np = req.intrinsics_matrix(
            for_resolutions=np.tile([[w, h]], (len(req), 1))).astype(np.float32)
        radius = float(os.environ.get("GEN3C_PREVIEW_POINT_RADIUS", "1.0"))
        spp = int(os.environ.get("GEN3C_PREVIEW_SPP", "1"))
        frames = pr.raster_points(pts, cols, w2c_np, ks_np, h, w, point_radius=radius)
        if spp > 1:
            from gen3c_tpu_torch.native import render_buffer as rbuf

            if rbuf.available():
                acc = rbuf.RenderBuffer.for_shape(frames.shape)
                acc.accumulate(frames.astype(np.float32) / 255.0)
                rng = np.random.RandomState(0)
                for _ in range(spp - 1):
                    kj = ks_np.copy()
                    kj[:, 0, 2] += rng.uniform(-0.5, 0.5)
                    kj[:, 1, 2] += rng.uniform(-0.5, 0.5)
                    f = pr.raster_points(pts, cols, w2c_np, kj, h, w, point_radius=radius)
                    acc.accumulate(f.astype(np.float32) / 255.0)
                frames = acc.readout(srgb_transfer=False)
        return frames

    def get_point_cloud(self, max_points: int = 200_000):
        assert self.cache is not None, "seed the model first"
        img = self.cache.input_image[0].cpu().numpy()  # (F, N, V, C, H, W)
        pts = self.cache.input_points[0].cpu().numpy()  # (F, N, V, H, W, 3)
        c = img.shape[3]
        colors = img.transpose(0, 1, 2, 4, 5, 3).reshape(-1, c)[:, :3]
        colors = ((colors * 0.5 + 0.5) * 255).clip(0, 255).astype(np.uint8)
        points = pts.reshape(-1, 3).astype(np.float32)
        if self.cache.input_mask is not None:
            m = self.cache.input_mask[0].cpu().numpy().reshape(-1) > 0.5
            if m.shape[0] == points.shape[0]:
                points, colors = points[m], colors[m]
        return _subsample(points, colors, max_points)

    def clear_cache(self) -> None:
        self.cache = None
        self._native_pc = None
        self.seeding_request = None

    def metadata(self) -> dict:
        cfg = self.model.net.cfg
        return {
            "model": "Gen3cPersistentModel",
            "preset": self.preset.name,
            "seeded": self.cache is not None,
            "inference_resolution": [self.preset.width, self.preset.height],
            "chunk_size": self.model.chunk_size,
            # 4.0 before the first request, as the reference server reports
            "mean_inference_time_per_frame": (float(np.mean(self._inference_times))
                                              if self._inference_times else 4.0),
            "perf": {
                "quantize": self.quantize,
                "offload_dit": False,
                "streaming": False,
                "attn_temporal_window": cfg.attn_temporal_window,
                "cp_attn_impl": cfg.cp_attn_impl,
                "step_cache_interval": self.pipeline.step_cache_interval,
                "step_cache_threshold": self.pipeline.step_cache_threshold,
                "guidance_interval": (list(self.pipeline.guidance_interval)
                                      if self.pipeline.guidance_interval else None),
                "cfg_rescale": self.pipeline.cfg_rescale,
                "solver": self.pipeline.solver,
            },
        }


def _subsample(points: np.ndarray, colors: np.ndarray, max_points: int):
    if len(points) > max_points:
        idx = np.linspace(0, len(points) - 1, max_points).astype(np.int64)
        points, colors = points[idx], colors[idx]
    return points, colors


def _debug_point_cloud(n: int = 5000):
    """A synthetic unit sphere: the debug model's point cloud."""
    rng = np.random.RandomState(0)
    v = rng.randn(n, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    colors = ((v * 0.5 + 0.5) * 255).astype(np.uint8)
    return v, colors
