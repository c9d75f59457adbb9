"""Depth sources for cache seeding and AR updates (port of
gen3c_tpu/pipelines/depth.py without MoGe, which waits for its
checkpoint): precomputed depth files and the dependency-free heuristic."""

from __future__ import annotations

import os
from typing import Optional, Protocol, Tuple

import numpy as np

from gen3c_tpu_torch.utils import log


class DepthEstimation(Protocol):
    def __call__(self, image: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """image: (H, W, 3) uint8 or float in [0, 1] -> (depth (H, W) fp32,
        intrinsics (3, 3) or None, mask (H, W) bool)."""
        ...


def default_intrinsics(h: int, w: int, fov_deg: float = 50.0) -> np.ndarray:
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


class FileDepthEstimator:
    """Depth from a file: .npy/.npz, .exr (pure-Python codec) or a 16-bit
    png in millimetres."""

    def __init__(self, path: str, intrinsics: Optional[np.ndarray] = None):
        self.path = path
        self.intrinsics = intrinsics

    def __call__(self, image: np.ndarray):
        h, w = image.shape[:2]
        ext = os.path.splitext(self.path)[1].lower()
        if ext == ".npy":
            depth = np.load(self.path).astype(np.float32)
        elif ext == ".npz":
            data = np.load(self.path)
            depth = data[list(data.keys())[0]].astype(np.float32)
        elif ext == ".exr":
            from gen3c_tpu.utils.exr import read_exr_depth

            with open(self.path, "rb") as f:
                depth = read_exr_depth(f.read())
        else:
            from PIL import Image

            arr = np.asarray(Image.open(self.path))
            depth = arr.astype(np.float32)
            if arr.dtype == np.uint16:
                depth = depth / 1000.0
        if depth.shape != (h, w):
            from PIL import Image

            depth = np.asarray(Image.fromarray(depth).resize((w, h), Image.BILINEAR))
        mask = depth > 0
        k = self.intrinsics if self.intrinsics is not None else default_intrinsics(h, w)
        return depth, k, mask


class HeuristicDepthEstimator:
    """Smooth depth from a vertical position prior and blurred luminance.
    For smoke runs and environments without a depth model."""

    def __init__(self, base_depth: float = 2.5):
        self.base_depth = base_depth

    def __call__(self, image: np.ndarray):
        h, w = image.shape[:2]
        img = image.astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        lum = img.mean(axis=2)

        def box(a: np.ndarray, k: int, axis: int) -> np.ndarray:
            pad = k // 2
            spec = [(0, 0), (0, 0)]
            spec[axis] = (pad, pad)
            c = np.cumsum(np.pad(a, spec, mode="edge"), axis=axis)
            zero = np.zeros((1, c.shape[1]) if axis == 0 else (c.shape[0], 1), c.dtype)
            c = np.concatenate([zero, c], axis=axis)
            if axis == 0:
                return (c[k:] - c[:-k]) / k
            return (c[:, k:] - c[:, :-k]) / k

        k = max(h, w) // 16 * 2 + 1
        lum = box(box(lum, k, 0), k, 1)
        yy = np.linspace(0, 1, h)[:, None]
        depth = self.base_depth * (1.4 - 0.6 * yy) * (1.2 - 0.4 * lum)
        return depth.astype(np.float32), default_intrinsics(h, w), np.ones((h, w), bool)


def make_depth_estimator(source: str = "auto", depth_path: Optional[str] = None,
                         intrinsics: Optional[np.ndarray] = None) -> DepthEstimation:
    """'file' | 'heuristic' | 'auto' (file when depth_path is given, else
    the heuristic). MoGe is not ported: 'moge' raises."""
    if source in ("moge", "moge_jax"):
        raise NotImplementedError(f"depth_source {source!r}: MoGe is not ported yet")
    if source == "file" or (source == "auto" and depth_path):
        if not depth_path:
            raise ValueError("--depth_path is required for the file depth source")
        return FileDepthEstimator(depth_path, intrinsics)
    if source == "auto":
        log.warning("no MoGe in this port: depth_source auto uses the heuristic estimator")
    elif source != "heuristic":
        raise ValueError(f"unknown depth source {source!r}")
    return HeuristicDepthEstimator()
