"""Depth sources for cache seeding and AR updates (port of
gen3c_tpu/pipelines/depth.py).

  * NativeMoGeDepthEstimator: MoGe ViT-L in this package (``aux/moge.py``)
    on the run's device, from a converted checkpoint (source "moge_jax",
    gen3c_tpu's ``MoGeJaxDepthEstimator``);
  * MoGeDepthEstimator: the external ``moge`` pip package;
  * FileDepthEstimator: precomputed depth (npy / npz / EXR / 16-bit png);
  * HeuristicDepthEstimator: smooth depth from a position prior, for runs
    without a depth model.

The MoGe estimators follow the reference (gen3c_single_image.py:114-217):
masked-out depth is set to 1000.
"""

from __future__ import annotations

import os
from typing import Optional, Protocol, Tuple

import numpy as np
import torch

from gen3c_tpu_torch.utils import log


class DepthEstimation(Protocol):
    def __call__(self, image: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """image: (H, W, 3) uint8 or float in [0, 1] -> (depth (H, W) fp32,
        intrinsics (3, 3) or None, mask (H, W) bool)."""
        ...


def default_intrinsics(h: int, w: int, fov_deg: float = 50.0) -> np.ndarray:
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


class MoGeDepthEstimator:
    """MoGe from the external ``moge`` package ("Ruicheng/moge-vitl"):
    depth and mask at the input's resolution, the normalised intrinsics
    scaled to pixels, masked-out depth set to 1000."""

    MASKED_DEPTH = 1000.0

    def __init__(self, device: str = "cuda"):
        from moge.model import MoGeModel  # the external pip package

        self.model = MoGeModel.from_pretrained("Ruicheng/moge-vitl").to(device)
        self.device = device

    def __call__(self, image: np.ndarray):
        h, w = image.shape[:2]
        img = image.astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        out = self.model.infer(torch.from_numpy(img).permute(2, 0, 1).to(self.device))
        depth = out["depth"].cpu().numpy().astype(np.float32)
        mask = out["mask"].cpu().numpy().astype(bool)
        k = out["intrinsics"].cpu().numpy().astype(np.float32).copy()
        k[0] *= w
        k[1] *= h
        return np.where(mask, depth, self.MASKED_DEPTH), k, mask


class NativeMoGeDepthEstimator:
    """MoGe ViT-L of ``aux/moge.py`` on ``device``, the port's own depth
    source (gen3c_tpu's ``MoGeJaxDepthEstimator``). Its checkpoint comes
    from ``checkpoint`` or $GEN3C_MOGE_CHECKPOINT, an .npz of the torch
    names or a torch state dict (.pt, optionally under "model"); without
    one it raises FileNotFoundError. Depth and intrinsics at the input's
    resolution; masked-out or non-finite depth set to 1000."""

    MASKED_DEPTH = 1000.0

    def __init__(self, checkpoint: Optional[str] = None, cfg=None, device: str = "cuda"):
        from gen3c_tpu_torch.aux import moge

        self.cfg = moge.MOGE_VITL if cfg is None else cfg
        path = checkpoint or os.environ.get("GEN3C_MOGE_CHECKPOINT", "")
        if not path or not os.path.exists(path):
            raise FileNotFoundError(
                "MoGe checkpoint not found (set GEN3C_MOGE_CHECKPOINT or pass checkpoint=): "
                "an .npz or .pt of the 'Ruicheng/moge-vitl' weights under their torch names")
        if path.endswith(".npz"):
            data = np.load(path)
            sd = {k: data[k] for k in data.files}
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "model" in sd:
                sd = sd["model"]
        self.device = torch.device(device)
        self.params = {k: v.to(self.device)
                       for k, v in moge.convert_moge_state_dict(sd, self.cfg).items()}

    def __call__(self, image: np.ndarray):
        from gen3c_tpu_torch.aux.moge import moge_infer

        img = image.astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        depth, k, mask = moge_infer(self.params, self.cfg, torch.from_numpy(img).to(self.device))
        depth = depth.cpu().numpy().astype(np.float32)
        mask = mask.cpu().numpy().astype(bool)
        depth = np.where(mask & np.isfinite(depth), depth, self.MASKED_DEPTH)
        return depth, k.cpu().numpy().astype(np.float32), mask


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
            from gen3c_tpu_torch.utils.exr import read_exr_depth

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
                         intrinsics: Optional[np.ndarray] = None,
                         device: str = "cuda") -> DepthEstimation:
    """source: 'moge_jax' (the native MoGe, checkpoint-gated) | 'moge' (the
    external package) | 'file' | 'heuristic' | 'auto'. auto takes the first
    that is available, in gen3c_tpu's order: file (with depth_path), then
    moge_jax, then moge, then the heuristic. A named source that is not
    available raises."""
    if source == "file" or (source == "auto" and depth_path):
        if not depth_path:
            raise ValueError("--depth_path is required for the file depth source")
        return FileDepthEstimator(depth_path, intrinsics)
    if source in ("moge_jax", "auto"):
        try:
            return NativeMoGeDepthEstimator(device=device)
        except Exception as e:  # noqa: BLE001 - auto falls through, in gen3c_tpu's order
            if source == "moge_jax":
                raise
            log.info(f"native MoGe unavailable ({e}); trying the moge package")
    if source in ("moge", "auto"):
        try:
            return MoGeDepthEstimator(device=device)
        except Exception as e:  # noqa: BLE001
            if source == "moge":
                raise
            log.warning(f"MoGe unavailable ({e}); using heuristic depth")
    elif source != "heuristic":
        raise ValueError(f"unknown depth source {source!r}")
    return HeuristicDepthEstimator()
