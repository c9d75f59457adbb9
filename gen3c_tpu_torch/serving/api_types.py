"""Inference-service API dataclasses.

Parity: gui/api/api_types.py:31-474 — RequestBase camera conventions
(cameras_to_world [B,3,4], absolute focal lengths [B,2], relative
principal points [B,2], resolutions [B,2] as (width,height)),
pad/trim frame logic, SeedingRequest/Result, InferenceRequest/Result.
Compression variants are provided via serialization-level zlib instead of
per-field jpg/exr codecs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def pad_or_trim_array(arr: Optional[np.ndarray], n: int) -> Optional[np.ndarray]:
    """Repeat the last entry or drop from the end (api_types.py parity)."""
    if arr is None:
        return None
    cur = arr.shape[0]
    if cur == n:
        return arr
    if cur > n:
        return arr[:n]
    reps = np.repeat(arr[-1:], n - cur, axis=0)
    return np.concatenate([arr, reps], axis=0)


@dataclasses.dataclass(kw_only=True)
class RequestBase:
    request_id: str
    cameras_to_world: np.ndarray  # (B, 3, 4)
    focal_lengths: np.ndarray  # (B, 2) absolute pixels
    principal_points: np.ndarray  # (B, 2) relative
    resolutions: Optional[np.ndarray] = None  # (B, 2) (width, height)
    frame_count_without_padding: Optional[int] = None

    def __post_init__(self):
        images = getattr(self, "images", None)
        if images is not None:
            res = np.tile(
                [[images.shape[2], images.shape[1]]], (len(self), 1)
            )
            if self.resolutions is None:
                self.resolutions = res
        elif self.resolutions is None:
            raise ValueError("Missing value `resolutions`")
        n = len(self)
        assert self.cameras_to_world.shape == (n, 3, 4)
        assert self.focal_lengths.shape == (n, 2)
        assert self.principal_points.shape == (n, 2)

    def __len__(self) -> int:
        return self.cameras_to_world.shape[0]

    def world_to_cameras(self) -> np.ndarray:
        c2w = np.zeros((len(self), 4, 4), self.cameras_to_world.dtype)
        c2w[:, :3, :] = self.cameras_to_world
        c2w[:, 3, 3] = 1.0
        return np.linalg.inv(c2w)

    def intrinsics_matrix(
        self, for_resolutions: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Batched (B, 3, 3) K matrices (api_types.py:77-96 parity)."""
        k = np.zeros((len(self), 3, 3))
        k[:, 0, 0] = self.focal_lengths[:, 0]
        k[:, 1, 1] = self.focal_lengths[:, 1]
        k[:, 0, 2] = self.principal_points[:, 0] * self.resolutions[:, 0]
        k[:, 1, 2] = self.principal_points[:, 1] * self.resolutions[:, 1]
        k[:, 2, 2] = 1.0
        if for_resolutions is not None:
            k[:, 0, :] *= (
                for_resolutions[:, 0, None] / self.resolutions[:, 0, None]
            )
            k[:, 1, :] *= (
                for_resolutions[:, 1, None] / self.resolutions[:, 1, None]
            )
        return k

    def resolution(self):
        return int(self.resolutions[0, 0]), int(self.resolutions[0, 1])

    def _array_fields(self):
        return [
            "cameras_to_world", "focal_lengths", "principal_points",
            "resolutions",
        ]

    def pad_to_frame_count(self, n_frames: int) -> None:
        self.frame_count_without_padding = len(self)
        self._adjust_frame_count(n_frames)

    def trim_to_original_frame_count(
        self, override_frame_count: Optional[int] = None
    ) -> None:
        n = override_frame_count or self.frame_count_without_padding
        if n is None:
            return
        self._adjust_frame_count(n)

    def _adjust_frame_count(self, n_frames: int) -> None:
        for f in self._array_fields():
            setattr(self, f, pad_or_trim_array(getattr(self, f), n_frames))


@dataclasses.dataclass(kw_only=True)
class SeedingRequest(RequestBase):
    """Seed the 3D cache from posed images (+ optional depths)."""

    images: np.ndarray = None  # (B, H, W, 3) uint8 or float
    depths: Optional[np.ndarray] = None  # (B, H, W)
    # validity masks for multi-frame (v2v) seeding, (B, H, W) bool/float
    # (gui/api/api_types.py:160-169)
    masks: Optional[np.ndarray] = None

    def _array_fields(self):
        return super()._array_fields() + ["images", "depths", "masks"]

    def compress(self, format_rgb=None, format_depth=None,
                 format_mask=None) -> "CompressedSeedingRequest":
        """Per-buffer compression (api_types.py:176-206 parity). Depth
        may ride CompressionFormat.EXR (lossless float16/32 scanlines,
        gui/api/encoding.py:26-54 parity) or the NPZ default — see
        serving/encoding.py."""
        from gen3c_tpu_torch.serving.encoding import (
            CompressionFormat,
            compress_images,
        )

        format_rgb = format_rgb or CompressionFormat.JPG
        format_depth = format_depth or CompressionFormat.NPZ
        format_mask = format_mask or CompressionFormat.NPZ
        images_c = compress_images(self.images, format_rgb)
        depths_c = compress_images(self.depths, format_depth, is_depth=True)
        masks_c = compress_images(self.masks, format_mask, is_bool=True)
        kwargs = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
        }
        kwargs["images"] = None
        kwargs["depths"] = None
        kwargs["masks"] = None
        return CompressedSeedingRequest(
            images_compressed=images_c,
            images_format=format_rgb,
            depths_compressed=depths_c,
            depths_format=None if depths_c is None else format_depth,
            masks_compressed=masks_c,
            masks_format=None if masks_c is None else format_mask,
            **kwargs,
        )


@dataclasses.dataclass(kw_only=True)
class CompressedSeedingRequest(SeedingRequest):
    """SeedingRequest with per-buffer compressed image/depth/mask payloads
    (api_types.py:208-250 parity): images as JPG/PNG frame buffers, depths
    and masks as lossless NPZ. Call decompress() before use."""

    images_compressed: list = None  # list[bytes]
    images_format: object = None  # CompressionFormat
    depths_compressed: Optional[list] = None
    depths_format: object = None
    masks_compressed: Optional[list] = None
    masks_format: object = None

    def __post_init__(self):
        assert (self.resolutions is not None) or (self.images is not None), (
            "CompressedSeedingRequest: at least one of resolutions or "
            "images must be provided"
        )
        w, h = self.resolution()
        if self.images is None:
            self.images = np.empty((0, h, w, 3), np.float32)
        if self.depths is None and self.depths_compressed is not None:
            self.depths = np.empty((0, h, w), np.float32)
        if self.masks is None and self.masks_compressed is not None:
            self.masks = np.empty((0, h, w), bool)
        assert self.images.shape[0] == 0, (
            "CompressedSeedingRequest should not carry raw image data"
        )

    def decompress(self) -> None:
        from gen3c_tpu_torch.serving.encoding import decompress_buffer

        self.images = decompress_buffer(
            self.images_compressed, self.images_format
        )
        self.depths = decompress_buffer(
            self.depths_compressed, self.depths_format, is_depth=True
        )
        self.masks = decompress_buffer(
            self.masks_compressed, self.masks_format, is_bool=True
        )


@dataclasses.dataclass(kw_only=True)
class SeedingResult(RequestBase):
    """Estimated depths for the seeding images (api_types.py:254-293)."""

    depths: Optional[np.ndarray] = None  # (B, H, W)

    def __post_init__(self):
        super().__post_init__()
        if self.depths is not None and self.depths.ndim == 4:
            self.depths = self.depths.squeeze(1)

    @staticmethod
    def from_request(
        req: SeedingRequest, fallback_depths: Optional[np.ndarray]
    ) -> "SeedingResult":
        resolutions = req.resolutions.copy()
        if fallback_depths is not None:
            resolutions[:, 0] = fallback_depths.shape[2]
            resolutions[:, 1] = fallback_depths.shape[1]
        return SeedingResult(
            request_id=req.request_id,
            cameras_to_world=req.cameras_to_world,
            focal_lengths=req.focal_lengths,
            principal_points=req.principal_points,
            resolutions=resolutions,
            depths=None if req.depths is not None else fallback_depths,
        )


@dataclasses.dataclass(kw_only=True)
class InferenceRequest(RequestBase):
    """Generate frames along a camera path (api_types.py:298-332)."""

    timestamps: Optional[np.ndarray] = None  # (B,)
    framerate: float = 24.0
    return_depths: bool = False
    prompt: str = ""

    def _array_fields(self):
        return super()._array_fields() + ["timestamps"]


@dataclasses.dataclass(kw_only=True)
class InferenceResult(RequestBase):
    """Generated frames (+ optional depths) (api_types.py:334-374)."""

    images: np.ndarray = None  # (B, H, W, 3) uint8
    depths: Optional[np.ndarray] = None  # (B, H, W)
    runtime_ms: float = 0.0

    def _array_fields(self):
        return super()._array_fields() + ["images", "depths"]

    def save_images(self, directory: str) -> None:
        import os

        from PIL import Image

        os.makedirs(directory, exist_ok=True)
        for i, img in enumerate(self.images):
            Image.fromarray(img).save(f"{directory}/{i:05d}.png")

    def compress(self, format_rgb=None,
                 format_depth=None) -> "CompressedInferenceResult":
        """Per-buffer compression of the result frames
        (api_types.py:377-430 CompressedInferenceResult role)."""
        from gen3c_tpu_torch.serving.encoding import (
            CompressionFormat,
            compress_images,
        )

        format_rgb = format_rgb or CompressionFormat.JPG
        format_depth = format_depth or CompressionFormat.NPZ
        images = self.images
        if images is not None and images.dtype == np.uint8:
            images = images.astype(np.float32) / 255.0
        images_c = compress_images(images, format_rgb)
        depths_c = compress_images(self.depths, format_depth, is_depth=True)
        kwargs = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
        }
        kwargs["images"] = None
        kwargs["depths"] = None
        return CompressedInferenceResult(
            images_compressed=images_c,
            images_format=format_rgb,
            depths_compressed=depths_c,
            depths_format=None if depths_c is None else format_depth,
            **kwargs,
        )


@dataclasses.dataclass(kw_only=True)
class CompressedInferenceResult(InferenceResult):
    """InferenceResult with compressed frame buffers (api_types.py:377-430
    parity, minus MP4 — no ffmpeg in the target image). decompress()
    restores float 0..1 images; pad/trim also adjusts the buffers."""

    images_compressed: list = None  # list[bytes]
    images_format: object = None  # CompressionFormat
    depths_compressed: Optional[list] = None
    depths_format: object = None

    def __post_init__(self):
        assert (self.resolutions is not None) or (self.images is not None), (
            "CompressedInferenceResult: at least one of resolutions or "
            "images must be provided"
        )
        w, h = self.resolution()
        if self.images is None:
            self.images = np.empty((0, h, w, 3), np.float32)
        if self.depths is None and self.depths_compressed is not None:
            self.depths = np.empty((0, h, w), np.float32)
        assert self.images.shape[0] == 0, (
            "CompressedInferenceResult should not carry raw image data"
        )
        if self.depths_compressed is not None:
            from gen3c_tpu_torch.serving.encoding import CompressionFormat

            if self.images_format != CompressionFormat.NPZ:
                assert self.depths_format is not None

    def _adjust_frame_count(self, n_frames: int) -> None:
        from gen3c_tpu_torch.serving.encoding import pad_or_trim_encoded_buffers

        super()._adjust_frame_count(n_frames)
        self.images_compressed = pad_or_trim_encoded_buffers(
            self.images_compressed, self.images_format, n_frames
        )
        self.depths_compressed = pad_or_trim_encoded_buffers(
            self.depths_compressed, self.depths_format, n_frames
        )

    def decompress(self) -> None:
        from gen3c_tpu_torch.serving.encoding import decompress_buffer

        self.images = decompress_buffer(
            self.images_compressed, self.images_format
        )
        self.depths = decompress_buffer(
            self.depths_compressed, self.depths_format, is_depth=True
        )

    def save_images(self, directory: str) -> None:
        """Write the compressed buffers directly (api_types.py:432-455)."""
        import os

        os.makedirs(directory, exist_ok=True)
        ext = self.images_format.value
        for i, buf in enumerate(self.images_compressed):
            with open(os.path.join(directory, f"{i:05d}.{ext}"), "wb") as f:
                f.write(buf)
