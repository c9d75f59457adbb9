"""The GEN3C 3D cache: point clouds splatted into warped condition buffers.

Port of gen3c_tpu/cache/cache3d.py (``Cache3DBase``, ``Cache3DBuffer``).
The cache lives on its device; rendering splats the N source buffers into
the target cameras in chunks of targets, one K5 launch per chunk with a
log-depth maximum per target frame (``group=N``), which is what one
``forward_warp`` call per target computes in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gen3c_tpu_torch.ops import geometry
from gen3c_tpu_torch.ops.camera import align_depth

_DESIRED = ["B", "F", "N", "V", "C", "H", "W"]


def _canonicalize(x: torch.Tensor, input_format: Optional[list]) -> torch.Tensor:
    """Permute/expand an input tensor into canonical B F N V C H W order;
    missing dims are inserted with size 1."""
    if input_format is None:
        if x.ndim != 4:
            raise ValueError(f"expected a (B, C, H, W) tensor, got {tuple(x.shape)}")
        input_format = ["B", "C", "H", "W"]
    fmt_idx = {d: i for i, d in enumerate(input_format)}
    x = x.permute([fmt_idx[d] for d in _DESIRED if d in fmt_idx])
    for i, d in enumerate(_DESIRED):
        if d not in fmt_idx:
            x = x.unsqueeze(i)
    return x


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


class Cache3DBase:
    """Source frames + world points; renders warped buffers per target.

    Depth maps are clamped to [0, 100] with NaN -> 100 before unprojection.
    """

    # targets splatted per launch: bounds the temporaries at 704x1280
    render_chunk = 8

    def __init__(
        self,
        input_image,
        input_depth=None,
        input_w2c=None,
        input_intrinsics=None,
        input_mask=None,
        input_format: Optional[list] = None,
        is_depth: bool = True,
        filter_points_threshold: float = 1.0,
        foreground_masking: bool = False,
        device=None,
    ):
        if foreground_masking:
            raise NotImplementedError(
                "foreground_masking (ops/raycast.py, kernel K6) is not ported yet"
            )
        self.device = torch.device(device) if device is not None else torch.as_tensor(input_image).device
        self.is_depth = is_depth
        self.filter_points_threshold = filter_points_threshold

        img = _canonicalize(_as_f32(input_image, self.device), input_format)
        self.input_image = img
        B, F, N, V, C, H, W = img.shape
        self.input_mask = (
            _canonicalize(_as_f32(input_mask, self.device), input_format)
            if input_mask is not None else None
        )
        depth = torch.nan_to_num(_as_f32(input_depth, self.device), nan=100.0).clamp(0.0, 100.0)
        pts = geometry.unproject_points(
            depth.reshape(-1, 1, H, W),
            _as_f32(input_w2c, self.device).reshape(-1, 4, 4),
            _as_f32(input_intrinsics, self.device).reshape(-1, 3, 3),
            is_depth=self.is_depth,
        )
        self.input_points = pts.reshape(B, F, N, V, H, W, 3)
        if self.filter_points_threshold < 1.0:
            dmask = geometry.reliable_depth_mask(
                depth.reshape(-1, 1, H, W), ratio_thresh=self.filter_points_threshold
            ).reshape(B, F, N, V, 1, H, W).float()
            self.input_mask = dmask if self.input_mask is None else self.input_mask * dmask

    def render_cache(
        self,
        target_w2cs,  # (B, F_target, 4, 4)
        target_intrinsics,  # (B, F_target, 3, 3)
        render_depth: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Render every buffer into every target camera.

        Returns (pixels (B,F,N,C,H,W) or depth (B,F,N,H,W), masks
        (B,F,N,1,H,W)).
        """
        target_w2cs = _as_f32(target_w2cs, self.device)
        target_intrinsics = _as_f32(target_intrinsics, self.device)
        B, F, N, V, C, H, W = self.input_image.shape
        bs, F_t = target_w2cs.shape[:2]
        if not (bs == B == 1 and V == 1 and F == 1):
            raise ValueError("renders take one batch entry, one view and a static (F=1) cache")
        images = self.input_image[0, 0, :, 0]  # (N, C, H, W)
        points = self.input_points[0, 0, :, 0]
        masks = (self.input_mask[0, 0, :, 0] if self.input_mask is not None
                 else torch.ones((N, 1, H, W), device=self.device))
        w2cs = target_w2cs.reshape(F_t, 4, 4)
        ks = target_intrinsics.reshape(F_t, 3, 3)

        out = torch.empty((F_t, N, 1 if render_depth else C, H, W), device=self.device)
        out_mask = torch.empty((F_t, N, 1, H, W), device=self.device)
        for s in range(0, F_t, self.render_chunk):
            e = min(s + self.render_chunk, F_t)
            n_t = e - s
            img = images.expand(n_t, N, C, H, W)
            pts = points.expand(n_t, N, H, W, 3)
            msk = masks.expand(n_t, N, 1, H, W)
            warped, mask2, depth, _ = geometry.forward_warp(
                img.reshape(n_t * N, C, H, W),
                msk.reshape(n_t * N, 1, H, W),
                w2cs[s:e, None].expand(n_t, N, 4, 4).reshape(n_t * N, 4, 4),
                ks[s:e, None].expand(n_t, N, 3, 3).reshape(n_t * N, 3, 3),
                pts.reshape(n_t * N, H, W, 3),
                is_image=True,
                render_depth=render_depth,
                group=N,
            )
            res = depth[:, None] if render_depth else warped
            out[s:e] = res.reshape(n_t, N, -1, H, W)
            out_mask[s:e] = mask2.reshape(n_t, N, 1, H, W)
        masks_out = out_mask.reshape(B, F_t, N, 1, H, W)
        if render_depth:
            return out.reshape(B, F_t, N, H, W), masks_out
        return out.reshape(B, F_t, N, C, H, W), masks_out


class Cache3DBuffer(Cache3DBase):
    """Ring buffer of the newest frames, newest first along N."""

    def __init__(self, frame_buffer_max: int = 0, noise_aug_strength: float = 0.0,
                 seed: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.frame_buffer_max = frame_buffer_max
        self.noise_aug_strength = noise_aug_strength
        # the JAX package draws this noise from jax.random; same
        # distribution, different numbers
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    def render_cache(self, target_w2cs, target_intrinsics, render_depth=False):
        pixels, masks = super().render_cache(target_w2cs, target_intrinsics, render_depth)
        if not render_depth and self.noise_aug_strength > 0:
            # per-buffer noise (N-1-i) * strength: buffer 0, the newest,
            # gets the strongest
            noise = torch.randn(pixels.shape, generator=self._generator,
                                device=pixels.device, dtype=pixels.dtype)
            n = pixels.shape[2]
            per_buffer = torch.arange(n - 1, -1, -1, device=pixels.device,
                                      dtype=pixels.dtype) * self.noise_aug_strength
            pixels = pixels + noise * per_buffer.reshape(1, 1, -1, 1, 1, 1)
        return pixels, masks

    def update_cache(
        self,
        new_image,  # (B, C, H, W)
        new_depth,  # (B, 1, H, W)
        new_w2c,  # (B, 4, 4)
        new_mask=None,
        new_intrinsics=None,
        depth_alignment: bool = True,
        alignment_method: str = "non_rigid",
    ) -> None:
        """Insert a newly generated frame, aligning its depth to the cache."""
        dev = self.device
        new_image = _as_f32(new_image, dev)
        new_depth = torch.nan_to_num(_as_f32(new_depth, dev), nan=1e4).clamp(0, 1e4)
        new_w2c = _as_f32(new_w2c, dev)
        new_intrinsics = _as_f32(new_intrinsics, dev)

        if depth_alignment:
            target_depth, target_mask = self.render_cache(
                new_w2c[:, None], new_intrinsics[:, None], render_depth=True
            )
            new_depth = align_depth(
                new_depth[0, 0],
                target_depth[0, 0, 0],
                target_mask[0, 0, 0, 0] > 0,
                k=new_intrinsics[0],
                c2w=torch.linalg.inv(new_w2c[0]),
                alignment_method=alignment_method,
            ).reshape(new_depth.shape)

        new_points = geometry.unproject_points(new_depth, new_w2c, new_intrinsics,
                                               is_depth=self.is_depth)
        if self.filter_points_threshold < 1.0:
            dmask = geometry.reliable_depth_mask(
                new_depth, ratio_thresh=self.filter_points_threshold
            ).float()
            new_mask = dmask if new_mask is None else _as_f32(new_mask, dev) * dmask

        if self.frame_buffer_max > 1:
            ni = new_image[:, None, None, None]
            npts = new_points[:, None, None, None]
            nm = new_mask[:, None, None, None] if self.input_mask is not None else None
            # below capacity: prepend; at capacity: replace the newest slot
            keep = 0 if self.input_image.shape[2] < self.frame_buffer_max else 1
            self.input_image = torch.cat([ni, self.input_image[:, :, keep:]], dim=2)
            self.input_points = torch.cat([npts, self.input_points[:, :, keep:]], dim=2)
            if nm is not None:
                self.input_mask = torch.cat([nm, self.input_mask[:, :, keep:]], dim=2)
        else:
            self.input_image = new_image[:, None, None, None]
            self.input_points = new_points[:, None, None, None]
