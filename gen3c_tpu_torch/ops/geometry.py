"""Point-cloud geometry and forward-splat rendering in PyTorch.

Port of gen3c_tpu/ops/geometry.py (same functions, same shapes, same
argument order). The splat itself is ``gen3c_tpu_torch.kernels.splat``
(K5): a CUDA atomic-scatter kernel on the card, ``index_add_`` on the CPU.
All math is fp32; the batched 3x3 products are einsums, which run in full
fp32 on the card as long as TF32 matmul stays off (PyTorch's default).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from gen3c_tpu_torch import kernels


def _inv(m: torch.Tensor) -> torch.Tensor:
    """fp32 batched inverse, cast back to the input dtype."""
    return torch.linalg.inv(m.float()).to(m.dtype)


def create_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Dense (2, h, w) grid of (x, y) pixel coordinates."""
    x = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    y = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    return torch.stack([x, y], dim=0)


def _unit_depth_rays(h: int, w: int, intrinsic: torch.Tensor) -> torch.Tensor:
    """Unnormalised K^-1 [x, y, 1] per pixel: (b, h, w, 3)."""
    grid = create_grid(h, w, intrinsic.dtype, intrinsic.device)
    pos = torch.stack([grid[0], grid[1], torch.ones_like(grid[0])], dim=-1)
    return torch.einsum("bij,hwj->bhwi", _inv(intrinsic), pos)


def pixel_rays(h: int, w: int, intrinsic: torch.Tensor) -> torch.Tensor:
    """Unit-norm camera rays through every pixel, intrinsic (b, 3, 3) ->
    (b, h, w, 3) (gen3c_tpu's ``pixel_rays``; a zero ray stays zero)."""
    unnorm = _unit_depth_rays(h, w, intrinsic)
    norm = torch.sqrt((unnorm * unnorm).sum(dim=-1, keepdim=True))
    return unnorm / torch.where(norm == 0, torch.ones_like(norm), norm)


def unproject_points(
    depth: torch.Tensor,
    w2c: torch.Tensor,
    intrinsic: torch.Tensor,
    is_depth: bool = True,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(b,1,h,w) depth -> (b,h,w,3) world points, zero where masked out or
    depth <= 0."""
    b, _, h, w = depth.shape
    if mask is None:
        mask = depth > 0
    if mask.ndim == 4:
        mask = mask[:, 0]
    mask = mask.bool()
    unnorm = _unit_depth_rays(h, w, intrinsic)
    if is_depth:
        cam = depth[:, 0, :, :, None] * unnorm
    else:
        norm = torch.linalg.vector_norm(unnorm, dim=-1, keepdim=True)
        cam = depth[:, 0, :, :, None] * (unnorm / (norm + 1e-8))
    c2w = _inv(w2c)
    world = torch.einsum("bij,bhwj->bhwi", c2w[:, :3, :3], cam) + c2w[:, None, None, :3, 3]
    return torch.where(mask[..., None], world, torch.zeros_like(world))


def project_points(
    world_points: torch.Tensor, w2c: torch.Tensor, intrinsic: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b,h,w,3) world points -> (K @ cam (b,h,w,3), cam (b,h,w,3))."""
    cam = torch.einsum("bij,bhwj->bhwi", w2c[:, :3, :3], world_points) + w2c[:, None, None, :3, 3]
    proj = torch.einsum("bij,bhwj->bhwi", intrinsic, cam)
    return proj, cam


def compute_transformed_points(
    depth: torch.Tensor,
    transformation1: torch.Tensor,
    transformation2: torch.Tensor,
    intrinsic1: torch.Tensor,
    is_depth: bool = True,
    intrinsic2: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Homogeneous target-pixel positions of each source pixel:
    (trans_norm_points (b,h,w,3), cam_points (b,h,w,3))."""
    b, _, h, w = depth.shape
    if intrinsic2 is None:
        intrinsic2 = intrinsic1
    transformation = torch.einsum("bij,bjk->bik", transformation2, _inv(transformation1))
    unnorm = _unit_depth_rays(h, w, intrinsic1)
    if is_depth:
        cam1 = depth[:, 0, :, :, None] * unnorm
    else:
        norm = torch.linalg.vector_norm(unnorm, dim=-1, keepdim=True)
        cam1 = depth[:, 0, :, :, None] * (unnorm / norm)
    cam2 = (torch.einsum("bij,bhwj->bhwi", transformation[:, :3, :3], cam1)
            + transformation[:, None, None, :3, 3])
    proj = torch.einsum("bij,bhwj->bhwi", intrinsic2, cam2)
    return proj, cam2


def bilinear_splatting(
    frame1: torch.Tensor,
    mask1: Optional[torch.Tensor],
    depth1: torch.Tensor,
    flow12: torch.Tensor,
    flow12_mask: Optional[torch.Tensor] = None,
    is_image: bool = False,
    depth_weight_scale: float = 50.0,
    group: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear forward splat with log-depth soft z-weights (K5).

    ``group`` consecutive batch entries share one log-depth maximum; the
    default (the whole batch) is the JAX semantics.
    """
    return kernels.splat(frame1, mask1, depth1, flow12, flow12_mask, is_image,
                         depth_weight_scale, group)


def reliable_depth_mask(
    depth: torch.Tensor, window_size: int = 5, ratio_thresh: float = 0.05,
    eps: float = 1e-6,
) -> torch.Tensor:
    """(b,[1,]h,w) depth -> (b,1,h,w) bool, True where the local
    (max - min) / mean < ratio_thresh. The mean counts the zero padding
    (avg_pool2d count_include_pad=True), as the reference does."""
    if window_size % 2 != 1:
        raise ValueError(f"window_size must be odd, got {window_size}")
    d = depth[:, None] if depth.ndim == 3 else depth
    pad = window_size // 2
    local_max = F.max_pool2d(d, window_size, stride=1, padding=pad)
    local_min = -F.max_pool2d(-d, window_size, stride=1, padding=pad)
    local_mean = F.avg_pool2d(d, window_size, stride=1, padding=pad, count_include_pad=True)
    ratio = (local_max - local_min) / (local_mean + eps)
    return (ratio < ratio_thresh) & (d > 0)


def forward_warp(
    frame1: torch.Tensor,
    mask1: Optional[torch.Tensor],
    transformation2: torch.Tensor,
    intrinsic2: torch.Tensor,
    world_points1: torch.Tensor,
    is_image: bool = True,
    render_depth: bool = False,
    group: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Warp frame1 (with known world points) into the target cameras.

    Returns (warped (b,c,h,w), mask2 (b,1,h,w), warped_depth (b,h,w) or
    None, flow12 (b,2,h,w)). ``group``: see ``bilinear_splatting``.
    """
    b, c, h, w = frame1.shape
    dtype = frame1.dtype
    if mask1 is None:
        mask1 = torch.ones((b, 1, h, w), dtype=dtype, device=frame1.device)
    trans_points, _ = project_points(world_points1, transformation2, intrinsic2)
    mask1 = mask1 * (trans_points[..., 2] > 0)[:, None].to(dtype)
    trans_coords = trans_points[..., :2] / (trans_points[..., 2:3] + 1e-7)
    trans_coords = trans_coords.permute(0, 3, 1, 2)
    trans_depth = trans_points[..., 2][:, None]
    flow12 = trans_coords - create_grid(h, w, dtype, frame1.device)[None]

    warped, mask2 = bilinear_splatting(frame1, mask1, trans_depth, flow12, None,
                                       is_image=is_image, group=group)
    warped_depth = None
    if render_depth:
        warped_depth = bilinear_splatting(trans_depth, mask1, trans_depth, flow12, None,
                                          is_image=False, group=group)[0][:, 0]
    return warped, mask2, warped_depth, flow12
