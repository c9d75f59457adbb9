"""Camera trajectories and depth alignment.

Port of gen3c_tpu/ops/camera.py. Trajectories are host numpy and port
exactly; they come back as fp32 torch tensors on the requested device.
The non-rigid depth alignment is the same 100-step Adam(lr=1e-3) fit of a
per-pixel scale map, written as a ``torch.optim.Adam`` loop.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

TRAJECTORY_TYPES = (
    "left",
    "right",
    "up",
    "down",
    "zoom_in",
    "zoom_out",
    "clockwise",
    "counterclockwise",
    "none",
)
CAMERA_ROTATIONS = ("center_facing", "no_rotation", "trajectory_aligned")


def look_at_matrix(camera_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """4x4 look-at view matrix, Y-up convention."""
    forward = (target - camera_pos).astype(np.float64)
    forward = forward / np.linalg.norm(forward)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, forward)
    right = right / np.linalg.norm(right)
    up = np.cross(forward, right)
    m = np.eye(4)
    m[0, :3] = right
    m[1, :3] = up
    m[2, :3] = forward
    m[:3, 3] = -camera_pos
    return m


def create_horizontal_trajectory(
    world_to_camera: np.ndarray,
    center_depth: float,
    positive: bool = True,
    n_steps: int = 13,
    distance: float = 0.1,
    axis: str = "x",
    camera_rotation: str = "center_facing",
) -> np.ndarray:
    """Linear camera move along one axis."""
    look_at = np.array([0.0, 0.0, center_depth])
    sign = 1.0 if positive else -1.0
    mats = []
    for i in range(n_steps):
        step = i * distance * center_depth / n_steps * sign
        pos = np.zeros(3)
        pos["xyz".index(axis)] = step
        if camera_rotation == "trajectory_aligned":
            target = look_at + pos * 2
        elif camera_rotation == "center_facing":
            target = look_at
        elif camera_rotation == "no_rotation":
            target = look_at + pos
        else:
            raise ValueError(f"Unknown camera_rotation {camera_rotation}")
        mats.append(look_at_matrix(pos, target))
    return np.stack(mats) @ world_to_camera[None]


def create_spiral_trajectory(
    world_to_camera: np.ndarray,
    center_depth: float,
    radius_x: float = 0.03,
    radius_y: float = 0.02,
    radius_z: float = 0.0,
    positive: bool = True,
    camera_rotation: str = "center_facing",
    n_steps: int = 13,
    start_from_zero: bool = True,
    num_circles: int = 1,
) -> np.ndarray:
    """Spiral/orbit camera move."""
    look_at = np.array([0.0, 0.0, center_depth])
    theta_max = 2 * math.pi * num_circles
    mats = []
    for i in range(n_steps):
        theta = theta_max * i / (n_steps - 1)
        if start_from_zero:
            x = radius_x * (math.cos(theta) - 1) * (1 if positive else -1) * center_depth
        else:
            x = radius_x * math.cos(theta) * center_depth
        y = radius_y * math.sin(theta) * center_depth
        z = radius_z * math.sin(theta) * center_depth
        pos = np.array([x, y, z])
        if camera_rotation == "center_facing":
            m = look_at_matrix(pos, look_at)
        elif camera_rotation == "trajectory_aligned":
            m = look_at_matrix(pos, look_at + pos * 2)
        elif camera_rotation == "no_rotation":
            m = look_at_matrix(pos, look_at + pos)
        else:
            raise ValueError(f"Unknown camera_rotation {camera_rotation}")
        mats.append(m)
    return np.stack(mats) @ world_to_camera[None]


def generate_camera_trajectory(
    trajectory_type: str,
    initial_w2c: np.ndarray,
    initial_intrinsics: np.ndarray,
    num_frames: int,
    movement_distance: float,
    camera_rotation: str = "center_facing",
    center_depth: float = 1.0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1, num_frames, 4, 4) w2cs and (1, num_frames, 3, 3) Ks, fp32."""
    initial_w2c = np.asarray(initial_w2c, dtype=np.float64)
    if trajectory_type == "none":
        w2cs = np.repeat(initial_w2c[None], num_frames, axis=0)
    elif trajectory_type in ("clockwise", "counterclockwise"):
        w2cs = create_spiral_trajectory(
            world_to_camera=initial_w2c,
            center_depth=center_depth,
            n_steps=num_frames,
            positive=trajectory_type == "clockwise",
            camera_rotation=camera_rotation,
            radius_x=movement_distance,
            radius_y=movement_distance,
        )
    else:
        positive, axis = {
            "left": (False, "x"),
            "right": (True, "x"),
            "up": (False, "y"),
            "down": (True, "y"),
            "zoom_in": (True, "z"),
            "zoom_out": (False, "z"),
        }.get(trajectory_type, (None, None))
        if axis is None:
            raise ValueError(f"Unsupported trajectory type: {trajectory_type}")
        w2cs = create_horizontal_trajectory(
            world_to_camera=initial_w2c,
            center_depth=center_depth,
            n_steps=num_frames,
            positive=positive,
            axis=axis,
            distance=movement_distance,
            camera_rotation=camera_rotation,
        )
    w2cs = torch.from_numpy(w2cs[None].astype(np.float32)).to(device)
    initial_intrinsics = np.asarray(initial_intrinsics, dtype=np.float32)
    if initial_intrinsics.ndim == 2:
        ks = np.repeat(initial_intrinsics[None], num_frames, axis=0)[None]
    else:
        ks = initial_intrinsics[None]
    return w2cs, torch.from_numpy(np.ascontiguousarray(ks)).to(device)


# --------------------------- depth alignment ---------------------------


def _align_inv_depth_to_depth(
    source_inv_depth: np.ndarray,
    target_depth: np.ndarray,
    target_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Affine (scale + bias in inverse depth) least-squares alignment with
    10/90% quantile outlier rejection on both sides (host numpy)."""
    with np.errstate(divide="ignore"):
        target_inv = 1.0 / target_depth  # inf where depth == 0; masked below
    source_mask = source_inv_depth > 0
    tmask = target_depth > 0
    if target_mask is not None:
        tmask = np.logical_and(target_mask > 0, tmask)
    s_lo, s_hi = np.quantile(source_inv_depth[source_mask], [0.1, 0.9])
    t_lo, t_hi = np.quantile(target_inv[tmask], [0.1, 0.9])
    source_mask = (source_inv_depth > s_lo) & (source_inv_depth < s_hi)
    tmask = (target_inv > t_lo) & (target_inv < t_hi)
    mask = source_mask & tmask
    s = source_inv_depth[mask].reshape(-1, 1)
    t = target_inv[mask].reshape(-1, 1)
    a = np.concatenate([s, np.ones_like(s)], axis=1)
    sol, *_ = np.linalg.lstsq(a, t, rcond=None)
    scale, bias = sol[0, 0], sol[1, 0]
    return 1.0 / (source_inv_depth * scale + bias)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose gradient at 0 is +1, as jax.numpy.abs (torch.abs gives 0).
    The scale-map fit starts at an exact optimum of its smoothness term,
    so the subgradient choice decides the first Adam step."""
    return x * torch.where(x >= 0, 1.0, -1.0).detach()


def _nonrigid_scale_map(
    source_depth: torch.Tensor,  # (H, W)
    target_points: torch.Tensor,  # (H, W, 3)
    target_mask: torch.Tensor,  # (H, W) bool
    k: torch.Tensor,
    c2w: torch.Tensor,
) -> torch.Tensor:
    """Per-pixel scale map s.t. the scaled source depth unprojects onto the
    target points: Adam(lr=1e-3), 100 steps, masked L1 data term plus 0.1 x
    |boxfilter3x3(s) - s| smoothness. ``c2w`` is passed where the unproject
    expects w2c, as in the JAX package."""
    from gen3c_tpu_torch.ops.geometry import unproject_points

    h, w = source_depth.shape
    maskf = target_mask.float()
    n_masked = torch.clamp(maskf.sum(), min=1.0)
    kernel = torch.ones((1, 1, 3, 3), dtype=torch.float32, device=source_depth.device) / 9.0
    sc = torch.ones((h, w), dtype=torch.float32, device=source_depth.device, requires_grad=True)
    opt = torch.optim.Adam([sc], lr=1e-3)
    with torch.enable_grad():
        for _ in range(100):
            opt.zero_grad(set_to_none=True)
            scaled = (source_depth * sc)[None, None]
            src_pts = unproject_points(
                scaled, c2w[None], k[None], is_depth=True, mask=target_mask[None, None]
            )[0]
            diff = _abs(src_pts - target_points) * maskf[..., None]
            data_loss = diff.sum() / (n_masked * 3.0)
            smoothed = F.conv2d(sc[None, None], kernel, padding=1)[0, 0]
            arap = _abs(smoothed - sc).mean()
            (data_loss + 0.1 * arap).backward()
            opt.step()
    return sc.detach()


def align_depth(
    source_depth: torch.Tensor,
    target_depth: torch.Tensor,
    target_mask: torch.Tensor,
    k: Optional[torch.Tensor] = None,
    c2w: Optional[torch.Tensor] = None,
    alignment_method: str = "rigid",
) -> torch.Tensor:
    """Align a new (H, W) depth map to depth rendered from the 3D cache.
    Returns fp32 on source_depth's device."""
    device = source_depth.device
    src = source_depth.detach().float().cpu().numpy()
    tgt = target_depth.detach().float().cpu().numpy()
    msk = target_mask.detach().cpu().numpy().astype(bool)
    rigid = torch.from_numpy(
        np.asarray(_align_inv_depth_to_depth(1.0 / src, tgt, msk), np.float32)
    ).to(device)
    if alignment_method == "rigid":
        return rigid
    if alignment_method != "non_rigid":
        raise ValueError(f"Unsupported alignment method: {alignment_method}")
    if k is None or c2w is None:
        raise ValueError("k and c2w are required for non-rigid alignment")
    from gen3c_tpu_torch.ops.geometry import unproject_points

    mask_t = target_mask.to(device=device, dtype=torch.bool)
    k = k.to(device=device, dtype=torch.float32)
    c2w = c2w.to(device=device, dtype=torch.float32)
    target_pts = unproject_points(
        target_depth.to(device=device, dtype=torch.float32)[None, None],
        c2w[None], k[None], is_depth=True, mask=mask_t[None, None],
    )[0]
    return rigid * _nonrigid_scale_map(rigid, target_pts, mask_t, k, c2w)
