"""Foreground occlusion masking by ray-triangle intersection (port of
gen3c_tpu/ops/raycast.py).

Splatted pixels that land behind a mesh built from the depth-discontinuity
boundary of their source frame are culled:

  * ``build_boundary_mesh``: the boundary region of a point grid,
    triangulated at 1/4 resolution, built on the points' device (the JAX
    version copies each item to the host for numpy);
  * ``mesh_depth_map``: the mesh's z-depth from the target camera, one ray
    per pixel through kernel K6 (``kernels.ray_triangle_depth``);
  * ``apply_foreground_masking``: pixels whose mesh z-depth + 0.02 is
    nearer than their splatted z-depth are cleared.

The number of triangles depends on the data, so items go one at a time and
K6 takes each mesh's triangles as they are: no power-of-two padding. All
math is fp32 (the resize weights fp64, as the JAX version's numpy); the
projections are einsums, full fp32 on the card while TF32 matmul stays off
(PyTorch's default).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.ops.geometry import pixel_rays, project_points

DEPTH_MARGIN = 0.02
MESH_DOWNSAMPLE = 4


def _resize_coords(n_out: int, n_in: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bilinear source rows (or columns) of an align_corners=False resize
    with edge clamp: (lower index, upper index, fp64 weight of the upper)."""
    c = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * (n_in / n_out)
         - 0.5).clamp(0, n_in - 1)
    i0 = torch.floor(c).long().clamp(0, n_in - 1)
    return i0, (i0 + 1).clamp(max=n_in - 1), c - i0


def build_boundary_mesh(cam_points: torch.Tensor, boundary_mask: torch.Tensor,
                        downsample: int = MESH_DOWNSAMPLE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triangulate the boundary region of a (H, W, 3) point grid at
    1/downsample resolution: (vertices (V, 3) fp32, faces (T, 3) int64).

    The points are resized bilinearly (align_corners=False, edge clamp, the
    blend in fp64), the (H, W) bool mask by nearest (row floor(i H / h')),
    and every 2x2 patch with a masked corner gives two triangles, in
    gen3c_tpu's order.
    """
    H, W = cam_points.shape[:2]
    new_h, new_w = H // downsample, W // downsample
    dev = cam_points.device
    y0, y1, wy = _resize_coords(new_h, H, dev)
    x0, x1, wx = _resize_coords(new_w, W, dev)
    wy, wx = wy[:, None, None], wx[None, :, None]
    pts = cam_points.float()
    a, b = pts[y0][:, x0].double(), pts[y0][:, x1].double()
    c, d = pts[y1][:, x0].double(), pts[y1][:, x1].double()
    grid = a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx

    ys = (torch.arange(new_h, dtype=torch.float64, device=dev) * (H / new_h)).long().clamp(max=H - 1)
    xs = (torch.arange(new_w, dtype=torch.float64, device=dev) * (W / new_w)).long().clamp(max=W - 1)
    msk = boundary_mask.bool()[ys][:, xs]
    valid = msk[:-1, :-1] | msk[:-1, 1:] | msk[1:, :-1] | msk[1:, 1:]
    vh, vw = torch.nonzero(valid, as_tuple=True)
    if vh.numel() == 0:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int64, device=dev))
    vidx = torch.arange(new_h * new_w, device=dev).reshape(new_h, new_w)
    tl, tr = vidx[vh, vw], vidx[vh, vw + 1]
    bl, br = vidx[vh + 1, vw], vidx[vh + 1, vw + 1]
    faces = torch.cat([torch.stack([tl, tr, bl], 1), torch.stack([tr, br, bl], 1)], dim=0)
    return grid.reshape(-1, 3).float(), faces


def mesh_depth_map(cam_points: torch.Tensor, boundary_mask: torch.Tensor,
                   intrinsic: torch.Tensor) -> Optional[torch.Tensor]:
    """The boundary mesh's z-depth seen from the camera of ``intrinsic``
    (3, 3): (H, W), 0 where no triangle is hit; None if the mesh is empty."""
    H, W = cam_points.shape[:2]
    vertices, faces = build_boundary_mesh(cam_points, boundary_mask)
    if faces.shape[0] == 0:
        return None
    rays = pixel_rays(H, W, intrinsic.float()[None])[0]  # (H, W, 3) unit
    dist = kernels.ray_triangle_depth(rays.reshape(-1, 3), vertices[faces[:, 0]],
                                      vertices[faces[:, 1]], vertices[faces[:, 2]])
    return dist.reshape(H, W) * rays[..., 2]  # distance along the ray -> z-depth


def apply_foreground_masking(
    warped: torch.Tensor,  # (M, C, H, W)
    mask2: torch.Tensor,  # (M, 1, H, W)
    warped_depth: torch.Tensor,  # (M, H, W)
    world_points: torch.Tensor,  # (M, H, W, 3) source world points
    boundary_mask: torch.Tensor,  # (M, H, W) bool
    w2cs: torch.Tensor,  # (M, 4, 4) target cameras
    ks: torch.Tensor,  # (M, 3, 3)
    depth_margin: float = DEPTH_MARGIN,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cull the splatted pixels that the boundary mesh hides: where the
    mesh's z-depth (> 0) plus ``depth_margin`` is below the splatted depth,
    warped becomes -1 and mask and depth 0. An item whose mesh is empty is
    left as it was; every other item's warped goes through
    (warped + 1) * keep - 1, as in gen3c_tpu. Updates the three tensors in
    place and returns them."""
    _, cam_points = project_points(world_points, w2cs, ks)
    bmask = boundary_mask.bool()
    for i in range(warped.shape[0]):
        mesh_z = mesh_depth_map(cam_points[i], bmask[i], ks[i])
        if mesh_z is None:
            continue
        keep = (~(((mesh_z + depth_margin) < warped_depth[i]) & (mesh_z > 0))).to(warped.dtype)
        warped[i] = (warped[i] + 1) * keep[None] - 1
        mask2[i] *= keep[None]
        warped_depth[i] *= keep
    return warped, mask2, warped_depth
