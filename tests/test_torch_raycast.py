"""The port's foreground masking (ops/raycast.py, K6's plain version) against
gen3c_tpu on the CPU.

Both packages get the same seeded numpy inputs. K6's plain version repeats
the JAX formula operation for operation (no fused multiply-adds); XLA
rounds a few of the same operations otherwise (ray directions differ by up
to 2 ulp), so the two agree to fp32 rounding and no further. A ray that
grazes an edge decides u >= 0 or u + v <= 1 by a rounding, so its hit may
flip, and where two triangles lie within rounding of the ray (the steep
"curtain" triangles of a boundary mesh) the nearest may be the other one.
Held: hit masks differ on at most 1e-3 of ordinary rays (5% of rays aimed
exactly at a grid edge or vertex); on rays both call a hit, at most 1e-3
of them differ by more than 1e-5 relative and none by more than 1e-3. The
mesh's faces are equal and its vertices within 1e-6 (fp64 resize weights
on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.ops import geometry as jgeometry
from gen3c_tpu.ops import raycast as jraycast
from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.kernels.reference import ray_triangle_depth_reference
from gen3c_tpu_torch.ops import geometry, raycast

FLIP_TOL = 1e-3  # of ordinary rays
GRAZING_FLIP_TOL = 0.05  # of rays aimed exactly at an edge or a vertex
T_RTOL = 1e-5
T_RTOL_OTHER_TRIANGLE = 1e-3  # the few rays whose nearest triangle rounding decides


def _jax_depth(dirs, v0, v1, v2, valid=None):
    valid = np.ones(len(v0), bool) if valid is None else valid
    return np.asarray(jraycast.ray_triangle_depth(*(jnp.asarray(a) for a in (dirs, v0, v1, v2)),
                                                  jnp.asarray(valid)))


def _port_depth(dirs, v0, v1, v2, valid=None):
    args = [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in (dirs, v0, v1, v2)]
    if valid is None:
        return kernels.ray_triangle_depth(*args).numpy()
    return ray_triangle_depth_reference(*args, tri_valid=torch.from_numpy(valid)).numpy()


def _assert_depths_close(got, want, flip_tol=FLIP_TOL):
    flips = ((got > 0) != (want > 0)).mean()
    both = (got > 0) & (want > 0)
    assert flips <= flip_tol, flips
    rel = np.abs(got[both] - want[both]) / want[both]
    assert (rel > T_RTOL).mean() <= 1e-3 and rel.max(initial=0) <= T_RTOL_OTHER_TRIANGLE, \
        ((rel > T_RTOL).mean(), rel.max(initial=0))


def test_single_triangle_hit_distance():
    v0, v1, v2 = (np.array([p], np.float32) for p in ([-1, -1, 2], [1, -1, 2], [0, 1.5, 2]))
    dirs = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0]], np.float32)
    t = _port_depth(dirs, v0, v1, v2)
    np.testing.assert_allclose(t[0], 2.0, rtol=1e-5)
    assert t[1] == 0.0 and t[2] == 0.0  # behind the camera; parallel
    _assert_depths_close(t, _jax_depth(dirs, v0, v1, v2))


def test_nearest_of_two_triangles_wins():
    v0 = np.array([[-1, -1, 2], [-1, -1, 1]], np.float32)
    v1 = np.array([[1, -1, 2], [1, -1, 1]], np.float32)
    v2 = np.array([[0, 1.5, 2], [0, 1.5, 1]], np.float32)
    dirs = np.array([[0, 0, 1]], np.float32)
    t = _port_depth(dirs, v0, v1, v2)
    np.testing.assert_allclose(t[0], 1.0, rtol=1e-5)
    _assert_depths_close(t, _jax_depth(dirs, v0, v1, v2))


def test_padding_triangles_ignored():
    """The plain version takes the JAX version's padding mask; the port's
    dispatch takes no mask and answers an empty mesh with zeros."""
    rng = np.random.default_rng(0)
    v0, v1, v2 = (rng.uniform(-1, 1, (8, 3)).astype(np.float32) + [0, 0, 2] for _ in range(3))
    valid = np.zeros(8, bool)
    valid[:3] = True
    dirs = rng.standard_normal((64, 3)).astype(np.float32) * [0.3, 0.3, 1]
    got = _port_depth(dirs, v0, v1, v2, valid)
    _assert_depths_close(got, _jax_depth(dirs, v0, v1, v2, valid))
    np.testing.assert_array_equal(_port_depth(dirs, v0[:3], v1[:3], v2[:3]), got)
    empty = np.zeros((0, 3), np.float32)
    assert not _port_depth(dirs, empty, empty, empty).any()
    assert not _port_depth(dirs, v0, v1, v2, np.zeros(8, bool)).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ray_triangle_depth_matches_jax_on_a_grazing_mesh(seed):
    """A grid mesh in the plane z = 2 (shared edges), seeded random
    triangles, rays through the grid's vertices and edge midpoints (each
    grazes one or more edges) and rays parallel to the plane."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.arange(-4, 5), np.arange(-4, 5), indexing="ij"), -1)
    g = np.concatenate([g, np.full(g.shape[:2] + (1,), 2.0)], -1).astype(np.float32)
    tl, tr, bl, br = g[:-1, :-1], g[:-1, 1:], g[1:, :-1], g[1:, 1:]
    grid = [np.concatenate([a.reshape(-1, 3), b.reshape(-1, 3)]) for a, b in
            ((tl, tr), (tr, br), (bl, bl))]
    rand = [rng.uniform(-3, 3, (40, 3)).astype(np.float32) + [0, 0, 4] for _ in range(3)]
    v0, v1, v2 = (np.concatenate([a, b]) for a, b in zip(grid, rand))
    grazing = np.concatenate([g[..., :2].reshape(-1, 2), (g[:-1, :, :2] + [0.5, 0]).reshape(-1, 2),
                              (g[:, :-1, :2] + [0, 0.5]).reshape(-1, 2)])
    xy = np.concatenate([grazing, rng.uniform(-4, 4, (500, 2))]).astype(np.float32)
    dirs = np.concatenate([xy, np.full((len(xy), 1), 2.0, np.float32)], 1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    parallel = np.concatenate([rng.standard_normal((20, 2)), np.zeros((20, 1))], 1)
    dirs = np.concatenate([dirs, parallel.astype(np.float32)])
    got, want = _port_depth(dirs, v0, v1, v2), _jax_depth(dirs, v0, v1, v2)
    assert (want > 0).mean() > 0.5
    assert not got[-20:].any() and not want[-20:].any()
    n = len(grazing)
    _assert_depths_close(got[:n], want[:n], GRAZING_FLIP_TOL)
    _assert_depths_close(got[n:], want[n:])


def _object_depth(h, w, seed):
    """A smooth slanted plane with a few nearer discs: depth boundaries."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    depth = 2.5 - 0.8 * yy + 0.3 * np.sin(6 * xx)
    for _ in range(3):
        cy, cx, r = rng.uniform(0.25, 0.75), rng.uniform(0.25, 0.75), rng.uniform(0.08, 0.2)
        depth = np.where((yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2, rng.uniform(1.0, 1.4), depth)
    return depth.astype(np.float32)


def _cam_points(h, w, seed):
    depth = _object_depth(h, w, seed)
    k = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32)
    pts = np.asarray(jgeometry.unproject_points(jnp.asarray(depth[None, None]),
                                                jnp.eye(4)[None], jnp.asarray(k[None])))[0]
    bmask = ~np.asarray(jgeometry.reliable_depth_mask(jnp.asarray(depth[None, None])))[0, 0]
    return pts, bmask, k


@pytest.mark.parametrize("h,w,seed", [(16, 16, 0), (64, 96, 1), (70, 90, 2)])
def test_build_boundary_mesh_matches_jax(h, w, seed):
    pts, bmask, _ = _cam_points(h, w, seed)
    if seed == 0:
        pts = np.random.default_rng(0).random((h, w, 3)).astype(np.float32)
        bmask = np.zeros((h, w), bool)
        bmask[4:8, 4:8] = True
    want_v, want_f = jraycast.build_boundary_mesh(pts, bmask, downsample=4)
    got_v, got_f = raycast.build_boundary_mesh(torch.from_numpy(pts), torch.from_numpy(bmask))
    assert got_f.dtype == torch.int64 and len(want_f) > 0
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=1e-6, rtol=0)
    if seed == 0:
        assert got_v.shape == (16, 3)  # the 4 x 4 grid


def test_build_boundary_mesh_empty():
    pts = torch.rand((32, 32, 3))
    v, f = raycast.build_boundary_mesh(pts, torch.zeros((32, 32), dtype=torch.bool))
    assert v.shape == (0, 3) and f.shape == (0, 3)
    assert raycast.mesh_depth_map(pts, torch.zeros((32, 32), dtype=torch.bool),
                                  torch.eye(3)) is None


def test_pixel_rays_matches_jax():
    k = np.array([[40.0, 0, 17.5], [0, 41.0, 12.0], [0, 0, 1]], np.float32)[None]
    want = np.asarray(jgeometry.pixel_rays(24, 36, jnp.asarray(k)))
    got = geometry.pixel_rays(24, 36, torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, atol=2.5e-7, rtol=0)  # 2 ulp of 1


def test_mesh_depth_map_blocks_centre():
    """A fronto-parallel patch at z = 1 in the middle of the image: z-depth
    ~1 where it covers, 0 elsewhere, as the JAX version renders it."""
    h = w = 32
    k = np.array([[32.0, 0, 16], [0, 32.0, 16], [0, 0, 1]], np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pts = np.stack([(xx - 16) / 32.0, (yy - 16) / 32.0, np.ones_like(xx)], -1).astype(np.float32)
    mask = np.zeros((h, w), bool)
    mask[12:20, 12:20] = True
    got = raycast.mesh_depth_map(torch.from_numpy(pts), torch.from_numpy(mask),
                                 torch.from_numpy(k)).numpy()
    want = np.asarray(jraycast.mesh_depth_map(pts, mask, k))
    assert abs(got[16, 16] - 1.0) < 1e-3 and got[0, 0] == 0.0
    _assert_depths_close(got.ravel(), want.ravel())


@pytest.mark.parametrize("seed", [3, 4])
def test_mesh_depth_map_matches_jax(seed):
    h, w = 72, 96
    pts, bmask, k = _cam_points(h, w, seed)
    # seen from a camera moved left and forward
    w2c = np.eye(4, dtype=np.float32)
    w2c[0, 3], w2c[2, 3] = 0.3, -0.2
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    want = np.asarray(jraycast.mesh_depth_map(cam.astype(np.float32), bmask, k))
    got = raycast.mesh_depth_map(torch.from_numpy(cam.astype(np.float32)),
                                 torch.from_numpy(bmask), torch.from_numpy(k)).numpy()
    assert (want > 0).mean() > 0.01
    _assert_depths_close(got.ravel(), want.ravel())


def test_apply_foreground_masking_matches_jax():
    """Two items culled by their meshes, one whose boundary is empty (left
    as it was); warped within 1e-6, masks and depths where both keep."""
    rng = np.random.default_rng(5)
    h, w, m = 48, 64, 3
    items = [_cam_points(h, w, s) for s in (6, 7, 8)]
    world = np.stack([p for p, _, _ in items])
    bmask = np.stack([b for _, b, _ in items])
    bmask[2] = False
    ks = np.stack([k for _, _, k in items])
    w2cs = np.repeat(np.eye(4, dtype=np.float32)[None], m, 0)
    w2cs[:, 0, 3] = [0.25, -0.3, 0.2]
    w2cs[:, 2, 3] = -0.15
    warped = rng.uniform(-1, 1, (m, 3, h, w)).astype(np.float32)
    mask2 = (rng.uniform(size=(m, 1, h, w)) > 0.1).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (m, h, w)).astype(np.float32)
    want = [np.asarray(a) for a in jraycast.apply_foreground_masking(
        *(jnp.asarray(a) for a in (warped, mask2, depth, world, bmask, w2cs, ks)))]
    got = [a.numpy() for a in raycast.apply_foreground_masking(
        *(torch.from_numpy(a.copy()) for a in (warped, mask2, depth, world, bmask, w2cs, ks)))]
    culled = (want[1] == 0) & (mask2 > 0)
    assert culled[:2].mean() > 0.01 and not culled[2].any()
    assert ((got[1] == 0) != (want[1] == 0)).mean() <= FLIP_TOL
    keep = (got[1] > 0) == (want[1] > 0)
    np.testing.assert_allclose(got[0][np.broadcast_to(keep, got[0].shape)],
                               want[0][np.broadcast_to(keep, want[0].shape)], atol=1e-6)
    np.testing.assert_array_equal(got[2][keep[:, 0]], want[2][keep[:, 0]])
    np.testing.assert_array_equal(got[0][2], warped[2])  # the empty mesh: untouched
