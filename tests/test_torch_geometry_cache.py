"""Camera, geometry and 3D-cache ports against the JAX package on the CPU.

Same numpy inputs through gen3c_tpu and gen3c_tpu_torch. Tolerances: the
trajectories are the same float64 numpy math (exact); the fp32 geometry
differs only in summation order (atol 1e-5); the cache renders go through
an unproject -> project -> splat chain and, after update_cache, a depth
alignment (lstsq in float64, then 100 Adam steps), so atol 1e-4.
noise_aug_strength is 0: the JAX cache draws that noise from jax.random,
the port from a torch.Generator.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.cache import Cache3DBuffer as JaxCache3DBuffer
from gen3c_tpu.ops import camera as jcam
from gen3c_tpu.ops import geometry as jgeo
from gen3c_tpu_torch.cache import Cache3DBuffer
from gen3c_tpu_torch.ops import camera as tcam
from gen3c_tpu_torch.ops import geometry as tgeo
from gen3c_tpu_torch.pipelines.depth import default_intrinsics

torch.set_num_threads(2)

H, W = 48, 80


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("traj,rot", list(itertools.product(jcam.TRAJECTORY_TYPES,
                                                             jcam.CAMERA_ROTATIONS)))
def test_camera_trajectory_exact(traj, rot):
    assert tcam.TRAJECTORY_TYPES == jcam.TRAJECTORY_TYPES
    w2c0 = np.eye(4, dtype=np.float32)
    w2c0[:3, 3] = [0.1, -0.2, 0.3]
    k = default_intrinsics(H, W)
    jw, jk = jcam.generate_camera_trajectory(traj, w2c0, k, 7, 0.3, rot, 1.5)
    tw, tk = tcam.generate_camera_trajectory(traj, w2c0, k, 7, 0.3, rot, 1.5)
    np.testing.assert_array_equal(_np(tw), _np(jw))
    np.testing.assert_array_equal(_np(tk), _np(jk))


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    depth = (2.5 - 0.8 * yy + 0.3 * np.sin(5 * xx) + 0.02 * rng.standard_normal((H, W))
             + 0.8 * (xx > 0.6))  # a depth edge for the reliability filter
    image = np.stack([np.sin(3 * xx + c) * np.cos(2 * yy - c) for c in range(3)])
    # a principal point off the pixel grid: a splat target that lands on an
    # exact integer gets its weight counted twice per axis (floor == ceil),
    # so a coordinate that rounds to an integer in one package and not in
    # the other would test rounding, not the port
    k = default_intrinsics(H, W)
    k[0, 2] += 0.37
    k[1, 2] += 0.29
    return image.astype(np.float32), depth.astype(np.float32), k


def test_unproject_project_forward_warp():
    image, depth, k = _scene()
    rng = np.random.default_rng(1)
    b = 2
    depth_b = np.stack([depth, depth * 1.3])[:, None]
    depth_b[0, 0, :3, :5] = -1.0  # masked-out pixels
    w2c = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    w2c[:, :3, 3] = rng.uniform(-0.2, 0.2, (b, 3))
    ks = np.tile(k[None], (b, 1, 1))
    j = jnp.asarray
    t = torch.from_numpy

    jpts = jgeo.unproject_points(j(depth_b), j(w2c), j(ks))
    tpts = tgeo.unproject_points(t(depth_b), t(w2c), t(ks))
    np.testing.assert_allclose(_np(tpts), np.asarray(jpts), atol=1e-5, rtol=0)
    jpts_r = jgeo.unproject_points(j(depth_b), j(w2c), j(ks), is_depth=False)
    tpts_r = tgeo.unproject_points(t(depth_b), t(w2c), t(ks), is_depth=False)
    np.testing.assert_allclose(_np(tpts_r), np.asarray(jpts_r), atol=1e-5, rtol=0)

    tgt = w2c.copy()
    tgt[:, 0, 3] += 0.15
    jproj, jcam_pts = jgeo.project_points(jpts, j(tgt), j(ks))
    tproj, tcam_pts = tgeo.project_points(tpts, t(tgt), t(ks))
    np.testing.assert_allclose(_np(tproj), np.asarray(jproj), atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(_np(tcam_pts), np.asarray(jcam_pts), atol=1e-5, rtol=0)
    for is_depth in (True, False):
        jt = jgeo.compute_transformed_points(j(depth_b), j(w2c), j(tgt), j(ks), is_depth)
        tt = tgeo.compute_transformed_points(t(depth_b), t(w2c), t(tgt), t(ks), is_depth)
        np.testing.assert_allclose(_np(tt[0]), np.asarray(jt[0]), atol=1e-4, rtol=1e-6)
        np.testing.assert_allclose(_np(tt[1]), np.asarray(jt[1]), atol=1e-5, rtol=0)

    # one shared point cloud into both views, so both packages splat the
    # same positions (only the projection's rounding differs)
    frames = np.stack([image, image[::-1]])
    masks = (rng.uniform(size=(b, 1, H, W)) > 0.1).astype(np.float32)
    jw, jm, jd, jf = jgeo.forward_warp(j(frames), j(masks), j(tgt), j(ks), jpts, True, True)
    tw, tm, td, tf = tgeo.forward_warp(t(frames), t(masks), t(tgt), t(ks),
                                       t(np.asarray(jpts)), True, True)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(td), np.asarray(jd), atol=1e-5, rtol=0)


@pytest.mark.parametrize("window,thresh", [(5, 0.05), (3, 0.2)])
def test_reliable_depth_mask(window, thresh):
    _, depth, _ = _scene(2)
    d = np.stack([depth, depth[::-1]])[:, None].copy()
    d[1, 0, 10:14, 20:30] += 1.5  # a discontinuity
    d[0, 0, :2] = 0.0
    want = jgeo.reliable_depth_mask(jnp.asarray(d), window, thresh)
    got = tgeo.reliable_depth_mask(torch.from_numpy(d), window, thresh)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    want3 = jgeo.reliable_depth_mask(jnp.asarray(d[:, 0]), window, thresh)
    got3 = tgeo.reliable_depth_mask(torch.from_numpy(d[:, 0]), window, thresh)
    np.testing.assert_array_equal(_np(got3), np.asarray(want3))


def _render_pair(jc, tc, w2cs, ks, render_depth=False):
    jp, jm = jc.render_cache(w2cs, ks, render_depth=render_depth)
    tp, tm = tc.render_cache(torch.from_numpy(np.asarray(w2cs)),
                             torch.from_numpy(np.asarray(ks)), render_depth=render_depth)
    assert tuple(tp.shape) == tuple(jp.shape)
    # atol 1e-4 everywhere but at splat ties: a point that lands within
    # rounding of a pixel edge changes its corners between the packages,
    # the <= 0.1% tie fraction the JAX package's own reference parity
    # allows (docs/STATUS.md, Round 4 item 1)
    assert (_np(tm) != np.asarray(jm)).mean() <= 1e-3
    assert (np.abs(_np(tp) - np.asarray(jp)) > 1e-4).mean() <= 1e-3


@pytest.fixture
def shared_scale_map(monkeypatch):
    """Make the port's non-rigid fit return the JAX fit's scale map.

    The fit is 100 Adam steps on an L1 objective: each pixel ends up
    oscillating around its kink with an amplitude of about lr = 1e-3, and
    which side of the kink a step lands on depends on the last bit of
    fp32 rounding. Two correct implementations therefore differ by a few
    lr per pixel (test_nonrigid_scale_map_matches_jax holds the port's fit
    to that). To hold the rest of update_cache to 1e-4, the port's fit is
    checked for its inputs and then handed the JAX fit's output.
    """
    import gen3c_tpu.ops.camera as jcam_mod
    import gen3c_tpu_torch.ops.camera as tcam_mod

    fits = []
    jax_fit = jcam_mod._nonrigid_scale_map

    def record(*args):
        out = jax_fit(*args)
        fits.append(([np.asarray(a) for a in args], np.asarray(out)))
        return out

    def replay(source_depth, target_points, target_mask, k, c2w):
        args, out = fits.pop(0)
        for got, want in zip((source_depth, target_points, target_mask, k, c2w), args):
            np.testing.assert_allclose(_np(got).astype(np.float64), want.astype(np.float64),
                                       atol=1e-4, rtol=0)
        return torch.from_numpy(out)

    monkeypatch.setattr(jcam_mod, "_nonrigid_scale_map", record)
    monkeypatch.setattr(tcam_mod, "_nonrigid_scale_map", replay)
    return fits


# 0.2: the filter masks the band along the depth edge and nothing near its
# threshold elsewhere, so the mask is not decided by the last bit
@pytest.mark.parametrize("filter_thresh", [1.0, 0.2])
def test_cache_render_and_ring_updates(filter_thresh, shared_scale_map):
    image, depth, k = _scene(3)
    w2c0 = np.eye(4, dtype=np.float32)
    kwargs = dict(frame_buffer_max=2, noise_aug_strength=0.0,
                  filter_points_threshold=filter_thresh)
    jc = JaxCache3DBuffer(input_image=jnp.asarray(image[None]),
                          input_depth=jnp.asarray(depth[None, None]),
                          input_w2c=jnp.asarray(w2c0[None]),
                          input_intrinsics=jnp.asarray(k[None]), **kwargs)
    tc = Cache3DBuffer(input_image=torch.from_numpy(image[None]),
                       input_depth=torch.from_numpy(depth[None, None]),
                       input_w2c=torch.from_numpy(w2c0[None]),
                       input_intrinsics=torch.from_numpy(k[None]), **kwargs)
    w2cs, ks = jcam.generate_camera_trajectory("left", w2c0, k, 9, 0.3, "center_facing", 1.0)
    _render_pair(jc, tc, w2cs, ks)

    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    for step, (frame_idx, method) in enumerate([(4, "rigid"), (8, "non_rigid"), (2, "non_rigid")]):
        # a new frame whose depth differs non-affinely from the cache's
        new_image = np.roll(image, 3 * (step + 1), axis=2)[None]
        new_depth = (depth * (1.0 + 0.1 * np.sin(4 * xx + step) * (yy + 0.5)))[None, None]
        new_depth = new_depth.astype(np.float32)
        w2c_new, k_new = np.asarray(w2cs)[:, frame_idx], np.asarray(ks)[:, frame_idx]
        jc.update_cache(jnp.asarray(new_image), jnp.asarray(new_depth), jnp.asarray(w2c_new),
                        new_intrinsics=jnp.asarray(k_new), alignment_method=method)
        tc.update_cache(torch.from_numpy(new_image), torch.from_numpy(new_depth),
                        torch.from_numpy(w2c_new), new_intrinsics=torch.from_numpy(k_new),
                        alignment_method=method)
        assert tc.input_image.shape == jc.input_image.shape  # filled, then overwritten
        np.testing.assert_allclose(_np(tc.input_points), np.asarray(jc.input_points),
                                   atol=1e-4, rtol=0)
        _render_pair(jc, tc, w2cs, ks)
    assert not shared_scale_map  # every JAX fit was replayed
    _render_pair(jc, tc, w2cs[:, :3], ks[:, :3], render_depth=True)


def test_nonrigid_scale_map_matches_jax():
    """The port's Adam loop against optax's, on the same inputs.

    Tolerance from the objective, not from fp32: near convergence each
    pixel steps +-lr (1e-3) around the kink of its L1 term, and the side
    depends on rounding, so the maps may differ by a few lr per pixel; on
    average they must agree to lr, and reach the same loss within 1%.
    """
    image, depth, k = _scene(4)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    w2c = np.eye(4, dtype=np.float32)
    w2c[0, 3] = 0.1
    c2w = np.linalg.inv(w2c).astype(np.float32)
    src = (depth * (1.0 + 0.1 * np.sin(4 * xx) * (yy + 0.5))).astype(np.float32)
    mask = np.ones((H, W), bool)
    mask[:, :9] = False
    tgt_pts = np.asarray(jgeo.unproject_points(jnp.asarray(depth)[None, None],
                                               jnp.asarray(c2w)[None], jnp.asarray(k)[None],
                                               mask=jnp.asarray(mask)[None, None]))[0]
    want = np.asarray(jcam._nonrigid_scale_map(jnp.asarray(src), jnp.asarray(tgt_pts),
                                               jnp.asarray(mask), jnp.asarray(k),
                                               jnp.asarray(c2w)))
    got = tcam._nonrigid_scale_map(torch.from_numpy(src), torch.from_numpy(tgt_pts.copy()),
                                   torch.from_numpy(mask), torch.from_numpy(k),
                                   torch.from_numpy(c2w)).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 1e-2 and diff.mean() <= 1e-3, (diff.max(), diff.mean())

    def loss(sc):
        pts = np.asarray(jgeo.unproject_points(jnp.asarray(src * sc)[None, None],
                                               jnp.asarray(c2w)[None], jnp.asarray(k)[None],
                                               mask=jnp.asarray(mask)[None, None]))[0]
        return np.abs(pts - tgt_pts)[mask].sum() / (mask.sum() * 3)

    assert loss(got) <= 1.01 * loss(want)
