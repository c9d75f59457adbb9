"""The port's dynamic-scene and multiview slice against gen3c_tpu on the CPU:
Cache4D, the buffer selector, foreground-masked renders, the input loaders
and the three GEN3C CLIs with --foreground_masking.

Renders are held as the cache renders are (test_torch_geometry_cache):
masks differ on at most 1e-3 of the values and pixels by more than 1e-4 on
at most 1e-3 (splat ties, and the hit of a ray that grazes a mesh edge).
The CLIs run gen3c_tiny on the same weights (test_torch_pipeline's
``models``: the JAX factory's fp32 init, gates randomized, bridged into the
port) and compare their videos frame by frame as uint8: |delta| <= 1 on at
least 99.9% of the values.
"""

import os
import subprocess
import sys
import types
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.cache import Cache3DBuffer as JaxBuffer
from gen3c_tpu.cache import Cache3DBufferSelector as JaxSelector
from gen3c_tpu.cache import Cache4D as JaxCache4D
from gen3c_tpu.ops.camera import generate_camera_trajectory as jax_trajectory
from gen3c_tpu.pipelines import data_loaders as jloaders
from gen3c_tpu_torch.cache import Cache3DBuffer, Cache3DBufferSelector, Cache4D
from gen3c_tpu_torch.pipelines import data_loaders
from tests.test_torch_pipeline import REPO, _assert_frames_close, models  # noqa: F401

torch.set_num_threads(2)


def _np(t):
    return t.detach().cpu().numpy()


def _assert_renders_close(got, want):
    (tp, tm), (jp, jm) = got, want
    assert tuple(tp.shape) == tuple(jp.shape) and tuple(tm.shape) == tuple(jm.shape)
    assert (_np(tm) != np.asarray(jm)).mean() <= 1e-3
    assert (np.abs(_np(tp) - np.asarray(jp)) > 1e-4).mean() <= 1e-3


def _scene(n, h, w, seed, objects=3):
    """n seeded RGBD frames: a slanted plane with nearer discs (depth
    boundaries for the masking), cameras stepping sideways; as numpy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    image = rng.uniform(-1, 1, (n, 3, h, w)).astype(np.float32)
    depth = np.empty((n, 1, h, w), np.float32)
    for i in range(n):
        d = 2.5 - 0.3 * yy + 0.1 * np.sin(3 * xx + i)  # smooth enough to pass the 0.05 filter
        for _ in range(objects):
            cy, cx, r = rng.uniform(0.3, 0.7), rng.uniform(0.3, 0.7), rng.uniform(0.08, 0.18)
            d = np.where((yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2, rng.uniform(1.0, 1.4), d)
        depth[i, 0] = d
    w2c = np.repeat(np.eye(4, dtype=np.float32)[None], n, 0)
    # off every target camera of _targets on all axes: a target that keeps
    # a source camera's row (or column) lands every point on an exact pixel
    # row, where rounding decides which corners a point feeds
    w2c[:, 0, 3] = np.linspace(0.02, 0.1, n)
    w2c[:, 1, 3], w2c[:, 2, 3] = 0.013, 0.011
    k = np.repeat(np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]],
                           np.float32)[None], n, 0)
    mask = (rng.uniform(size=(n, 1, h, w)) > 0.05).astype(np.float32)
    return image, depth, mask, w2c, k


def _targets(n, h, w):
    k = np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]], np.float32)
    w2cs, ks = jax_trajectory("left", np.eye(4, dtype=np.float32), k, n, 0.3, "center_facing",
                              1.0)
    return np.array(w2cs)[0], np.array(ks)[0]  # (n, 4, 4), (n, 3, 3)


@pytest.mark.parametrize("masking", [False, True])
def test_cache4d_renders_start_frame_idx(masking):
    """Target t renders source frame start + t, with and without foreground
    masking, as depth too."""
    h, w = 48, 64
    image, depth, mask, w2c, k = _scene(7, h, w, 0)
    kw = dict(input_format=["F", "C", "H", "W"], filter_points_threshold=0.05,
              foreground_masking=masking)
    jc = JaxCache4D(input_image=jnp.asarray(image), input_depth=jnp.asarray(depth),
                    input_mask=jnp.asarray(mask), input_w2c=jnp.asarray(w2c),
                    input_intrinsics=jnp.asarray(k), **kw)
    tc = Cache4D(input_image=torch.from_numpy(image), input_depth=torch.from_numpy(depth),
                 input_mask=torch.from_numpy(mask), input_w2c=torch.from_numpy(w2c),
                 input_intrinsics=torch.from_numpy(k), **kw)
    assert tuple(tc.input_image.shape) == tuple(jc.input_image.shape)
    if masking:
        np.testing.assert_array_equal(_np(tc.boundary_mask), np.asarray(jc.boundary_mask))
    w2cs, ks = _targets(7, h, w)
    for start, n_t in ((0, 4), (3, 4)):
        tw, tk = w2cs[None, start:start + n_t], ks[None, start:start + n_t]
        for depth_out in (False, True):
            _assert_renders_close(
                tc.render_cache(torch.from_numpy(tw), torch.from_numpy(tk), depth_out, start),
                jc.render_cache(tw, tk, depth_out, start))
    # the masking culled something that the unmasked render keeps
    if masking:
        plain = Cache4D(input_image=torch.from_numpy(image), input_depth=torch.from_numpy(depth),
                        input_mask=torch.from_numpy(mask), input_w2c=torch.from_numpy(w2c),
                        input_intrinsics=torch.from_numpy(k), input_format=["F", "C", "H", "W"],
                        filter_points_threshold=0.05)
        tw, tk = torch.from_numpy(w2cs[None, :4]), torch.from_numpy(ks[None, :4])
        culled = (plain.render_cache(tw, tk)[1] > 0) & (tc.render_cache(tw, tk)[1] == 0)
        assert culled.float().mean() > 1e-3
    with pytest.raises(NotImplementedError):
        tc.update_cache()


def _selector_pair(images, depths, w2c, k, frame_buffer_max, masking=False):
    kw = dict(frame_buffer_max=frame_buffer_max, input_format=["B", "N", "C", "H", "W"],
              filter_points_threshold=0.05, foreground_masking=masking)
    jc = JaxSelector(input_image=jnp.asarray(images[None]), input_depth=jnp.asarray(depths[None]),
                     input_w2c=jnp.asarray(w2c[None]), input_intrinsics=jnp.asarray(k[None]), **kw)
    tc = Cache3DBufferSelector(input_image=torch.from_numpy(images[None]),
                               input_depth=torch.from_numpy(depths[None]),
                               input_w2c=torch.from_numpy(w2c[None]),
                               input_intrinsics=torch.from_numpy(k[None]), **kw)
    return jc, tc


def test_selector_ties_go_to_the_lower_index():
    """Key frames 1 and 3 are copies of 0 (exactly tied overlaps, as integer
    sums): top-2 keeps 0 and 1, as jax.lax.top_k; frame 2 covers less."""
    h, w = 40, 56
    image, depth, _, w2c, k = _scene(4, h, w, 1, objects=0)
    for i in (1, 3):
        image[i], depth[i], w2c[i] = image[0], depth[0], w2c[0]
    w2c[2, 0, 3] = 0.8  # far to the side: the least overlap
    jc, tc = _selector_pair(image, depth, w2c, k, 2)
    w2cs, ks = _targets(5, h, w)
    got = tc.render_cache(torch.from_numpy(w2cs[None]), torch.from_numpy(ks[None]))
    _assert_renders_close(got, jc.render_cache(w2cs[None], ks[None]))
    assert tc.selections == [[0, 1]]
    # the near-full rule: buffer 0 covers >= 90% of frame 0, so only it is kept there
    cover = _np(got[1]).mean(axis=(3, 4, 5))[0]
    assert cover[0, 0] >= 0.9 and cover[0, 1] == 0.0
    assert (_np(got[0])[0, 0, 1] == -1).all()


@pytest.mark.parametrize("masking,mask_for_max", [(False, False), (True, True)])
def test_selector_matches_jax(masking, mask_for_max):
    h, w = 48, 64
    image, depth, _, w2c, k = _scene(4, h, w, 2)
    w2c[:, 0, 3] = [0.0, 0.3, -0.3, 0.6]
    jc, tc = _selector_pair(image, depth, w2c, k, 2, masking)
    jc.mask_for_max_buffer_model = tc.mask_for_max_buffer_model = mask_for_max
    w2cs, ks = _targets(5, h, w)
    _assert_renders_close(tc.render_cache(torch.from_numpy(w2cs[None]), torch.from_numpy(ks[None])),
                          jc.render_cache(w2cs[None], ks[None]))
    assert len(tc.selections) == 1 and len(tc.selections[0]) == 2
    with pytest.raises(NotImplementedError):
        tc.update_cache()


def test_masked_buffer_render_and_update_keep_the_seed_boundary():
    """A foreground-masked Cache3DBuffer, rendered, then given a frame by
    update_cache (no depth alignment): its boundary mask stays the seed's
    and is broadcast over both buffers, in both packages."""
    h, w = 48, 64
    image, depth, _, _, k = _scene(2, h, w, 3)
    w2c0 = np.eye(4, dtype=np.float32)
    kw = dict(frame_buffer_max=2, filter_points_threshold=0.05, foreground_masking=True)
    jc = JaxBuffer(input_image=jnp.asarray(image[:1]), input_depth=jnp.asarray(depth[:1]),
                   input_w2c=jnp.asarray(w2c0[None]), input_intrinsics=jnp.asarray(k[:1]), **kw)
    tc = Cache3DBuffer(input_image=torch.from_numpy(image[:1]),
                       input_depth=torch.from_numpy(depth[:1]),
                       input_w2c=torch.from_numpy(w2c0[None]),
                       input_intrinsics=torch.from_numpy(k[:1]), **kw)
    w2cs, ks = _targets(5, h, w)
    tw, tk = torch.from_numpy(w2cs[None]), torch.from_numpy(ks[None])
    _assert_renders_close(tc.render_cache(tw, tk), jc.render_cache(w2cs[None], ks[None]))
    seed_boundary = _np(tc.boundary_mask).copy()
    new_w2c = w2cs[2][None]
    jc.update_cache(jnp.asarray(image[1:]), jnp.asarray(depth[1:]), jnp.asarray(new_w2c),
                    new_intrinsics=jnp.asarray(ks[2][None]), depth_alignment=False)
    tc.update_cache(torch.from_numpy(image[1:]), torch.from_numpy(depth[1:]),
                    torch.from_numpy(new_w2c), new_intrinsics=torch.from_numpy(ks[2][None]),
                    depth_alignment=False)
    assert tc.input_image.shape[2] == 2
    np.testing.assert_array_equal(_np(tc.boundary_mask), seed_boundary)
    np.testing.assert_array_equal(seed_boundary, np.asarray(jc.boundary_mask))
    for depth_out in (False, True):
        _assert_renders_close(tc.render_cache(tw, tk, depth_out),
                              jc.render_cache(w2cs[None], ks[None], depth_out))
    with pytest.raises(ValueError, match="start_frame_idx"):
        tc.render_cache(tw, tk, start_frame_idx=1)


@pytest.fixture
def fake_imageio(monkeypatch):
    """imageio decodes mp4 only through its ffmpeg plugin, which a test
    run need not have: a stand-in ``imageio`` whose reader returns the
    frames an mp4 path was given (both loaders import imageio lazily, so
    both read through it)."""
    videos = {}

    def get_reader(path):
        return _Reader(videos[os.path.abspath(str(path))])

    def write(path, frames):
        open(path, "wb").close()  # the file exists, as loaders look for it
        videos[os.path.abspath(str(path))] = frames

    monkeypatch.setitem(sys.modules, "imageio", types.SimpleNamespace(get_reader=get_reader))
    return write


class _Reader:
    def __init__(self, frames):
        self.frames = frames

    def __iter__(self):
        return iter(self.frames)

    def close(self):
        pass


def _assert_clips_equal(got, want):
    assert len(got) == len(want) == 5
    for g, x in zip(got, want):
        if x is None:
            assert g is None
        else:
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, x)


def test_loaders_match_jax(tmp_path, fake_imageio):
    """Each input format through both packages' loaders: packaged .npz and
    .pt, a distributed directory (rgb.mp4 + npz), a ViPE clip (mp4, EXR
    depth zip, pose and intrinsics npz, resized and cropped) and a
    multiview npz."""
    from gen3c_tpu.utils.exr import write_exr_depth

    rng = np.random.default_rng(4)
    n, h, w = 3, 24, 40
    image, depth, mask, w2c, k = _scene(n, h, w, 4)
    np.savez(tmp_path / "clip.npz", image=image, depth=depth, mask=mask, w2c=w2c, intrinsics=k)
    torch.save(tuple(torch.from_numpy(a) for a in (image, depth)) + (None,)
               + tuple(torch.from_numpy(a) for a in (w2c, k)), tmp_path / "clip.pt")
    for name in ("clip.npz", "clip.pt"):
        _assert_clips_equal(data_loaders.load_data_auto_detect(str(tmp_path / name)),
                            jloaders.load_data_auto_detect(str(tmp_path / name)))

    frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    dist = tmp_path / "dist"
    dist.mkdir()
    fake_imageio(dist / "rgb.mp4", frames)
    np.savez(dist / "depth.npz", depth=depth[:, 0])
    np.savez(dist / "mask.npz", mask=mask[:, 0])
    np.savez(dist / "camera.npz", w2c=w2c, intrinsics=k)
    _assert_clips_equal(data_loaders.load_data_auto_detect(str(dist)),
                        jloaders.load_data_auto_detect(str(dist)))

    vipe = tmp_path / "vipe"
    for sub in ("rgb", "depth", "pose", "intrinsics"):
        (vipe / sub).mkdir(parents=True)
    fake_imageio(vipe / "rgb" / "c0.mp4", frames)
    with zipfile.ZipFile(vipe / "depth" / "c0.zip", "w") as zf:
        for i in range(n):
            zf.writestr(f"{i:05d}.exr", write_exr_depth(depth[i, 0]))
    c2w = np.linalg.inv(w2c)
    np.savez(vipe / "pose" / "c0.npz", inds=np.arange(n), data=c2w.reshape(n, 16))
    np.savez(vipe / "intrinsics" / "c0.npz", inds=np.arange(n),
             data=np.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]], 1))
    kw = dict(starting_frame_idx=1, resize_hw=(36, 64), crop_hw=(32, 64), num_frames=4)
    got = data_loaders.load_vipe_data(str(vipe), **kw)
    _assert_clips_equal(got, jloaders.load_vipe_data(str(vipe), **kw))
    assert got[0].shape == (4, 3, 32, 64)  # frames 1, 2 and the last repeated
    _assert_clips_equal(data_loaders.load_vipe_data(str(vipe / "rgb" / "c0.mp4"), **kw), got)
    np.testing.assert_array_equal(
        data_loaders.adjust_intrinsics_for_resize_and_crop(k[0], (h, w), (36, 64), (32, 64)),
        jloaders.adjust_intrinsics_for_resize_and_crop(k[0], (h, w), (36, 64), (32, 64)))

    np.savez(tmp_path / "mv.npz", images_key_frames=image, depth_key_frames=depth,
             mask_key_frames=mask, K_key_frames=k, w2cs_key_frames=w2c, w2cs_all=w2c, Ks_all=k)
    got, want = (m.load_multiview_npz(str(tmp_path / "mv.npz")) for m in (data_loaders, jloaders))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError, match="Invalid input path"):
        data_loaders.load_data_auto_detect(str(tmp_path / "missing"))


def _capture(monkeypatch, module):
    """Record the video run_chunked_generation returns inside a CLI module."""
    runs = []
    inner = module.run_chunked_generation

    def wrapped(*args, **kwargs):
        out = inner(*args, **kwargs)
        runs.append(out[0].copy())
        return out

    monkeypatch.setattr(module, "run_chunked_generation", wrapped)
    return runs


def _write_clip(path, preset, n):
    image, depth, mask, _, k = _scene(n, preset.height, preset.width, 5)
    w2c, ks = _targets(n, preset.height, preset.width)
    np.savez(path, image=image, depth=depth, mask=mask, w2c=w2c, intrinsics=ks)
    return image, depth, w2c, ks


def _cli_pair(monkeypatch, models, jcli, tcli, argv):
    """Run one CLI of each package on the shared weights; their videos."""
    from gen3c_tpu.pipelines import factory as jfactory

    jmodel, tmodel, preset = models
    monkeypatch.setattr(jfactory, "build_from_args", lambda args: (jmodel, preset))
    jruns, truns = _capture(monkeypatch, jcli), _capture(monkeypatch, tcli)
    jcli.demo(jcli.create_parser().parse_args(argv))
    args = tcli.create_parser().parse_args(argv + ["--device", "cpu"])
    assert os.path.exists(tcli.demo(args, built=(tmodel, preset)))
    return truns[0], jruns[0]


def test_dynamic_cli_matches_jax(tmp_path, monkeypatch, models):  # noqa: F811
    from gen3c_tpu.pipelines import gen3c_dynamic as jcli
    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.pipelines import gen3c_dynamic as tcli

    preset = models[2]
    _write_clip(tmp_path / "clip.npz", preset, 9)
    argv = ["--input_video_path", str(tmp_path / "clip.npz"), "--model_preset", "gen3c_tiny",
            "--checkpoint_dir", str(tmp_path / "none"), "--num_video_frames", "9",
            "--num_steps", "2", "--trajectory", "left", "--foreground_masking",
            "--video_save_folder", str(tmp_path / "out")]
    got, want = _cli_pair(monkeypatch, models, jcli, tcli, argv)
    assert got.shape == (9, preset.height, preset.width, 3)
    _assert_frames_close(got, want)
    assert kernels.launch_counts["K6"] == 0  # the CPU ran the plain version


def test_multiview_cli_matches_jax(tmp_path, monkeypatch, models):  # noqa: F811
    from gen3c_tpu.pipelines import gen3c_multiview as jcli
    from gen3c_tpu_torch.pipelines import gen3c_multiview as tcli

    preset = models[2]
    h, w = preset.height, preset.width
    image, depth, mask, w2c, k = _scene(4, h, w, 6)
    w2c[:, 0, 3] = [0.0, 0.2, -0.2, 0.4]
    traj_w2c, traj_k = _targets(9, h, w)
    np.savez(tmp_path / "mv.npz", images_key_frames=image, depth_key_frames=depth,
             mask_key_frames=mask, K_key_frames=k, w2cs_key_frames=w2c, w2cs_all=traj_w2c,
             Ks_all=traj_k)
    argv = ["--npz_path", str(tmp_path / "mv.npz"), "--model_preset", "gen3c_tiny",
            "--checkpoint_dir", str(tmp_path / "none"), "--num_video_frames", "9",
            "--num_steps", "2", "--frame_buffer_max", "2", "--foreground_masking",
            "--video_save_folder", str(tmp_path / "out")]
    got, want = _cli_pair(monkeypatch, models, jcli, tcli, argv)
    assert got.shape == (9, h, w, 3)
    _assert_frames_close(got, want)


def test_single_image_cli_foreground_masking_matches_jax(tmp_path, monkeypatch, models):  # noqa: F811
    """One 9-frame chunk from a seed image with a heuristic depth, masking on."""
    from PIL import Image

    from gen3c_tpu.pipelines import gen3c_single_image as jcli
    from gen3c_tpu_torch.pipelines import factory as tfactory
    from gen3c_tpu_torch.pipelines import gen3c_single_image as tcli

    jmodel, tmodel, preset = models
    Image.fromarray((np.random.default_rng(7).uniform(size=(preset.height, preset.width, 3))
                     * 255).astype(np.uint8)).save(tmp_path / "in.png")
    argv = ["--input_image_path", str(tmp_path / "in.png"), "--model_preset", "gen3c_tiny",
            "--checkpoint_dir", str(tmp_path / "none"), "--num_video_frames", "9",
            "--num_steps", "2", "--depth_source", "heuristic", "--foreground_masking",
            "--video_save_folder", str(tmp_path / "out")]
    monkeypatch.setattr(jcli, "build_gen3c_model", lambda *a, **kw: (jmodel, preset))
    monkeypatch.setattr(tfactory, "build_gen3c_model", lambda *a, **kw: (tmodel, preset))
    import gen3c_tpu.pipelines.chunked as jchunked

    jruns, truns = _capture(monkeypatch, jchunked), _capture(monkeypatch, tcli)
    jcli.demo(jcli.create_parser().parse_args(argv))
    tcli.demo(tcli.create_parser().parse_args(argv + ["--device", "cpu"]))
    _assert_frames_close(truns[0], jruns[0])


@pytest.mark.parametrize("cli", ["gen3c_dynamic", "gen3c_multiview"])
def test_new_clis_run_the_multistep_solver(cli, tmp_path, monkeypatch, models):  # noqa: F811
    """--solver dpm2m through the dynamic and multiview CLIs: 3 steps (the
    multistep rule runs on step 1; a 2-step run would be Euler on both),
    against gen3c_tpu's CLI on the same weights."""
    import importlib

    jcli = importlib.import_module(f"gen3c_tpu.pipelines.{cli}")
    tcli = importlib.import_module(f"gen3c_tpu_torch.pipelines.{cli}")
    preset = models[2]
    h, w = preset.height, preset.width
    common = ["--model_preset", "gen3c_tiny", "--checkpoint_dir", str(tmp_path / "none"),
              "--num_video_frames", "9", "--num_steps", "3", "--solver", "dpm2m", "--video_save_folder", str(tmp_path / "out")]
    if cli == "gen3c_dynamic":
        _write_clip(tmp_path / "clip.npz", preset, 9)
        argv = ["--input_video_path", str(tmp_path / "clip.npz"), "--trajectory", "left"]
    else:
        image, depth, mask, w2c, k = _scene(3, h, w, 9)
        w2c[:, 0, 3] = [0.0, 0.2, -0.2]
        traj_w2c, traj_k = _targets(9, h, w)
        np.savez(tmp_path / "mv.npz", images_key_frames=image, depth_key_frames=depth,
                 K_key_frames=k, w2cs_key_frames=w2c, w2cs_all=traj_w2c, Ks_all=traj_k)
        argv = ["--npz_path", str(tmp_path / "mv.npz"), "--frame_buffer_max", "2"]
    got, want = _cli_pair(monkeypatch, models, jcli, tcli, argv + common)
    assert got.shape == (9, h, w, 3)
    _assert_frames_close(got, want)


@pytest.mark.parametrize("cli", ["gen3c_dynamic", "gen3c_multiview"])
@pytest.mark.parametrize("flag", [["--enable_prompt_encoder"], ["--parallel", "cp2tp2"],
                                  ["--parallel", "tp"], ["--parallel", "cfg2tp2"]])
def test_new_clis_refuse_unported_flags(cli, flag, tmp_path):
    """The flags of paths that were not ported before: the prompt encoder
    without the t5-11b files raises an error naming them; the
    tensor-parallel strategies (ported: tests/test_torch_tp.py, as
    multi-device cp and cfg2 and the offload flags are) reach
    build_gen3c_model, which validates them over 4 devices and then needs
    torchrun's 4 processes."""
    import importlib

    module = importlib.import_module(f"gen3c_tpu_torch.pipelines.{cli}")
    first = ["--npz_path", "x.npz"] if cli == "gen3c_multiview" else []
    args = module.create_parser().parse_args(first + flag + ["--device", "cpu"])
    if flag[0] == "--enable_prompt_encoder":
        args.model_preset, args.checkpoint_dir = "gen3c_tiny", str(tmp_path)
        with pytest.raises(FileNotFoundError, match="google-t5/t5-11b"):
            module.demo(args)
        return
    args.model_preset, args.num_devices = "gen3c_tiny", 4
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        module.demo(args)


@pytest.mark.parametrize("cli", ["gen3c_dynamic", "gen3c_multiview"])
def test_new_clis_default_to_the_card(cli):
    import importlib

    from gen3c_tpu.pipelines import gen3c_dynamic as jdyn
    from gen3c_tpu.pipelines import gen3c_multiview as jmv

    module = importlib.import_module(f"gen3c_tpu_torch.pipelines.{cli}")
    first = ["--npz_path", "x.npz"] if cli == "gen3c_multiview" else []
    ours = module.create_parser().parse_args(first)
    theirs = (jmv if cli == "gen3c_multiview" else jdyn).create_parser().parse_args(first)
    assert ours.device == "cuda"
    shared = set(vars(theirs)) - {"t5_backend"}
    assert shared <= set(vars(ours))
    assert all(getattr(ours, key) == getattr(theirs, key) for key in shared)


def test_dynamic_cli_subprocess(tmp_path):
    """The dynamic CLI as a user runs it, on the CPU, with masking and the
    fast preset's knobs."""
    from gen3c_tpu_torch.pipelines.factory import PRESETS

    _write_clip(tmp_path / "clip.npz", PRESETS["gen3c_tiny"], 9)
    out = subprocess.run(
        [sys.executable, "-m", "gen3c_tpu_torch.pipelines.gen3c_dynamic", "--device", "cpu",
         "--model_preset", "gen3c_tiny", "--num_steps", "8", "--perf_preset", "fast",
         "--input_video_path", str(tmp_path / "clip.npz"), "--num_video_frames", "9",
         "--trajectory", "left", "--foreground_masking", "--save_buffer",
         "--video_save_folder", str(tmp_path / "out"), "--checkpoint_dir", str(tmp_path / "none")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert os.listdir(tmp_path / "out")
    assert "c*" in out.stdout + out.stderr  # a cached condition-only step
