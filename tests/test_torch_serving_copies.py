"""The port's copies of gen3c_tpu's JAX-free serving modules, its native
host libraries and its incremental video save, against the originals on
the CPU.

``serving/{api_types,serialization,encoding}.py``, ``serving/viewer.html``
and ``native/{camera_path,point_raster,render_buffer,gen3c_native,
viewer_main}.cpp`` must be the originals byte for byte once each ``gen3c_tpu.`` is rewritten to
``gen3c_tpu_torch.``; the ctypes bindings, built into the port's own
``native/_build/``, must give the JAX bindings' outputs; and
``IncrementalVideoSaver`` must write ``save_video``'s bytes. Each CLI of
the port, run over two chunks of the tiny preset, must save through the
saver and reuse every frame it encoded while the chunks ran.
"""

import json
import os

import numpy as np
import pytest
import torch

from gen3c_tpu.native import camera_path as jcp
from gen3c_tpu.native import point_raster as jpr
from gen3c_tpu.native import render_buffer as jrb
from gen3c_tpu.utils import io as jio
from gen3c_tpu_torch.native import BUILD_DIR
from gen3c_tpu_torch.native import camera_path as tcp
from gen3c_tpu_torch.native import point_raster as tpr
from gen3c_tpu_torch.native import render_buffer as trb
from gen3c_tpu_torch.utils import io as tio
from gen3c_tpu_torch.utils import log as tlog

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = ["serving/api_types.py", "serving/serialization.py", "serving/encoding.py",
          "serving/viewer.html", "native/camera_path.cpp", "native/point_raster.cpp",
          "native/render_buffer.cpp", "native/gen3c_native.cpp", "native/viewer_main.cpp"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_original_with_imports_rewritten(rel):
    with open(os.path.join(REPO, "gen3c_tpu", rel), "rb") as f:
        want = f.read().replace(b"gen3c_tpu.", b"gen3c_tpu_torch.")
    with open(os.path.join(REPO, "gen3c_tpu_torch", rel), "rb") as f:
        assert f.read() == want


def _keyframes(n=5, seed=0):
    """Seeded (3, 4) c2ws: random rotations about random axes, random
    positions; and their fovs and times."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        angle = rng.uniform(-0.6, 0.6)
        kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        rot = np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx
        c2w = np.concatenate([rot, rng.uniform(-1, 1, (3, 1))], axis=1).astype(np.float32)
        out.append((c2w, float(rng.uniform(30, 70)), float(i + rng.uniform(0, 0.5))))
    return out


def _path(module, keyframes):
    path = module.CameraPath()
    for c2w, fov, t in keyframes:
        path.add_keyframe_from_c2w(c2w, fov=fov, timestamp=t)
    return path


def test_camera_path_matches_jax(tmp_path):
    kfs = _keyframes()
    ours, theirs = _path(tcp, kfs), _path(jcp, kfs)
    assert len(ours) == len(theirs) == 5
    for n in (1, 7, 33):
        for a, b in zip(ours.sample(n), theirs.sample(n)):
            np.testing.assert_array_equal(a, b)
    for t in (0.0, 0.31, 0.5, 0.999, 1.0):
        c2w, fov = ours.eval(t)
        jc2w, jfov = theirs.eval(t)
        np.testing.assert_array_equal(c2w, jc2w)
        assert fov == jfov
    for (c2w, fov, t), (jc2w, jfov, jt) in zip(ours.keyframes(), theirs.keyframes()):
        np.testing.assert_array_equal(c2w, jc2w)
        assert (fov, t) == (jfov, jt)
    ours.save(str(tmp_path / "ours.json"))
    theirs.save(str(tmp_path / "theirs.json"))
    text = (tmp_path / "ours.json").read_text()
    assert text == (tmp_path / "theirs.json").read_text() and json.loads(text)
    loaded = tcp.CameraPath()
    loaded.load(str(tmp_path / "theirs.json"))
    np.testing.assert_array_equal(loaded.sample(9)[0], theirs.sample(9)[0])
    ours.play_time = 0.25
    assert ours.play_time == pytest.approx(0.25)
    with pytest.raises(IndexError):
        ours.get_keyframe(5)
    with pytest.raises(IOError):
        loaded.load(str(tmp_path / "missing.json"))
    assert os.path.exists(os.path.join(BUILD_DIR, "libcamera_path.so"))


@pytest.mark.parametrize("radius", [0.5, 1.0, 2.5])
def test_point_raster_matches_jax(radius):
    rng = np.random.default_rng(1)
    n, f, h, w = 20_000, 3, 40, 64
    points = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(1.5, 4, (n, 1))], 1)
    points = points.astype(np.float32)
    points[:50, 2] = -1.0  # behind the camera
    colors = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    w2cs = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    w2cs[:, 0, 3] = np.linspace(0, 0.3, f)
    ks = np.tile(np.array([[50, 0, w / 2], [0, 50, h / 2], [0, 0, 1]], np.float32), (f, 1, 1))
    got = tpr.raster_points(points, colors, w2cs, ks, h, w, point_radius=radius)
    want = jpr.raster_points(points, colors, w2cs, ks, h, w, point_radius=radius)
    assert got.shape == (f, h, w, 3) and got.any()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tpr.raster_points(points[:, :2], colors, w2cs, ks, h, w)


@pytest.mark.parametrize("srgb,exposure", [(True, 0.0), (False, 0.0), (True, 0.7)])
def test_render_buffer_matches_jax(srgb, exposure):
    rng = np.random.default_rng(2)
    frames = rng.uniform(0, 1, (4, 2, 16, 24, 3)).astype(np.float32)
    ours, theirs = trb.RenderBuffer(16, 24), jrb.RenderBuffer(16, 24)
    stack_ours = trb.RenderBuffer.for_shape((2, 16, 24, 3))
    for fr in frames:
        ours.accumulate(fr[0])
        theirs.accumulate(fr[0])
        stack_ours.accumulate(fr)
    assert ours.spp == theirs.spp == 4
    np.testing.assert_array_equal(ours.readout(exposure, srgb), theirs.readout(exposure, srgb))
    assert stack_ours.readout(exposure, srgb).shape == (2, 16, 24, 3)
    ours.clear()
    assert ours.spp == 0 and not ours.readout().any()
    with pytest.raises(ValueError):
        ours.accumulate(frames[0])


def _video(t=7, h=24, w=40, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), dtype=np.uint8)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def info_lines(monkeypatch):
    lines = []
    monkeypatch.setattr(tlog, "info", lambda msg, rank0_only=True: lines.append(msg))
    return lines


@pytest.mark.parametrize("case", ["whole", "trimmed", "edited", "no_updates", "disabled"])
def test_incremental_saver_writes_save_videos_bytes(tmp_path, monkeypatch, info_lines, case):
    """Frames encoded chunk by chunk, then saved: the file is the one
    save_video (either package's) writes for the video saved, whether the
    saved video is the one encoded, a trimmed one, one with an edited
    frame, one never passed to update, or with GEN3C_INCREMENTAL_SAVE=0."""
    if case == "disabled":
        monkeypatch.setenv("GEN3C_INCREMENTAL_SAVE", "0")
    video = _video()
    saver = tio.IncrementalVideoSaver(24, quality=5)
    if case != "no_updates":
        saver.update(video[:4])
        saver.update(video[:4])  # nothing new
        saver.update(video)
    final = {"trimmed": video[:5], "edited": video.copy()}.get(case, video)
    if case == "edited":
        final[2, 0, 0] ^= 1
    got = saver.save(final, str(tmp_path / "t" / "out.mp4"))
    want = jio.save_video(final, 24, str(tmp_path / "j" / "out.mp4"), quality=5)
    jsaver = jio.IncrementalVideoSaver(24, quality=5)
    jsaver.update(video)
    also = jsaver.save(final, str(tmp_path / "k" / "out.mp4"))
    assert got.replace("/t/", "/j/") == want and got.endswith(".avi")
    assert _read(got) == _read(want) == _read(also)
    reused = {"whole": 7, "trimmed": 5, "edited": 6, "no_updates": 0}.get(case)
    saves = [m for m in info_lines if m.startswith("incremental save")]
    if reused is None:
        assert not saves
    else:
        assert saves == [f"incremental save: reused {reused}/{len(final)} pre-encoded frames"]


def test_incremental_saver_falls_back_to_save_video(tmp_path, monkeypatch, info_lines):
    """An encode error in the worker gives save_video's file; an error
    writing the AVI goes on down save_video's chain (PNG frames), leaving
    no partial AVI."""
    import gen3c_tpu_torch.utils.mjpeg_avi as tavi

    video = _video(t=3)
    want = jio.save_video(video, 24, str(tmp_path / "j" / "out.mp4"))
    saver = tio.IncrementalVideoSaver(24)
    real = tavi.encode_jpeg_frame
    monkeypatch.setattr(tavi, "encode_jpeg_frame", lambda *a: 1 / 0)
    saver.update(video)
    saver._thread.join()
    assert isinstance(saver._error, ZeroDivisionError)
    monkeypatch.setattr(tavi, "encode_jpeg_frame", real)
    assert _read(saver.save(video, str(tmp_path / "t" / "out.mp4"))) == _read(want)
    saver = tio.IncrementalVideoSaver(24)
    monkeypatch.setattr(tavi, "write_mjpeg_avi", lambda *a, **k: 1 / 0)
    path = saver.save(video, str(tmp_path / "u" / "out.mp4"))
    assert path == str(tmp_path / "u" / "out") and len(os.listdir(path)) == 4  # + fps.txt
    assert not os.path.exists(tmp_path / "u" / "out.avi")


def test_mjpeg_avi_from_jpegs_matches_jax(tmp_path):
    """write_mjpeg_avi(jpegs=, frame_shape=) and read_mjpeg_avi against
    gen3c_tpu's."""
    import io

    from gen3c_tpu.utils import mjpeg_avi as javi
    from gen3c_tpu_torch.utils import mjpeg_avi as tavi

    video = _video(t=4)
    jpegs = [tavi.encode_jpeg_frame(fr, 80) for fr in video]
    got, want = io.BytesIO(), io.BytesIO()
    tavi.write_mjpeg_avi(got, None, fps=12.5, jpegs=jpegs, frame_shape=video.shape[1:3])
    javi.write_mjpeg_avi(want, video, fps=12.5, quality=80)
    assert got.getvalue() == want.getvalue()
    frames, fps = tavi.read_mjpeg_avi(got.getvalue())
    jframes, jfps = javi.read_mjpeg_avi(got.getvalue())
    np.testing.assert_array_equal(frames, jframes)
    assert fps == jfps == pytest.approx(12.5)
    with pytest.raises(ValueError):
        tavi.write_mjpeg_avi(io.BytesIO(), None, jpegs=jpegs)
    with pytest.raises(ValueError):
        tavi.read_mjpeg_avi(b"RIFF\0\0\0\0WAVE")


@pytest.mark.parametrize("sizes", [(5, 8, 1), (2, 2, 2, 4), (7,)])
def test_mjpeg_avi_assembly_matches_jax(sizes):
    """The AVI assembled from JPEG payloads of odd and even lengths (each
    chunk padded to an even size, the index offsets past the padding)."""
    import io

    from gen3c_tpu.utils import mjpeg_avi as javi
    from gen3c_tpu_torch.utils import mjpeg_avi as tavi

    rng = np.random.default_rng(len(sizes))
    jpegs = [rng.integers(0, 256, n * 1001, dtype=np.uint8).tobytes() for n in sizes]
    got, want = io.BytesIO(), io.BytesIO()
    tavi.write_mjpeg_avi(got, None, fps=24.0, jpegs=jpegs, frame_shape=(8, 16))
    javi.write_mjpeg_avi(want, None, fps=24.0, jpegs=jpegs, frame_shape=(8, 16))
    assert got.getvalue() == want.getvalue()


def test_read_video_matches_jax(tmp_path):
    """The client's video reader on an AVI and on a frame directory."""
    video = _video(t=3)
    avi = jio.save_video(video, 10, str(tmp_path / "v.mp4"))
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    from PIL import Image

    for i, fr in enumerate(video):
        Image.fromarray(fr).save(frames_dir / f"{i:03d}.png")
    (frames_dir / "fps.txt").write_text("12")
    for path, size in ((avi, (None, None)), (str(frames_dir), (None, None)),
                       (str(frames_dir), (16, 20))):
        got, fps = tio.read_video_bcthw(path, *size)
        want, jfps = jio.read_video_bcthw(path, *size)
        np.testing.assert_array_equal(got, want)
        assert fps == jfps


def _cli_inputs(root, p):
    """A packaged 17-frame clip (dynamic), a multiview npz of 17 frames and a
    seed image, for the tiny preset."""
    from PIL import Image

    from gen3c_tpu_torch.ops.camera import generate_camera_trajectory
    from gen3c_tpu_torch.pipelines.depth import default_intrinsics

    rng = np.random.default_rng(0)
    F, h, w = 2 * p.chunk_size - 1, p.height, p.width
    depth = np.full((F, 1, h, w), 2.0, np.float32)
    image = rng.uniform(-1, 1, (F, 3, h, w)).astype(np.float32)
    k = np.repeat(default_intrinsics(h, w)[None], F, 0)
    w2c, _ = generate_camera_trajectory("left", np.eye(4, dtype=np.float32),
                                        default_intrinsics(h, w), F, 0.3, "center_facing", 1.0)
    w2c = np.asarray(w2c, np.float32).reshape(F, 4, 4)
    np.savez(f"{root}/clip.npz", image=image, depth=depth, intrinsics=k,
             w2c=np.repeat(np.eye(4, dtype=np.float32)[None], F, 0))
    np.savez(f"{root}/mv.npz", images_key_frames=image[:3], depth_key_frames=depth[:3],
             K_key_frames=k[:3], w2cs_key_frames=w2c[:3], w2cs_all=w2c, Ks_all=k)
    Image.fromarray((rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)).save(f"{root}/in.png")
    return F


@pytest.mark.parametrize("cli", ["gen3c_single_image", "gen3c_dynamic", "gen3c_multiview"])
def test_cli_saves_incrementally_over_two_chunks(tmp_path, info_lines, cli):
    """Each CLI at gen3c_tiny over two chunks: the saver is fed after each
    chunk and reuses every frame at the save; the file reads back as the
    CLI's frames, and is the one save_video writes for them."""
    import importlib

    from gen3c_tpu.utils.mjpeg_avi import read_mjpeg_avi
    from gen3c_tpu_torch.pipelines.factory import GEN3C_TINY_PRESET

    mod = importlib.import_module(f"gen3c_tpu_torch.pipelines.{cli}")
    F = _cli_inputs(str(tmp_path), GEN3C_TINY_PRESET)
    own = {"gen3c_single_image": ["--input_image_path", f"{tmp_path}/in.png",
                                  "--depth_source", "heuristic"],
           "gen3c_dynamic": ["--input_video_path", f"{tmp_path}/clip.npz"],
           "gen3c_multiview": ["--npz_path", f"{tmp_path}/mv.npz", "--frame_buffer_max", "2"]}
    args = mod.create_parser().parse_args(
        own[cli] + ["--device", "cpu", "--model_preset", "gen3c_tiny", "--num_steps", "1",
                    "--num_video_frames", str(F), "--video_save_folder", f"{tmp_path}/out",
                    "--checkpoint_dir", f"{tmp_path}/none"])
    record = {}
    path = mod.demo(args, record=record)
    assert f"incremental save: reused {F}/{F} pre-encoded frames" in info_lines
    assert path.endswith(".avi")
    frames, _ = read_mjpeg_avi(path)
    assert frames.shape == (F, GEN3C_TINY_PRESET.height, GEN3C_TINY_PRESET.width, 3)
    if "video" in record:  # the dynamic and multiview CLIs keep the frames saved
        want = jio.save_video(record["video"], args.fps, str(tmp_path / "j" / "v.mp4"))
        assert _read(path) == _read(want)
