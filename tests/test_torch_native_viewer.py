"""The port's CPython extension (``native/ext.py`` over
``native/gen3c_native.cpp``) and headless viewer (``native/viewer.py`` over
``native/viewer_main.cpp``) against gen3c_tpu's on the CPU.

Both packages build the same C++ (the port's copies are the originals,
tests/test_torch_serving_copies.py), the port's into its own
``native/_build/``. On the cases tests/test_native_ext.py and
tests/test_native_viewer.py drive, every result must be JAX's bit for bit:
the extension's camera path, render buffer and rasterizer, and the
viewer's replies and every file it writes (PPM frames, camera-path JSON).
"""

import os

import numpy as np
import pytest

from gen3c_tpu.native import ext as jext
from gen3c_tpu.native import viewer as jviewer
from gen3c_tpu_torch.native import BUILD_DIR
from gen3c_tpu_torch.native import camera_path as tcp
from gen3c_tpu_torch.native import ext as text
from gen3c_tpu_torch.native import viewer as tviewer


def _random_path(cls, seed=0):
    """test_native_ext.py's path: 4 keyframes, small rotations about y,
    random positions, fov 40-55."""
    rng = np.random.RandomState(seed)
    p = cls()
    for i in range(4):
        c2w = np.eye(4, dtype=np.float32)[:3]
        th = rng.uniform(-0.3, 0.3)
        c2w[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                                [-np.sin(th), 0, np.cos(th)]], np.float32)
        c2w[:, 3] = rng.uniform(-1, 1, 3).astype(np.float32)
        p.add_keyframe_from_c2w(c2w, fov=float(40 + 5 * i), timestamp=float(i))
    return p


@pytest.mark.parametrize("seed", [0, 1])
def test_ext_camera_path_matches_jax(tmp_path, seed):
    ours, theirs = _random_path(text.CameraPath, seed), _random_path(jext.CameraPath, seed)
    assert len(ours) == len(theirs) == 4
    for t in (0.0, 0.33, 0.5, 0.77, 1.0):
        (m, f), (jm, jf) = ours.eval(t), theirs.eval(t)
        np.testing.assert_array_equal(m, jm)
        assert f == jf
    for n in (1, 7, 9):
        for a, b in zip(ours.sample(n), theirs.sample(n)):
            np.testing.assert_array_equal(a, b)
    for i in range(4):
        (m, f, t), (jm, jf, jt) = ours.get_keyframe(i), theirs.get_keyframe(i)
        np.testing.assert_array_equal(m, jm)
        assert (f, t) == (jf, jt)
    ours.save(str(tmp_path / "ours.json"))
    theirs.save(str(tmp_path / "theirs.json"))
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "theirs.json").read_bytes()
    # the JSON interoperates with the ctypes stack both ways
    loaded = tcp.CameraPath()
    loaded.load(str(tmp_path / "ours.json"))
    back = text.CameraPath()
    back.load(str(tmp_path / "theirs.json"))
    np.testing.assert_array_equal(loaded.sample(7)[0], ours.sample(7)[0])
    np.testing.assert_array_equal(back.sample(7)[0], theirs.sample(7)[0])
    assert os.path.dirname(text._build()) == BUILD_DIR


def test_ext_camera_path_errors_match_jax():
    for mod in (text, jext):
        p = mod.CameraPath()
        with pytest.raises(ValueError):
            p.eval(0.5)  # an empty path
        p.add_keyframe_from_c2w(np.eye(4, dtype=np.float32)[:3])
        with pytest.raises(IndexError):
            p.get_keyframe(3)
        p.clear()
        assert len(p) == 0
        p.play_time = 0.25
        assert abs(p.play_time - 0.25) < 1e-7


@pytest.mark.parametrize("exposure", [0.0, -1.0, 0.5])
@pytest.mark.parametrize("srgb", [True, False])
def test_ext_render_buffer_matches_jax(exposure, srgb):
    rng = np.random.RandomState(2)
    frames = [rng.rand(5, 7, 3).astype(np.float32) for _ in range(3)]
    ours, theirs = text.RenderBuffer(5, 7), jext.RenderBuffer(5, 7)
    for f in frames:
        ours.accumulate(f)
        theirs.accumulate(f)
    assert ours.spp == theirs.spp == 3
    np.testing.assert_array_equal(ours.readout(exposure, srgb), theirs.readout(exposure, srgb))
    ours.clear()
    assert ours.spp == 0 and ours.readout().max() == 0
    with pytest.raises(ValueError):
        ours.accumulate(np.zeros((5, 7, 4), np.float32))


@pytest.mark.parametrize("radius", [1.0, 2.5])
def test_ext_raster_points_matches_jax(radius):
    rng = np.random.RandomState(3)
    n = 500
    points = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    points[:, 2] += 3.0
    colors = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    w2cs = np.tile(np.eye(4, dtype=np.float32)[None], (2, 1, 1))
    w2cs[1, 0, 3] = 0.2
    ks = np.tile(np.array([[[40, 0, 24], [0, 40, 16], [0, 0, 1]]], np.float32), (2, 1, 1))
    got = text.raster_points(points, colors, w2cs, ks, 32, 48, radius)
    assert got.any()
    np.testing.assert_array_equal(got, jext.raster_points(points, colors, w2cs, ks, 32, 48,
                                                          radius))
    with pytest.raises(ValueError):
        text.raster_points(points[:, :2], colors, w2cs, ks, 32, 48)


# test_native_viewer.py's sessions: the commands, {out} for a file or
# directory the viewer writes and {cloud} for the seeded point cloud
SESSIONS = {
    "seed_orbit_render": ["load {cloud}", "size 160 120", "render {out}/view.ppm",
                          "orbit 0.8 0.3", "render {out}/view2.ppm", "info"],
    "progressive_aa": ["load {cloud}", "size 96 64", "render {out}/a.ppm 1",
                       "render {out}/b.ppm 8"],
    "keyframes_and_json": ["load {cloud}", "kf add", "orbit 0.5 0.1", "fov 45", "kf add",
                           "orbit -0.5 -0.1", "kf add", "kf list", "kf move 1 0.1 0 0",
                           "kf fov 1 40", "kf time 1 0.5", "kf del 2", "kf list",
                           "kf save {out}/path.json", "kf del 0", "kf load {out}/path.json",
                           "kf list"],
    "spline_path_render": ["load {cloud}", "size 80 60", "kf add", "orbit 0.7 0.0", "kf add",
                           "path render 5 {out}/frames", "dolly 0.5", "target 0 0 2",
                           "render {out}/close.ppm 2"],
    "errors": ["load /nonexistent.bin", "kf del 7", "path render 5 {out}/none", "bogus",
               "info"],
}


def _session(viewer_mod, commands, out, cloud):
    os.makedirs(os.path.join(out, "frames"))
    with viewer_mod.NativeViewer() as v:
        replies = [v.send(c.format(out=out, cloud=cloud)) for c in commands]
    files = {}
    for root, _, names in os.walk(out):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, out)] = f.read()
    return [r.replace(out, "{out}").replace(cloud, "{cloud}") for r in replies], files


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_viewer_session_matches_jax(tmp_path, name):
    """The same session in both viewers: the same replies, the same files
    byte for byte; the rendered frames show the seeded cube."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.5, 0.5, size=(5000, 3)).astype(np.float32)
    pts[:, 2] += 2.0
    cols = (np.clip(pts + 0.5, 0, 1) * 255).astype(np.uint8)
    cloud = str(tmp_path / "cloud.bin")
    tviewer.write_pointcloud(cloud, pts, cols)
    jcloud = str(tmp_path / "jcloud.bin")
    jviewer.write_pointcloud(jcloud, pts, cols)
    assert open(cloud, "rb").read() == open(jcloud, "rb").read()
    replies, files = _session(tviewer, SESSIONS[name], str(tmp_path / "port"), cloud)
    want_replies, want_files = _session(jviewer, SESSIONS[name], str(tmp_path / "jax"), cloud)
    assert replies == want_replies
    assert sorted(files) == sorted(want_files)
    for rel, data in files.items():
        assert data == want_files[rel], rel
    ppms = [rel for rel in files if rel.endswith(".ppm")]
    if name == "errors":
        assert not ppms and all(r.startswith("err") for r in replies[:4])
        assert replies[4].startswith("info")
    elif any(c.startswith(("render", "path render")) for c in SESSIONS[name]):
        assert ppms
        for rel in ppms:
            img = tviewer.read_ppm(str(tmp_path / "port" / rel))
            assert img.ndim == 3 and img.shape[2] == 3 and (img > 0).mean() > 0.01
    if name == "keyframes_and_json":
        assert "path.json" in files and "2 keyframes" in replies[-1]
    if name == "spline_path_render":
        assert sorted(r for r in files if r.startswith("frames")) == [
            os.path.join("frames", f"frame_{i:04d}.ppm") for i in range(5)]
    assert os.path.dirname(tviewer.build_viewer()) == BUILD_DIR
