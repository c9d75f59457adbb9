"""The port's own copies of gen3c_tpu's media utilities (``utils/io.py``,
``utils/mjpeg_avi.py``, ``utils/exr.py``) against the originals on the CPU.

The port imports nothing of gen3c_tpu, so it carries what it uses of these
modules; on the same inputs they must give the same bytes and arrays. The
EXR reader is also held to refuse, with ValueError, headers and offset
tables that the data cannot back (gen3c_tpu's trusts them).
"""

import io
import json
import struct

import numpy as np
import pytest

from gen3c_tpu.utils import exr as jexr
from gen3c_tpu.utils import io as jio
from gen3c_tpu.utils import mjpeg_avi as javi
from gen3c_tpu_torch.utils import exr as texr
from gen3c_tpu_torch.utils import io as tio
from gen3c_tpu_torch.utils import mjpeg_avi as tavi


def _frames(t=4, h=24, w=40, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("fps,quality", [(24.0, 90), (12.5, 75), (30, 50)])
def test_mjpeg_avi_bytes_match(fps, quality):
    video = _frames()
    got, want = io.BytesIO(), io.BytesIO()
    tavi.write_mjpeg_avi(got, video, fps=fps, quality=quality)
    javi.write_mjpeg_avi(want, video, fps=fps, quality=quality)
    assert got.getvalue() == want.getvalue()
    frames, rate = javi.read_mjpeg_avi(got.getvalue())
    assert frames.shape == video.shape and rate == pytest.approx(fps)


def test_mjpeg_avi_refuses_bad_frames():
    with pytest.raises(ValueError):
        tavi.write_mjpeg_avi(io.BytesIO(), np.zeros((0, 8, 8, 3), np.uint8))
    with pytest.raises(ValueError):
        tavi.write_mjpeg_avi(io.BytesIO(), np.zeros((2, 8, 8), np.uint8))


@pytest.mark.parametrize("quality", [5, 9])
def test_save_video_bytes_match(tmp_path, quality):
    """Without an ffmpeg backend both fall back to the same MJPEG AVI."""
    video = _frames(seed=1)
    got = tio.save_video(video, 24, str(tmp_path / "t" / "out.mp4"), quality=quality)
    want = jio.save_video(video, 24, str(tmp_path / "j" / "out.mp4"), quality=quality)
    assert got.replace("/t/", "/j/") == want
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("mode,size", [("RGB", None), ("RGBA", None), ("RGB", (30, 50)),
                                       ("L", (16, 16))])
def test_read_image_matches(tmp_path, mode, size):
    from PIL import Image

    rng = np.random.default_rng(2)
    chans = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    arr = rng.integers(0, 256, (20, 36, chans), dtype=np.uint8)
    path = str(tmp_path / "im.png")
    Image.fromarray(arr[..., 0] if chans == 1 else arr, mode).save(path)
    h, w = size if size else (None, None)
    got, want = tio.read_image_bcthw(path, h, w), jio.read_image_bcthw(path, h, w)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_read_prompts_matches(tmp_path):
    path = tmp_path / "p.jsonl"
    path.write_text("\n".join(json.dumps({"prompt": f"p{i}", "k": i}) for i in range(3))
                    + "\n\n   \n")
    assert tio.read_prompts_from_file(str(path)) == jio.read_prompts_from_file(str(path))


@pytest.mark.parametrize("comp", ["none", "zips", "zip"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.uint32])
def test_read_exr_matches(comp, dtype):
    rng = np.random.default_rng(3)
    a = (rng.uniform(0, 50, (37, 21))).astype(dtype)
    b = (rng.uniform(0, 5, (37, 21))).astype(dtype)
    data = jexr.write_exr({"Z": a, "B": b}, compression=comp)
    (got, ghdr), (want, whdr) = texr.read_exr(data), jexr.read_exr(data)
    assert ghdr == whdr and set(got) == set(want) == {"Z", "B"}
    for name in want:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(texr.read_exr_depth(data), jexr.read_exr_depth(data))
    np.testing.assert_array_equal(texr.read_exr_depth(data, "B"), jexr.read_exr_depth(data, "B"))


def test_read_exr_depth_single_channel_matches():
    depth = np.random.default_rng(4).uniform(0.5, 9, (12, 17)).astype(np.float32)
    for half in (False, True):
        data = jexr.write_exr_depth(depth, channel="Y", half=half)
        np.testing.assert_array_equal(texr.read_exr_depth(data), jexr.read_exr_depth(data))
    two = jexr.write_exr({"A": depth, "C": depth})
    with pytest.raises(ValueError):
        texr.read_exr_depth(two)  # two channels, none named Z
    with pytest.raises(ValueError):
        texr.read_exr_depth(two, "Q")


def _header_end(data: bytes) -> int:
    """Offset of the offset table: after the header's terminating NUL."""
    pos = 8
    while data[pos] != 0:
        for _ in range(2):
            pos = data.index(b"\0", pos) + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4 + size
    return pos + 1


def _malformed():
    good = jexr.write_exr({"Z": np.ones((40, 30), np.float32)}, compression="zip")
    table = _header_end(good)
    huge = good.replace(struct.pack("<iiii", 0, 0, 29, 39), struct.pack("<iiii", 0, 0, 29, 10 ** 8))
    past = bytearray(good)
    struct.pack_into("<Q", past, table, len(good) + 100)
    bad_line = bytearray(good)
    first = struct.unpack_from("<Q", good, table)[0]
    struct.pack_into("<i", bad_line, first, 1000)
    bad_size = bytearray(good)
    struct.pack_into("<i", bad_size, first + 4, 10 ** 7)
    return {
        "too_short": good[:6],
        "truncated_header": good[:40],
        "truncated_table": good[:table + 3],
        "huge_data_window": huge,
        "offset_past_end": bytes(past),
        "bad_chunk_line": bytes(bad_line),
        "bad_chunk_size": bytes(bad_size),
        "bad_magic": b"\0" * 4 + good[4:],
        "bad_deflate": good[:first + 8] + b"\xff" * (len(good) - first - 8),
    }


@pytest.mark.parametrize("case", list(_malformed()))
def test_read_exr_refuses_malformed_files(case):
    with pytest.raises(ValueError):
        texr.read_exr(_malformed()[case])
