"""MJPEG-in-AVI writer and reader (no ffmpeg needed).

The port's own copy of gen3c_tpu/utils/mjpeg_avi.py: the writer gives the
same file byte for byte, and the reader the same frames. Each frame is a
JPEG (PIL), in the standard layout

  RIFF 'AVI ' [ LIST'hdrl' [avih, LIST'strl'[strh,strf]],
               LIST'movi' ['00dc' jpeg]*, 'idx1' ]
"""

from __future__ import annotations

import io
import struct
from typing import IO, List, Optional, Tuple, Union

import numpy as np

_AVIF_HASINDEX = 0x00000010


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def encode_jpeg_frame(frame: np.ndarray, quality: int = 90) -> bytes:
    """One (H, W, 3) uint8 frame -> JPEG bytes."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="jpeg", quality=quality)
    return buf.getvalue()


def write_mjpeg_avi(dst: Union[str, IO[bytes]], frames: Optional[np.ndarray],
                    fps: float = 24.0, quality: int = 90, jpegs: Optional[List[bytes]] = None,
                    frame_shape: Optional[Tuple[int, int]] = None) -> None:
    """Write (T, H, W, 3) uint8 frames as an MJPEG AVI to a path or a file;
    or, instead of ``frames``, the JPEGs of ``encode_jpeg_frame`` with
    their ``frame_shape`` (H, W)."""
    if jpegs is not None:
        if frame_shape is None or not jpegs:
            raise ValueError("jpegs= needs at least one JPEG and frame_shape=(H, W)")
        T, (H, W) = len(jpegs), frame_shape
    else:
        frames = np.asarray(frames)
        if frames.ndim != 4 or frames.shape[-1] != 3 or len(frames) == 0:
            raise ValueError(f"expected (T > 0, H, W, 3) frames, got {frames.shape}")
        T, H, W = frames.shape[:3]
        jpegs = [encode_jpeg_frame(fr, quality) for fr in frames]
    max_bytes = max(len(j) for j in jpegs)
    scale = 1000  # fps as the rational rate / scale
    rate = int(round(fps * scale))

    avih = struct.pack(
        "<14I",
        int(1e6 / max(fps, 1e-6)),  # dwMicroSecPerFrame
        int(max_bytes * fps) + 1,  # dwMaxBytesPerSec
        0,  # dwPaddingGranularity
        _AVIF_HASINDEX,
        T,  # dwTotalFrames
        0,  # dwInitialFrames
        1,  # dwStreams
        max_bytes,  # dwSuggestedBufferSize
        W, H,
        0, 0, 0, 0,  # dwReserved
    )
    strh = (b"vids" + b"MJPG"
            + struct.pack("<IHHIIIIIIIII",
                          0,  # dwFlags
                          0, 0,  # wPriority, wLanguage
                          0,  # dwInitialFrames
                          scale, rate,
                          0,  # dwStart
                          T,  # dwLength (frames)
                          max_bytes,  # dwSuggestedBufferSize
                          0xFFFFFFFF,  # dwQuality
                          0,  # dwSampleSize
                          0)  # rcFrame left/top
            + struct.pack("<HH", W, H))  # rcFrame right/bottom
    strf = struct.pack("<IiiHH4sIiiII", 40, W, H, 1, 24, b"MJPG", W * H * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))

    # the pieces of the file in order, joined once at the end (appending
    # each frame to one bytes object copies the whole file every frame)
    movi, idx = [b"movi"], []
    offset = 4
    for j in jpegs:
        # an idx1 offset points at the chunk's fourcc, from the start of
        # the 'movi' list payload
        idx.append(b"00dc" + struct.pack("<III", 0x10, offset, len(j)))
        movi.append(_chunk(b"00dc", j))
        offset += len(movi[-1])
    movi_size = struct.pack("<I", offset)
    idx = b"".join(idx)
    riff = [b"AVI ", hdrl, b"LIST", movi_size, *movi, _chunk(b"idx1", idx)]
    data = b"".join([b"RIFF", struct.pack("<I", sum(len(p) for p in riff))] + riff)
    if hasattr(dst, "write"):
        dst.write(data)
    else:
        with open(dst, "wb") as f:
            f.write(data)


def read_mjpeg_avi(src: Union[str, bytes, IO[bytes]]) -> Tuple[np.ndarray, float]:
    """An MJPEG AVI (a path, bytes or a file) -> ((T, H, W, 3) uint8, fps)."""
    from PIL import Image

    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    elif hasattr(src, "read"):
        data = src.read()
    else:
        with open(src, "rb") as f:
            data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not a RIFF/AVI file")
    fps = 24.0
    frames = []

    def walk(buf: bytes):
        nonlocal fps
        pos = 0
        while pos + 8 <= len(buf):
            fourcc = buf[pos:pos + 4]
            (size,) = struct.unpack("<I", buf[pos + 4:pos + 8])
            payload = buf[pos + 8:pos + 8 + size]
            if fourcc == b"LIST":
                walk(payload[4:])
            elif fourcc == b"strh" and payload[:4] == b"vids":
                scale, rate = struct.unpack("<II", payload[20:28])
                if scale:
                    fps = rate / scale
            elif fourcc in (b"00dc", b"00db") and size > 0:
                frames.append(np.asarray(Image.open(io.BytesIO(payload)).convert("RGB")))
            pos += 8 + size + (size % 2)

    walk(data[12:])
    if not frames:
        raise ValueError("no video frames found in AVI")
    return np.stack(frames), fps
