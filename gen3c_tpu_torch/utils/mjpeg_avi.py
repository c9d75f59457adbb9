"""MJPEG-in-AVI writer (no ffmpeg needed).

The port's own copy of the writer of gen3c_tpu/utils/mjpeg_avi.py, byte for
byte the same file: each frame a JPEG (PIL), in the standard layout

  RIFF 'AVI ' [ LIST'hdrl' [avih, LIST'strl'[strh,strf]],
               LIST'movi' ['00dc' jpeg]*, 'idx1' ]
"""

from __future__ import annotations

import io
import struct
from typing import IO, Union

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


def write_mjpeg_avi(dst: Union[str, IO[bytes]], frames: np.ndarray, fps: float = 24.0,
                    quality: int = 90) -> None:
    """Write (T, H, W, 3) uint8 frames as an MJPEG AVI to a path or a file."""
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

    movi_payload = b"movi"
    idx = b""
    for j in jpegs:
        # an idx1 offset points at the chunk's fourcc, from the start of
        # the 'movi' list payload
        idx += b"00dc" + struct.pack("<III", 0x10, len(movi_payload), len(j))
        movi_payload += _chunk(b"00dc", j)
    riff_payload = b"AVI " + hdrl + _chunk(b"LIST", movi_payload) + _chunk(b"idx1", idx)
    data = b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload
    if hasattr(dst, "write"):
        dst.write(data)
    else:
        with open(dst, "wb") as f:
            f.write(data)
