"""OpenEXR scanline codec for depth files (no OpenEXR or cv2 needed).

The port's own copy of gen3c_tpu/utils/exr.py: single-part scanline files,
EXR version 2, compression NONE, ZIPS or ZIP, pixel types HALF, FLOAT and
UINT; the writer gives that module's bytes. Unlike that module the reader
checks the
header's extents and the offset table against the size of the data before
it allocates or reads, so a malformed or hostile file raises ValueError
and not an IndexError, a struct.error or a huge allocation.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = 0x01312F76
_PIXEL_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_PIXEL_TYPES = {dt: code for code, dt in _PIXEL_DTYPES.items()}
_LINES_PER_CHUNK = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP
_COMPRESSION_NAMES = {0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ", 5: "PXR24",
                      6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}


def _zip_encode(raw: bytes) -> bytes:
    """OpenEXR ZIP chunk encode: split the bytes into two halves, delta
    predictor, deflate."""
    a = np.frombuffer(raw, np.uint8)
    half = (a.size + 1) // 2
    t = np.empty(a.size, np.uint8)
    t[:half] = a[0::2]
    t[half:] = a[1::2]
    d = np.empty(a.size, np.int16)
    d[0] = t[0]
    d[1:] = t[1:].astype(np.int16) - t[:-1].astype(np.int16) + 128
    return zlib.compress(d.astype(np.uint8).tobytes())


def _zip_decode(data: bytes, raw_size: int) -> bytes:
    """OpenEXR ZIP chunk decode: inflate, undo the delta predictor, then
    interleave the two halves back."""
    try:
        d = np.frombuffer(zlib.decompressobj().decompress(data, raw_size + 1), np.uint8)
    except zlib.error as e:
        raise ValueError(f"EXR zip chunk does not inflate: {e}") from None
    if d.size != raw_size:
        raise ValueError(f"EXR zip chunk decodes to {d.size} bytes, expected {raw_size}")
    s = d.astype(np.int64)
    s[1:] -= 128
    t = np.cumsum(s).astype(np.uint8)
    half = (raw_size + 1) // 2
    out = np.empty(raw_size, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _read_null_str(buf: bytes, pos: int) -> Tuple[str, int]:
    end = buf.find(b"\0", pos)
    if end < 0:
        raise ValueError("EXR header: unterminated string")
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_chlist(data: bytes):
    out, pos = [], 0
    while pos < len(data) and data[pos] != 0:
        name, pos = _read_null_str(data, pos)
        if pos + 16 > len(data):
            raise ValueError("EXR channel list is truncated")
        (ptype,) = struct.unpack_from("<i", data, pos)
        xs, ys = struct.unpack_from("<ii", data, pos + 8)  # after pLinear + reserved
        if (xs, ys) != (1, 1):
            raise ValueError(f"EXR subsampled channel {name!r} unsupported")
        if ptype not in _PIXEL_DTYPES:
            raise ValueError(f"EXR pixel type {ptype} unsupported")
        out.append((name, _PIXEL_DTYPES[ptype]))
        pos += 16
    if not out:
        raise ValueError("EXR file has no channels")
    return out


def read_exr(data: bytes) -> Tuple[Dict[str, np.ndarray], dict]:
    """Single-part scanline EXR bytes -> ({channel: (H, W)}, header)."""
    if len(data) < 9:
        raise ValueError("Not an EXR file (too short)")
    magic, version = struct.unpack_from("<II", data, 0)
    if magic != _MAGIC:
        raise ValueError("Not an EXR file (bad magic)")
    if version & 0xFF != 2 or (version >> 8) & 0x1A:  # tiled / deep / multi-part
        raise ValueError(f"Unsupported EXR variant (version word 0x{version:x}); only "
                         "single-part scanline v2 files are supported")
    pos, attrs = 8, {}
    while True:
        if pos >= len(data):
            raise ValueError("EXR header is truncated")
        if data[pos] == 0:
            break
        name, pos = _read_null_str(data, pos)
        type_, pos = _read_null_str(data, pos)
        if pos + 4 > len(data):
            raise ValueError("EXR header is truncated")
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        if size < 0 or pos + size > len(data):
            raise ValueError(f"EXR attribute {name!r} has a bad size {size}")
        attrs[name] = (type_, data[pos:pos + size])
        pos += size
    pos += 1  # header terminator
    for key, size in (("channels", 1), ("compression", 1), ("dataWindow", 16)):
        if key not in attrs or len(attrs[key][1]) < size:
            raise ValueError(f"EXR header lacks a valid {key!r}")

    channels = _parse_chlist(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    if comp not in _LINES_PER_CHUNK:
        raise ValueError(f"Unsupported EXR compression {_COMPRESSION_NAMES.get(comp, comp)}; "
                         "only NONE/ZIPS/ZIP")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1][:16])
    h, w = y1 - y0 + 1, x1 - x0 + 1
    line_order = attrs.get("lineOrder", (None, b"\0"))[1]
    if line_order[:1] == b"\2":
        raise ValueError("EXR random line order unsupported")
    line_bytes = sum(w * dt.itemsize for _, dt in channels)
    # every pixel is stored (NONE) or at least one byte of deflate stream
    # per chunk: extents the data cannot hold are refused before allocating
    if h <= 0 or w <= 0 or line_bytes * h > max(len(data), 1) * 1032:
        raise ValueError(f"EXR dataWindow {x0, y0, x1, y1} does not fit {len(data)} bytes")
    lpc = _LINES_PER_CHUNK[comp]
    n_chunks = (h + lpc - 1) // lpc
    if pos + 8 * n_chunks > len(data):
        raise ValueError("EXR offset table is truncated")
    offsets = struct.unpack_from(f"<{n_chunks}Q", data, pos)

    out = {name: np.empty((h, w), dt) for name, dt in channels}
    for off in offsets:
        if off + 8 > len(data):
            raise ValueError(f"EXR chunk offset {off} is past the end ({len(data)} bytes)")
        cy, size = struct.unpack_from("<ii", data, off)
        if not y0 <= cy <= y1 or (cy - y0) % lpc or size < 0 or off + 8 + size > len(data):
            raise ValueError(f"EXR chunk at {off}: bad line {cy} or size {size}")
        rows = min(lpc, y1 - cy + 1)
        raw = data[off + 8:off + 8 + size]
        want = line_bytes * rows
        if comp != 0 and size != want:
            raw = _zip_decode(raw, want)
        elif size != want:
            raise ValueError("EXR chunk size mismatch")
        o = 0
        for r in range(rows):
            for name, dt in channels:
                n = w * dt.itemsize
                out[name][cy - y0 + r] = np.frombuffer(raw[o:o + n], dt)
                o += n
    header = {"dataWindow": (x0, y0, x1, y1), "compression": _COMPRESSION_NAMES[comp],
              "channels": [(n, str(dt)) for n, dt in channels]}
    return out, header


def read_exr_depth(data: bytes, channel: Optional[str] = None) -> np.ndarray:
    """One depth plane as float32: channel ``channel``, else 'Z', else the
    file's only channel (cv2 writes grayscale EXRs as 'Y')."""
    chans, _ = read_exr(data)
    if channel is None:
        if "Z" in chans:
            channel = "Z"
        elif len(chans) == 1:
            channel = next(iter(chans))
        else:
            raise ValueError(f"EXR has channels {sorted(chans)}; specify one for depth")
    if channel not in chans:
        raise ValueError(f"EXR has no channel {channel!r} (has {sorted(chans)})")
    return chans[channel].astype(np.float32)


def _attr(name: str, type_: str, data: bytes) -> bytes:
    return name.encode() + b"\0" + type_.encode() + b"\0" + struct.pack("<i", len(data)) + data


def write_exr(channels: Dict[str, np.ndarray], compression: str = "zip") -> bytes:
    """(H, W) channel arrays -> single-part scanline EXR bytes. float16 is
    written as HALF, float32 as FLOAT, uint32 as UINT, anything else as
    float32; compression "none", "zips" or "zip"."""
    comp = {"none": 0, "zips": 2, "zip": 3}.get(compression.lower())
    if comp is None:
        raise ValueError(f"Unsupported EXR compression {compression!r}")
    if not channels:
        raise ValueError("write_exr needs at least one channel")
    names = sorted(channels)  # the channel list is sorted by name
    arrs = []
    h = w = None
    for name in names:
        a = np.asarray(channels[name])
        if a.ndim != 2:
            raise ValueError(f"Channel {name!r} must be (H, W), got {a.shape}")
        if a.dtype not in _PIXEL_TYPES:
            a = a.astype(np.float32)
        a = a.astype(a.dtype.newbyteorder("<"), copy=False)
        if h is None:
            h, w = a.shape
        elif a.shape != (h, w):
            raise ValueError("All EXR channels must share one (H, W)")
        arrs.append(a)
    chlist = b"".join(name.encode() + b"\0" + struct.pack("<i", _PIXEL_TYPES[a.dtype])
                      + b"\0\0\0\0" + struct.pack("<ii", 1, 1)  # pLinear, reserved, sampling
                      for name, a in zip(names, arrs)) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (_attr("channels", "chlist", chlist)
              + _attr("compression", "compression", struct.pack("<B", comp))
              + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", b"\0")
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    lpc = _LINES_PER_CHUNK[comp]
    chunks = []
    for y0 in range(0, h, lpc):
        # a chunk: each scanline's channels in the list's order
        raw = b"".join(a[y].tobytes() for y in range(y0, min(y0 + lpc, h)) for a in arrs)
        data = raw if comp == 0 else _zip_encode(raw)
        if comp != 0 and len(data) >= len(raw):
            data = raw  # stored raw where deflate does not help, as OpenEXR does
        chunks.append(struct.pack("<ii", y0, len(data)) + data)
    head = struct.pack("<II", _MAGIC, 2) + header
    offset = len(head) + 8 * len(chunks)
    table = []
    for c in chunks:
        table.append(struct.pack("<Q", offset))
        offset += len(c)
    return head + b"".join(table) + b"".join(chunks)


def write_exr_depth(depth: np.ndarray, channel: str = "Z", half: bool = False,
                    compression: str = "zip") -> bytes:
    """One (H, W) depth plane as EXR bytes (float32, or float16 with half)."""
    depth = np.asarray(depth).astype(np.float16 if half else np.float32)
    return write_exr({channel: depth}, compression=compression)
