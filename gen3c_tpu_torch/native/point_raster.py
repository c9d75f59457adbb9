"""ctypes bindings for the native point-cloud preview rasterizer.

The C++ library (point_raster.cpp) provides the serving layer's instant
point-cloud preview — the capability the reference GUI renders natively
in the instant-ngp viewer (gui/src/testbed.cu:380-386 point-cloud /
cache display). A z-buffered square-splat rasterizer on the host keeps
preview traffic off the GPU; the fidelity-grade splat of ops/geometry.py
(kernel K5) remains the path used for diffusion conditioning.

Built on demand with g++ (``gen3c_tpu_torch.native.load_library``). The
port's copy of gen3c_tpu/native/point_raster.py.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading

import numpy as np

from gen3c_tpu_torch.native import load_library

_LIB = None
_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = load_library("point_raster.cpp", std="c++17")
            f32p = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.point_raster_path.argtypes = [
                f32p, u8p, ctypes.c_int64, f32p, f32p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_uint8, ctypes.c_float, u8p,
            ]
            lib.point_raster_path.restype = None
            _LIB = lib
    return _LIB


def available() -> bool:
    """True when the native library builds/loads on this host."""
    try:
        _lib()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def raster_points(
    points: np.ndarray,  # (N, 3) float32 world-space
    colors: np.ndarray,  # (N, 3) uint8
    w2cs: np.ndarray,  # (F, 4, 4) float32
    intrinsics: np.ndarray,  # (F, 3, 3) float32 pixel units
    height: int,
    width: int,
    point_radius: float = 1.0,
    background: int = 0,
    znear: float = 1e-4,
) -> np.ndarray:
    """Rasterize a point cloud along a camera path on the host CPU.

    Returns (F, H, W, 3) uint8 frames. Points are z-buffered square
    splats of half-size `point_radius` pixels.
    """
    points = np.ascontiguousarray(points, np.float32)
    colors = np.ascontiguousarray(colors, np.uint8)
    w2cs = np.ascontiguousarray(w2cs, np.float32)
    ks = np.ascontiguousarray(intrinsics, np.float32)
    n = points.shape[0]
    f = w2cs.shape[0]
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (N,3), got {points.shape}")
    if colors.shape != (n, 3):
        raise ValueError(f"colors must be ({n},3), got {colors.shape}")
    if w2cs.shape != (f, 4, 4) or ks.shape != (f, 3, 3):
        raise ValueError("w2cs must be (F,4,4) and intrinsics (F,3,3)")
    out = np.empty((f, height, width, 3), np.uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    _lib().point_raster_path(
        points.ctypes.data_as(f32p),
        colors.ctypes.data_as(u8p),
        ctypes.c_int64(n),
        w2cs.ctypes.data_as(f32p),
        ks.ctypes.data_as(f32p),
        f, height, width,
        ctypes.c_float(point_radius),
        ctypes.c_uint8(background),
        ctypes.c_float(znear),
        out.ctypes.data_as(u8p),
    )
    return out
