"""ctypes bindings for the native render buffer (accumulate + tonemap).

Parity role: gui/src/render_buffer.cu — the reference viewer's
CudaRenderBuffer accumulates samples-per-pixel into a float surface and
tonemaps (exposure + sRGB) to the display buffer. The serving preview
path uses this to progressively refine multi-frame point-cloud previews
without re-rasterizing from scratch.

Built on demand with g++ (``gen3c_tpu_torch.native.load_library``). The
port's copy of gen3c_tpu/native/render_buffer.py.
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
            lib = load_library("render_buffer.cpp", std="c++17")
            f32p = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.rb_accumulate.argtypes = [f32p, f32p, ctypes.c_int64]
            lib.rb_accumulate.restype = None
            lib.rb_readout.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, u8p,
            ]
            lib.rb_readout.restype = None
            _LIB = lib
    return _LIB


def available() -> bool:
    try:
        _lib()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


class RenderBuffer:
    """Progressive accumulation surface with tonemapped uint8 readout.

    >>> rb = RenderBuffer(h, w)
    >>> rb.accumulate(frame_linear_rgb)   # float32 (H, W, 3) in [0, 1]
    >>> img = rb.readout(exposure=0.0)    # uint8 (H, W, 3), sRGB
    """

    def __init__(self, height: int, width: int, channels: int = 3):
        self.shape = (height, width, channels)
        self._accum = np.zeros(self.shape, np.float32)
        self.spp = 0

    @classmethod
    def for_shape(cls, shape) -> "RenderBuffer":
        rb = cls.__new__(cls)
        rb.shape = tuple(shape)
        rb._accum = np.zeros(rb.shape, np.float32)
        rb.spp = 0
        return rb

    def clear(self) -> None:
        self._accum[:] = 0.0
        self.spp = 0

    def accumulate(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame, np.float32)
        if frame.shape != self.shape:
            raise ValueError(f"frame {frame.shape} != buffer {self.shape}")
        lib = _lib()
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.rb_accumulate(
            self._accum.ctypes.data_as(f32p),
            frame.ctypes.data_as(f32p),
            ctypes.c_int64(self._accum.size),
        )
        self.spp += 1

    def readout(self, exposure: float = 0.0,
                srgb_transfer: bool = True) -> np.ndarray:
        out = np.empty(self.shape, np.uint8)
        lib = _lib()
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.rb_readout(
            self._accum.ctypes.data_as(f32p),
            ctypes.c_int64(self._accum.size),
            ctypes.c_float(float(self.spp)),
            ctypes.c_float(exposure),
            ctypes.c_int(1 if srgb_transfer else 0),
            out.ctypes.data_as(u8p),
        )
        return out
