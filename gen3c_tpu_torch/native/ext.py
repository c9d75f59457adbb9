"""numpy-facing wrapper over the gen3c_native CPython extension.

The extension (gen3c_native.cpp: compiled bindings over the three C++
cores, camera_path.cpp, render_buffer.cpp and point_raster.cpp, which it
includes) is built on demand with g++ against this interpreter's headers
into ``_build/`` (``gen3c_tpu_torch.native.build``) and imported from
there. The classes here expose the same API as the ctypes layer
(native/camera_path.py, native/render_buffer.py, native/point_raster.py),
which remains the dependency-free fallback. The port's copy of
gen3c_tpu/native/ext.py.
"""

from __future__ import annotations

import importlib.util
import sysconfig
import threading
from typing import Optional, Tuple

import numpy as np

from gen3c_tpu_torch.native import build

_MOD = None
_LOCK = threading.Lock()
_DEPS = ("camera_path.cpp", "render_buffer.cpp", "point_raster.cpp")


def _build() -> str:
    include = sysconfig.get_paths()["include"]
    return build(["gen3c_native.cpp"],
                 "gen3c_native" + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"),
                 ["-std=c++17", "-shared", "-fPIC", f"-I{include}"], deps=_DEPS)


def _mod():
    global _MOD
    with _LOCK:
        if _MOD is None:
            spec = importlib.util.spec_from_file_location("gen3c_native", _build())
            _MOD = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(_MOD)
    return _MOD


def available() -> bool:
    try:
        _mod()
        return True
    except Exception:  # noqa: BLE001 - no toolchain or headers
        return False


class CameraPath:
    """Same API as native.camera_path.CameraPath, extension-backed."""

    def __init__(self):
        self._p = _mod().CameraPath()

    def __len__(self) -> int:
        return len(self._p)

    def clear(self) -> None:
        self._p.clear()

    def add_keyframe(
        self, r4: np.ndarray, t3: np.ndarray, fov: float = 50.0,
        timestamp: Optional[float] = None,
    ) -> None:
        self._p.add_keyframe_quat(
            np.ascontiguousarray(r4, np.float32),
            np.ascontiguousarray(t3, np.float32),
            float(fov),
            float(len(self._p) if timestamp is None else timestamp),
        )

    def add_keyframe_from_c2w(
        self, c2w: np.ndarray, fov: float = 50.0,
        timestamp: Optional[float] = None,
    ) -> None:
        c2w = np.ascontiguousarray(np.asarray(c2w)[:3, :4], np.float32)
        self._p.add_keyframe(
            c2w, float(fov),
            float(len(self._p) if timestamp is None else timestamp),
        )

    def eval(self, t: float) -> Tuple[np.ndarray, float]:
        c2w, fov = self._p.eval(float(t))
        return np.asarray(c2w, np.float32).reshape(3, 4), float(fov)

    def sample(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        c2w_b, fov_b = self._p.sample(int(n))
        c2w = np.frombuffer(c2w_b, np.float32).reshape(n, 3, 4)
        return c2w, np.frombuffer(fov_b, np.float32)

    def get_keyframe(self, i: int) -> Tuple[np.ndarray, float, float]:
        c2w, fov, ts = self._p.get_keyframe(int(i))
        return np.asarray(c2w, np.float32).reshape(3, 4), float(fov), float(ts)

    def keyframes(self):
        return [self.get_keyframe(i) for i in range(len(self))]

    def save(self, filename: str) -> None:
        self._p.save(filename)

    def load(self, filename: str) -> None:
        self._p.load(filename)

    @property
    def play_time(self) -> float:
        return self._p.play_time

    @play_time.setter
    def play_time(self, t: float) -> None:
        self._p.play_time = float(t)


class RenderBuffer:
    """Same API as native.render_buffer.RenderBuffer; the accumulation
    surface lives on the C++ side (no per-call pointer plumbing)."""

    def __init__(self, height: int, width: int, channels: int = 3):
        self._rb = _mod().RenderBuffer(height, width, channels)
        self.shape = (height, width, channels)

    @classmethod
    def for_shape(cls, shape) -> "RenderBuffer":
        h, w, c = shape
        return cls(h, w, c)

    @property
    def spp(self) -> int:
        return self._rb.spp

    def clear(self) -> None:
        self._rb.clear()

    def accumulate(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame, np.float32)
        if frame.shape != self.shape:
            raise ValueError(f"frame {frame.shape} != buffer {self.shape}")
        self._rb.accumulate(frame)

    def readout(self, exposure: float = 0.0,
                srgb_transfer: bool = True) -> np.ndarray:
        raw = self._rb.readout(
            exposure=float(exposure), srgb_transfer=bool(srgb_transfer)
        )
        return np.frombuffer(raw, np.uint8).reshape(self.shape).copy()


def raster_points(
    points: np.ndarray,
    colors: np.ndarray,
    w2cs: np.ndarray,
    intrinsics: np.ndarray,
    height: int,
    width: int,
    point_radius: float = 1.0,
    background: int = 0,
    znear: float = 1e-4,
) -> np.ndarray:
    """Same contract as native.point_raster.raster_points."""
    points = np.ascontiguousarray(points, np.float32)
    colors = np.ascontiguousarray(colors, np.uint8)
    w2cs = np.ascontiguousarray(w2cs, np.float32)
    ks = np.ascontiguousarray(intrinsics, np.float32)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (N,3), got {points.shape}")
    if colors.shape != (points.shape[0], 3):
        raise ValueError(f"colors must be (N,3), got {colors.shape}")
    f = w2cs.shape[0]
    if w2cs.shape != (f, 4, 4) or ks.shape != (f, 3, 3):
        raise ValueError("w2cs must be (F,4,4) and intrinsics (F,3,3)")
    raw = _mod().raster_points(
        points, colors, w2cs, ks, int(height), int(width),
        radius=float(point_radius), background=int(background),
        znear=float(znear),
    )
    return (
        np.frombuffer(raw, np.uint8)
        .reshape(f, height, width, 3)
        .copy()
    )
