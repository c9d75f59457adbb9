"""ctypes bindings for the native camera-path spline engine.

The C++ library (camera_path.cpp) replaces the reference GUI's
camera-path module (gui/src/camera_path.cu): keyframe authoring, JSON
save/load, smooth Catmull-Rom/slerp playback, sampling of camera-to-world
matrices for inference requests. Built on demand with g++
(``gen3c_tpu_torch.native.load_library``). The port's copy of
gen3c_tpu/native/camera_path.py.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np

from gen3c_tpu_torch.native import load_library

_LIB = None
_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = load_library("camera_path.cpp")
            lib.camera_path_create.restype = ctypes.c_void_p
            for name, argtypes in {
                "camera_path_destroy": [ctypes.c_void_p],
                "camera_path_n_keyframes": [ctypes.c_void_p],
                "camera_path_clear": [ctypes.c_void_p],
                "camera_path_add_keyframe": [
                    ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_float,
                    ctypes.c_float,
                ],
                "camera_path_add_keyframe_m": [
                    ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_float,
                    ctypes.c_float,
                ],
                "camera_path_eval": [
                    ctypes.c_void_p,
                    ctypes.c_float,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                ],
                "camera_path_sample": [
                    ctypes.c_void_p,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                ],
                "camera_path_get_keyframe": [
                    ctypes.c_void_p,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                ],
                "camera_path_save": [ctypes.c_void_p, ctypes.c_char_p],
                "camera_path_load": [ctypes.c_void_p, ctypes.c_char_p],
                "camera_path_play_time": [ctypes.c_void_p],
                "camera_path_set_play_time": [ctypes.c_void_p, ctypes.c_float],
            }.items():
                getattr(lib, name).argtypes = argtypes
            lib.camera_path_n_keyframes.restype = ctypes.c_int
            lib.camera_path_get_keyframe.restype = ctypes.c_int
            lib.camera_path_save.restype = ctypes.c_int
            lib.camera_path_load.restype = ctypes.c_int
            lib.camera_path_play_time.restype = ctypes.c_float
            _LIB = lib
    return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class CameraPath:
    """Keyframed camera path (gui CameraPath parity at the API level)."""

    def __init__(self):
        self._lib = _lib()
        self._h = self._lib.camera_path_create()

    def __del__(self):
        try:
            self._lib.camera_path_destroy(self._h)
        except Exception:  # noqa: BLE001
            pass

    def __len__(self) -> int:
        return self._lib.camera_path_n_keyframes(self._h)

    def clear(self) -> None:
        self._lib.camera_path_clear(self._h)

    def add_keyframe(
        self,
        rotation_wxyz: np.ndarray,
        position: np.ndarray,
        fov: float = 50.0,
        timestamp: float = 0.0,
    ) -> None:
        r = np.ascontiguousarray(rotation_wxyz, np.float32)
        t = np.ascontiguousarray(position, np.float32)
        self._lib.camera_path_add_keyframe(
            self._h, _fptr(r), _fptr(t), fov, timestamp
        )

    def add_keyframe_from_c2w(
        self, c2w: np.ndarray, fov: float = 50.0, timestamp: float = 0.0
    ) -> None:
        m = np.ascontiguousarray(np.asarray(c2w, np.float32)[:3, :4])
        self._lib.camera_path_add_keyframe_m(self._h, _fptr(m), fov, timestamp)

    def eval(self, t: float) -> Tuple[np.ndarray, float]:
        """Returns (c2w (3,4), fov) at normalized path time t in [0,1]."""
        out = np.zeros(12, np.float32)
        fov = ctypes.c_float()
        self._lib.camera_path_eval(self._h, t, _fptr(out), ctypes.byref(fov))
        return out.reshape(3, 4), float(fov.value)

    def sample(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """n evenly-spaced cameras: (c2ws (n,3,4), fovs (n,))."""
        c2w = np.zeros((n, 12), np.float32)
        fov = np.zeros(n, np.float32)
        self._lib.camera_path_sample(self._h, n, _fptr(c2w), _fptr(fov))
        return c2w.reshape(n, 3, 4), fov

    def get_keyframe(self, i: int) -> Tuple[np.ndarray, float, float]:
        """Keyframe i as (c2w (3,4), fov, timestamp)."""
        out = np.zeros(12, np.float32)
        fov = ctypes.c_float()
        ts = ctypes.c_float()
        rc = self._lib.camera_path_get_keyframe(
            self._h, i, _fptr(out), ctypes.byref(fov), ctypes.byref(ts)
        )
        if rc != 0:
            raise IndexError(f"keyframe {i} out of range")
        return out.reshape(3, 4), float(fov.value), float(ts.value)

    def keyframes(self):
        """All keyframes as a list of (c2w (3,4), fov, timestamp)."""
        return [self.get_keyframe(i) for i in range(len(self))]

    def save(self, filename: str) -> None:
        rc = self._lib.camera_path_save(self._h, filename.encode())
        if rc != 0:
            raise IOError(f"camera_path_save failed ({rc})")

    def load(self, filename: str) -> None:
        rc = self._lib.camera_path_load(self._h, filename.encode())
        if rc != 0:
            raise IOError(f"camera_path_load failed ({rc})")

    @property
    def play_time(self) -> float:
        return self._lib.camera_path_play_time(self._h)

    @play_time.setter
    def play_time(self, t: float) -> None:
        self._lib.camera_path_set_play_time(self._h, t)
