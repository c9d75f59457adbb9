"""Driver for the headless native viewer (viewer_main.cpp).

The binary runs a stdin command REPL over an orbit camera, rasterizes the
seeded point cloud natively (point_raster.cpp, then render_buffer.cpp's
progressive anti-aliasing), edits keyframes (add, delete, move, fov,
retime), and saves and loads the reference GUI's camera-path JSON through
the spline engine (camera_path.cpp). "Display" is PPM frame output. It is
built on demand with g++ into ``_build/`` (``gen3c_tpu_torch.native.
build``). The port's copy of gen3c_tpu/native/viewer.py.

Programmatic use:

    viewer = NativeViewer()
    viewer.send("load cloud.bin")
    viewer.send("kf add")
    viewer.send("render /tmp/view.ppm 4")

Interactive use: ``python -m gen3c_tpu_torch.native.viewer [pc.bin]`` runs
the binary with the terminal attached.
"""

from __future__ import annotations

import subprocess
import threading
from typing import Optional

import numpy as np

from gen3c_tpu_torch.native import build

_SRCS = ("viewer_main.cpp", "point_raster.cpp", "render_buffer.cpp", "camera_path.cpp")
_LOCK = threading.Lock()


def build_viewer() -> str:
    """Build (or reuse) the viewer binary; returns its path."""
    with _LOCK:
        return build(_SRCS, "gen3c_viewer", ["-std=c++17"])


def available() -> bool:
    try:
        build_viewer()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def write_pointcloud(path: str, points: np.ndarray,
                     colors: np.ndarray) -> None:
    """Write the GEN3CPC1 seeding file the viewer loads:
    magic + int64 n + float32 (n,3) points + uint8 (n,3) colors."""
    points = np.ascontiguousarray(points, np.float32)
    colors = np.ascontiguousarray(colors, np.uint8)
    n = points.shape[0]
    if points.shape != (n, 3) or colors.shape != (n, 3):
        raise ValueError("points/colors must be (N,3)")
    with open(path, "wb") as f:
        f.write(b"GEN3CPC1")
        f.write(np.int64(n).tobytes())
        f.write(points.tobytes())
        f.write(colors.tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM written by the viewer -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P6"
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = (int(v) for v in line.split())
        assert f.readline().strip() == b"255"
        data = np.frombuffer(f.read(h * w * 3), np.uint8)
    return data.reshape(h, w, 3)


class NativeViewer:
    """Drives the viewer binary over its stdin/stdout REPL."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [build_viewer()],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            text=True,
            bufsize=1,
        )
        banner = self.proc.stdout.readline()
        assert "ready" in banner, banner

    def send(self, command: str) -> str:
        """Send one command; returns the response line (multi-line
        responses for `kf list` end at the 'ok' line)."""
        assert self.proc.poll() is None, "viewer exited"
        self.proc.stdin.write(command + "\n")
        self.proc.stdin.flush()
        lines = []
        while True:
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError("viewer closed stdout")
            lines.append(line.rstrip("\n"))
            if line.startswith(("ok", "err", "info")):
                break
        return "\n".join(lines)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("quit\n")
                self.proc.stdin.flush()
            except (BrokenPipeError, ValueError):
                pass
            self.proc.wait(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def main(argv: Optional[list] = None) -> None:
    import sys

    args = sys.argv[1:] if argv is None else argv
    binary = build_viewer()
    # interactive: terminal attached; optional argv[0] = pointcloud file
    proc = subprocess.Popen([binary, *args[:1]], stdin=None, stdout=None)
    proc.wait()


if __name__ == "__main__":
    main()
