"""Build the CUDA kernels of ``csrc/`` into one shared library, at first use.

The sources have a plain C interface (no PyTorch or Python headers), so
``nvcc`` alone compiles them in seconds and no ``ninja`` is needed; the
library is loaded with ``ctypes``. The output goes to ``_build/<hash>/``
next to this file, keyed by a hash of the sources and the flags, so an
edited source rebuilds and an unchanged one is reused. Any failure raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libgen3c_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "--ptxas-options=-v",
    "-shared", "-Xcompiler", "-fPIC",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda, in that order."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin)"
    )


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h", ".cpp"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile (or reuse) the library. Returns {"path", "seconds",
    "cached", "log"}; ``log`` holds nvcc's output, ptxas -v included."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(lib), "seconds": 0.0, "cached": True, "log": log}
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    log_path.write_text(log)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed with exit code {proc.returncode}:\n{log[-8000:]}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return {"path": str(lib), "seconds": seconds, "cached": False, "log": log}
