"""Build the CUDA kernels of ``csrc/`` into one shared library, at first use.

The sources have a plain C interface (no PyTorch or Python headers), so
``nvcc`` alone compiles them in seconds and no ``ninja`` is needed; the
library is loaded with ``ctypes``. Each source compiles to an object in
its own ``nvcc`` process, all started together, and one more ``nvcc``
links them. The output goes to ``_build/<hash>/`` next to this file, keyed
by a hash of the sources and the flags, so an edited source rebuilds and
an unchanged one is reused. Any failure raises.
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-lineinfo", "--ptxas-options=-v",
    "-Xcompiler", "-fPIC",
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
    tag = os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log += " ".join(cmd) + "\n" + out
        if proc.returncode != 0:
            failed.append(proc.returncode)
    objs = [obj for _, obj, _ in jobs]
    if not failed:
        tmp = out_dir / f".{LIB_NAME}.{tag}.tmp"
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(proc.returncode)
    for obj in objs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    if failed:
        raise KernelBuildError(f"nvcc failed with exit codes {failed}:\n{log[-8000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return {"path": str(lib), "seconds": seconds, "cached": False, "log": log}
