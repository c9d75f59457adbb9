"""Build the CUDA kernels of ``csrc/`` into a shared library, at first use.

The sources have a plain C interface (no PyTorch or Python headers), so
``nvcc`` alone compiles them in seconds and no ``ninja`` is needed; the
library is loaded with ``ctypes``. Each source compiles to an object in
its own ``nvcc`` process, all started together, and one more ``nvcc``
links them. The output goes to ``_build/<key>/`` next to this file, keyed
by a hash of the sources, the flags, the extra ``-D`` defines and the
sources built, so an edited source rebuilds and an unchanged one is
reused. Any failure raises.

``build()`` with no arguments is the kernel library, every source. With
``forward_only(defines)`` it builds ``attention_wgmma.cu``'s forward alone
with ``-D`` overrides of its shape into a library of its own: P2's sweep
points (``kernels.cuda.attention_point``).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

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


def build_dir(defines: Sequence[str] = (), sources: Optional[Sequence[Path]] = None) -> Path:
    """Where ``build`` puts the library of ``sources`` (default: every
    ``.cu``) built with ``defines``."""
    names = " ".join(p.name for p in _sources(sources))
    key = f"{source_hash()} {' '.join(defines)} {names}"
    return BUILD_ROOT / hashlib.sha256(key.encode()).hexdigest()[:16]


def _sources(sources: Optional[Sequence[Path]]) -> list:
    return sorted(CSRC.glob("*.cu")) if sources is None else [Path(p) for p in sources]


def build(defines: Sequence[str] = (), sources: Optional[Sequence[Path]] = None) -> dict:
    """Compile (or reuse) the library of ``sources`` (default: every
    ``.cu``, the kernel library) with the extra nvcc flags ``defines``.
    Returns {"path", "seconds", "cached", "log"}; ``log`` holds nvcc's
    output, ptxas -v included."""
    out_dir = build_dir(defines, sources)
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
    for src in _sources(sources):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-c", "-o", str(obj), str(src)]
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


FWD_SOURCE = CSRC / "attention_wgmma.cu"
FWD_ONLY = "-DGEN3C_ATTN_FWD_ONLY"


def forward_only(defines: Sequence[str]) -> dict:
    """``build``'s arguments for attention_wgmma.cu's forward alone
    (``FWD_ONLY``) with ``defines`` (``-DGEN3C_FWD_*=...``)."""
    return {"defines": (*defines, FWD_ONLY), "sources": (FWD_SOURCE,)}
