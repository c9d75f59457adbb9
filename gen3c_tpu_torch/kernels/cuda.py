"""ctypes bindings of the compiled kernels (CUDA tensors only).

Each function checks device, dtype, shape and layout, allocates its output
with torch, launches on PyTorch's current stream and raises if the launch
is refused. Nothing here is imported by the CPU path.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from gen3c_tpu_torch.kernels import build as _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build.build()["path"])
            lib.gen3c_attention_bf16.argtypes = [
                _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
                _I, _I, _I, _I, _I, ctypes.c_float, _I, _P,
            ]
            lib.gen3c_attention_bf16.restype = _I
            lib.gen3c_attention_f32.argtypes = [
                _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
                _I, _I, _I, _I, _I, ctypes.c_float, _P,
            ]
            lib.gen3c_attention_f32.restype = _I
            lib.gen3c_splat.argtypes = [
                _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P,
            ]
            lib.gen3c_splat.restype = _I
            _lib = lib
        return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, Lq, H, D) x (B, Lk, H, D) -> (B, Lq, H, D): gen3c_attention_bf16
    for bf16 inputs, gen3c_attention_f32 for fp32 inputs."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("attention kernel: q, k, v must be on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"attention kernel takes bf16 or fp32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"attention kernel: bad shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, Lq, H, D = q.shape
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(f"attention kernel: q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if not 0 < D <= 128 or B > 65535 or H > 65535:
        raise ValueError(f"attention kernel takes head dim <= 128, B and H <= 65535 (got {q.shape})")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
    )
    scale = 1.0 / math.sqrt(D)
    lib = library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            B, Lq, k.shape[1], H, D, scale)
    if q.dtype == torch.bfloat16:
        vec = D % 8 == 0 and all(
            t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
            for t in (q, k, v)
        )
        _check(lib.gen3c_attention_bf16(*args, int(vec), _stream(q)), "attention_bf16")
    else:
        _check(lib.gen3c_attention_f32(*args, _stream(q)), "attention_f32")
    return out


def splat_accumulate(
    frame: torch.Tensor,
    mask: Optional[torch.Tensor],
    depth: torch.Tensor,
    flow: torch.Tensor,
    flow_mask: Optional[torch.Tensor],
    max_logd: torch.Tensor,
    depth_weight_scale: float = 50.0,
) -> torch.Tensor:
    """gen3c_splat: the (b, (h+2)*(w+2), c+1) fp32 accumulator."""
    b, c, h, w = frame.shape
    expect = {
        "frame": (frame, (b, c, h, w)), "mask": (mask, (b, 1, h, w)),
        "depth": (depth, (b, 1, h, w)), "flow": (flow, (b, 2, h, w)),
        "flow_mask": (flow_mask, (b, 1, h, w)), "max_logd": (max_logd, (b,)),
    }
    ready = {}
    for name, (t, shape) in expect.items():
        if t is None:
            ready[name] = None
            continue
        if t.device != frame.device or not t.is_cuda:
            raise ValueError(f"splat kernel: {name} must be on {frame.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"splat kernel takes fp32, {name} is {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"splat kernel: {name} has shape {tuple(t.shape)}, expected {shape}")
        ready[name] = t.contiguous()
    acc = torch.zeros((b, (h + 2) * (w + 2), c + 1), dtype=torch.float32, device=frame.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = library().gen3c_splat(
        ptr(ready["frame"]), ptr(ready["mask"]), ptr(ready["depth"]), ptr(ready["flow"]),
        ptr(ready["flow_mask"]), ptr(ready["max_logd"]), acc.data_ptr(),
        b, c, h, w, float(depth_weight_scale), _stream(frame),
    )
    _check(rc, "splat")
    return acc
