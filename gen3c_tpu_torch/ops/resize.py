"""``jax.image.resize`` in plain PyTorch, for the MoGe port.

``F.interpolate`` is not ``jax.image.resize``: JAX scales its kernel on any
axis that shrinks (an antialiased downscale, bilinear and bicubic alike),
uses the Keys cubic (a = -0.5) with its weights renormalised at the edges,
and samples "nearest" at half-pixel centres (``nearest-exact``, not
``nearest``). Here each resized axis gets the (in, out) weight matrix that
``jax.image.scale_and_translate`` builds, in fp32 and in its order of
operations, and the axes are contracted one after the other; "nearest"
gathers the indices JAX computes. Axes whose size does not change are
left alone, as JAX leaves them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _kernel(method: str, x: torch.Tensor) -> torch.Tensor:
    if method == "linear":
        return torch.clamp(1 - x.abs(), min=0)
    # Keys cubic convolution, a = -0.5
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(in_size: int, out_size: int, method: str, antialias: bool = True,
                   device=None) -> torch.Tensor:
    """The (in_size, out_size) fp32 weights of one axis of
    ``jax.image.resize(..., method)`` ("linear" or "cubic"): sample
    positions at half-pixel centres, the kernel widened by in / out when
    the axis shrinks (antialias), each column normalised to sum 1, columns
    sampling outside the input zeroed."""
    inv_scale = 1.0 / (out_size / in_size)  # Python float, as JAX computes it
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    f32 = dict(dtype=torch.float32, device=device)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, **f32)[:, None]).abs() / kernel_scale
    weights = _kernel(method, x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def nearest_indices(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """floor((i + 0.5) * in / out) in fp32: JAX's nearest-neighbour source
    index of each output position."""
    pos = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * in_size / out_size
    return torch.floor(pos).long()


def resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` with antialias on: method
    "nearest", "bilinear" / "linear" or "bicubic" / "cubic"."""
    method = {"bilinear": "linear", "bicubic": "cubic"}.get(method, method)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match the input's {tuple(x.shape)}")
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        if method == "nearest":
            x = x.index_select(d, nearest_indices(m, n, x.device))
            continue
        w = resize_weights(m, n, method, device=x.device).to(x.dtype)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x
