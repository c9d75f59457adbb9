"""Optical-flow consistency loss for tokenizer training, in PyTorch.

Port of gen3c_tpu/training/flow.py (the reference: cosmos_predict1/
tokenizer/training/losses/continuous.py FlowLoss, :218-385): the
reconstruction's motion field must match the input's. Bidirectional flow is
computed on a ``scale``-downsampled copy of both videos, forward (t, t+1)
pairs then backward ones, resized back to full resolution and rescaled, and
the loss is the mean L1 between the two fields.

The estimator is a ``flow_fn(frames1 (N, C, H, W), frames2) -> (N, 2, H,
W)``: RAFT-Large (``aux/raft.make_raft_flow_fn``, the reference's), or by
default a differentiable coarse-to-fine Lucas-Kanade. Every resize is
``jax.image.resize``'s (``ops/resize.py``: antialiased when it shrinks,
renormalised at the edges), not ``F.interpolate``. The input video's flow
carries no gradient and is computed under ``torch.no_grad``: the same value
in less memory.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from gen3c_tpu_torch.ops.resize import resize

FlowFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _gray(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H, W) luminance."""
    if x.shape[1] == 1:
        return x[:, 0]
    w = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype, device=x.device)[: x.shape[1]]
    return torch.einsum("nchw,c->nhw", x, w / w.sum())


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N, H/2, W/2), odd edges dropped."""
    N, H, W = x.shape
    return x[:, : H // 2 * 2, : W // 2 * 2].reshape(N, H // 2, 2, W // 2, 2).mean(dim=(2, 4))


def _gradient(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.gradient`` along dim: central differences inside, one-sided at
    the two ends."""
    n = x.shape[dim]
    inner = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) / 2
    first = x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1)
    last = x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)
    return torch.cat([first, inner, last], dim=dim)


def _bilinear_sample(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """img (N, H, W) sampled at (yy, xx) (N, H, W), edge-clamped."""
    N, H, W = img.shape
    y0 = torch.clamp(torch.floor(yy), 0, H - 2)
    x0 = torch.clamp(torch.floor(xx), 0, W - 2)
    wy = torch.clamp(yy - y0, 0.0, 1.0)
    wx = torch.clamp(xx - x0, 0.0, 1.0)
    flat = img.reshape(N, H * W)
    base = y0.long() * W + x0.long()

    def at(off):
        return torch.gather(flat, 1, (base + off).reshape(N, -1)).reshape(N, H, W)

    return (at(0) * (1 - wy) * (1 - wx) + at(1) * (1 - wy) * wx
            + at(W) * wy * (1 - wx) + at(W + 1) * wy * wx)


def _lk_refine(a: torch.Tensor, b: torch.Tensor, flow: torch.Tensor, window: int,
               iters: int) -> torch.Tensor:
    """One pyramid level of iterated Lucas-Kanade on (N, H, W) pairs; flow
    (N, 2, H, W)."""
    N, H, W = a.shape
    yy, xx = torch.meshgrid(torch.arange(H, dtype=a.dtype, device=a.device),
                            torch.arange(W, dtype=a.dtype, device=a.device), indexing="ij")
    gy, gx = _gradient(b, 1), _gradient(b, 2)  # the target's spatial gradients
    k = window
    ones = torch.full((1, 1, k, k), 1.0 / (k * k), dtype=a.dtype, device=a.device)

    def box(z):
        return F.conv2d(z[:, None], ones, padding=k // 2)[:, 0]

    for _ in range(iters):
        u, v = flow[:, 0], flow[:, 1]
        bw = _bilinear_sample(b, yy + v, xx + u)
        gxw = _bilinear_sample(gx, yy + v, xx + u)
        gyw = _bilinear_sample(gy, yy + v, xx + u)
        it = bw - a  # the temporal difference at the current estimate
        # windowed normal equations
        # [sum gx^2, sum gx gy; sum gx gy, sum gy^2] d = -[sum gx it; sum gy it]
        sxx = box(gxw * gxw) + 1e-3
        syy = box(gyw * gyw) + 1e-3
        sxy = box(gxw * gyw)
        bx = -box(gxw * it)
        by = -box(gyw * it)
        det = torch.clamp(sxx * syy - sxy * sxy, min=1e-6)
        du = torch.clamp((syy * bx - sxy * by) / det, -2.0, 2.0)
        dv = torch.clamp((sxx * by - sxy * bx) / det, -2.0, 2.0)
        flow = torch.stack([u + du, v + dv], dim=1)
    return flow


def lucas_kanade_flow(frames1: torch.Tensor, frames2: torch.Tensor, levels: int = 3,
                      window: int = 7, iters: int = 3) -> torch.Tensor:
    """Coarse-to-fine Lucas-Kanade: flow (N, 2, H, W) mapping frames1 (N, C,
    H, W) to frames2 (u the x, v the y displacement, in pixels)."""
    a = _gray(frames1.float())
    b = _gray(frames2.float())
    H, W = a.shape[-2:]
    levels = max(1, min(levels, int(math.log2(min(H, W) // 8)) + 1 if min(H, W) >= 16 else 1))
    pyr_a, pyr_b = [a], [b]
    for _ in range(levels - 1):
        pyr_a.append(_avg_pool2(pyr_a[-1]))
        pyr_b.append(_avg_pool2(pyr_b[-1]))
    N = a.shape[0]
    flow = torch.zeros((N, 2) + tuple(pyr_a[-1].shape[-2:]), dtype=torch.float32,
                       device=a.device)
    for lvl in range(levels - 1, -1, -1):
        if lvl < levels - 1:  # upsample x2, displacements with it
            flow = 2.0 * resize(flow, (N, 2) + tuple(pyr_a[lvl].shape[-2:]), "bilinear")
        flow = _lk_refine(pyr_a[lvl], pyr_b[lvl], flow, window, iters)
    return flow


def bidirectional_flow(video: torch.Tensor, flow_fn: FlowFn, scale: int = 2) -> torch.Tensor:
    """FlowLoss._bidirectional_flow (:327-362) on video (B, T, C, H, W): flow
    of the scale-downsampled video, forward (T - 1 pairs) then backward,
    concatenated on time, resized back and displacement-scaled: (B, 2,
    2 (T - 1), H, W). The pairs of every batch row go to flow_fn at once."""
    B, T, C, H, W = video.shape
    small = resize(video, (B, T, C, H // scale, W // scale), "bilinear")

    def fwd(frames):  # (B, T, C, h, w) -> (B, T - 1, 2, h, w)
        pairs = flow_fn(frames[:, :-1].reshape(B * (T - 1), *frames.shape[2:]),
                        frames[:, 1:].reshape(B * (T - 1), *frames.shape[2:]))
        return pairs.reshape(B, T - 1, *pairs.shape[1:])

    fwd_flow = fwd(small)
    bwd_flow = torch.flip(fwd(torch.flip(small, [1])), [1])
    flow = torch.cat([fwd_flow, bwd_flow], dim=1).transpose(1, 2)  # (B, 2, 2(T-1), h, w)
    return scale * resize(flow, tuple(flow.shape[:3]) + (H, W), "linear")


def flow_loss(video: torch.Tensor, recon: torch.Tensor, flow_fn: Optional[FlowFn] = None,
              scale: int = 2) -> torch.Tensor:
    """FlowLoss.forward (:364-383): the mean L1 between the bidirectional
    flow of the input (B, 3, T, H, W) and of its reconstruction."""
    if video.shape[2] <= 1:
        return torch.zeros((), dtype=torch.float32, device=video.device)
    flow_fn = flow_fn or lucas_kanade_flow
    with torch.no_grad():
        fi = bidirectional_flow(video.transpose(1, 2), flow_fn, scale)
    fr = bidirectional_flow(recon.transpose(1, 2), flow_fn, scale)
    return torch.mean(torch.abs(fi - fr))
