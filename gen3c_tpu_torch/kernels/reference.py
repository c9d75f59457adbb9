"""Plain PyTorch versions of the hand-written kernels.

The CPU path of ``gen3c_tpu_torch.kernels`` runs these, and the card
compares each kernel with them. They carry the math of the JAX package's
non-Pallas paths:

  * ``attention_reference``: the XLA path of gen3c_tpu/models/dit.py
    ``attention_op`` (:511-517), with the queries processed in chunks so
    that it also runs at the 7B self-attention length.
  * ``splat_reference``: gen3c_tpu/ops/geometry.py ``bilinear_splatting``
    (:205-316) with the scatter-add as ``index_add_`` (the ``.at[].add`` of
    :299-300).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

MAX_EXPONENT = 80.0  # geometry.py _MAX_EXPONENT
_LOGITS_PER_CHUNK = 1 << 28  # fp32 logits live at once in the reference


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v. q: (B, Lq, H, D), k/v: (B, Lk, H, D).

    The logits are formed in the input dtype, scaled and soft-maxed in
    fp32, and the probabilities cast back to v's dtype (dit.py:512-517).
    """
    B, Lq, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    chunk = max(1, _LOGITS_PER_CHUNK // (B * H * k.shape[1]))
    outs = []
    for s in range(0, Lq, chunk):
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, s:s + chunk], k).float() * scale
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, v))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def splat_max_logd(depth: torch.Tensor, group: Optional[int] = None) -> torch.Tensor:
    """Per-batch-entry log-depth maximum, (b,) fp32.

    geometry.py:256-261 takes ONE maximum over the whole depth tensor of a
    call. ``group`` consecutive batch entries share a maximum (default: all
    of them, the JAX semantics), so several independent splats can share
    one launch and keep their own maxima.
    """
    b = depth.shape[0]
    group = b if group is None else group
    if group <= 0 or b % group:
        raise ValueError(f"group={group} must divide the batch {b}")
    log_depth = torch.log1p(torch.clamp(depth.float(), min=0.0))
    mx = log_depth.reshape(b // group, -1).amax(dim=1)
    return mx.repeat_interleave(group)


def splat_accumulate_reference(
    frame: torch.Tensor,
    mask: Optional[torch.Tensor],
    depth: torch.Tensor,
    flow: torch.Tensor,
    flow_mask: Optional[torch.Tensor],
    max_logd: torch.Tensor,
    depth_weight_scale: float = 50.0,
) -> torch.Tensor:
    """The padded-grid accumulator, (b, (h+2)*(w+2), c+1): columns [:c]
    hold sum(value * w), column c holds sum(w). Plain version of the
    ``gen3c_splat`` kernel."""
    b, c, h, w = frame.shape
    dev = frame.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    ox = (flow[:, 0] + xs) + 1.0
    oy = (flow[:, 1] + ys) + 1.0

    def clamp(t, hi):
        return torch.nan_to_num(t, nan=0.0).clamp(0.0, float(hi))

    off_x, off_y = clamp(ox, w + 1), clamp(oy, h + 1)
    fl_x, fl_y = clamp(torch.floor(ox), w + 1), clamp(torch.floor(oy), h + 1)
    ce_x, ce_y = clamp(torch.ceil(ox), w + 1), clamp(torch.ceil(oy), h + 1)
    prox_nw = (1 - (off_y - fl_y)) * (1 - (off_x - fl_x))
    prox_sw = (1 - (ce_y - off_y)) * (1 - (off_x - fl_x))
    prox_ne = (1 - (off_y - fl_y)) * (1 - (ce_x - off_x))
    prox_se = (1 - (ce_y - off_y)) * (1 - (ce_x - off_x))

    log_depth = torch.log1p(torch.clamp(depth[:, 0], min=0.0))
    exponent = log_depth / (max_logd[:, None, None] + 1e-7) * depth_weight_scale
    depth_weights = torch.exp(torch.clamp(exponent, max=MAX_EXPONENT)) + 1e-7
    m = torch.ones_like(log_depth) if mask is None else mask[:, 0]
    if flow_mask is not None:
        m = m * flow_mask[:, 0]
    base = m / depth_weights

    w2 = w + 2
    fx, fy = fl_x.long(), fl_y.long()
    cx, cy = ce_x.long(), ce_y.long()
    idx = torch.cat([(fy * w2 + fx), (cy * w2 + fx), (fy * w2 + cx), (cy * w2 + cx)],
                    dim=1).reshape(b, 4 * h * w)
    wts = torch.cat([prox_nw * base, prox_sw * base, prox_ne * base, prox_se * base],
                    dim=1).reshape(b, 4 * h * w)
    vals = frame.reshape(b, c, h * w).repeat(1, 1, 4) * wts[:, None, :]
    rows = torch.cat([vals, wts[:, None, :]], dim=1).transpose(1, 2)  # (b, 4hw, c+1)
    acc = torch.zeros(b, (h + 2) * w2, c + 1, dtype=torch.float32, device=dev)
    for i in range(b):
        acc[i].index_add_(0, idx[i], rows[i])
    return acc


def splat_normalize(acc: torch.Tensor, c: int, h: int, w: int,
                    is_image: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulator -> (warped (b,c,h,w), mask2 (b,1,h,w)) (geometry.py:303-316)."""
    b = acc.shape[0]
    grid = acc.reshape(b, h + 2, w + 2, c + 1).permute(0, 3, 1, 2)[:, :, 1:-1, 1:-1]
    warped = grid[:, :c]
    weights = torch.nan_to_num(grid[:, c:], nan=1000.0)
    known = weights > 0
    zero_value = -1.0 if is_image else 0.0
    out = torch.where(known, warped / torch.where(known, weights, torch.ones_like(weights)),
                      torch.full_like(warped, zero_value))
    if is_image:
        out = torch.clamp(out, -1.0, 1.0)
    return out, known.to(torch.float32)


def splat_reference(
    frame1: torch.Tensor,
    mask1: Optional[torch.Tensor],
    depth1: torch.Tensor,
    flow12: torch.Tensor,
    flow12_mask: Optional[torch.Tensor] = None,
    is_image: bool = False,
    depth_weight_scale: float = 50.0,
    group: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """bilinear_splatting: (warped (b,c,h,w), mask2 (b,1,h,w)), all fp32."""
    b, c, h, w = frame1.shape
    max_logd = splat_max_logd(depth1, group)
    acc = splat_accumulate_reference(frame1, mask1, depth1, flow12, flow12_mask,
                                     max_logd, depth_weight_scale)
    return splat_normalize(acc, c, h, w, is_image)
