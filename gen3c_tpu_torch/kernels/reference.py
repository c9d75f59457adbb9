"""Plain PyTorch versions of the hand-written kernels.

The CPU path of ``gen3c_tpu_torch.kernels`` runs these, and the card
compares each kernel with them. They carry the math of the JAX package's
non-Pallas paths:

  * ``attention_reference``: the XLA path of gen3c_tpu/models/dit.py
    ``attention_op`` (:511-517), with the queries processed in chunks so
    that it also runs at the 7B self-attention length; with ``band`` the
    dense temporal-band mask of :412-416 and :513-515.
    ``attention_forward_reference`` adds the row logsumexp and
    ``attention_backward_reference`` is the backward (K4's plain version),
    chunked the same way.
  * ``ring_fold_reference`` and ``ring_merge_reference``: one step of
    gen3c_tpu/models/dit.py ``_ring_attention`` (:597-645), split at the
    two kernels (K1ring, K1merge): the fold of one KV shard in fp32 over
    512-row query blocks with the band at global positions (:603-619), and
    the online-softmax merge of its result into the running state.
  * ``quantize_rows_reference``, ``int8_matmul_reference`` and
    ``w8a8_matmul_reference``: gen3c_tpu/models/quantize.py
    ``w8a8_matmul`` (:48-69), split at the two kernels (K7q, K7).
  * ``splat_reference``: gen3c_tpu/ops/geometry.py ``bilinear_splatting``
    (:205-316) with the scatter-add as ``index_add_`` (the ``.at[].add`` of
    :299-300).
  * ``mma_probe_reference``: the loop of scripts/probe_int8_attention.py's
    Pallas kernel (:37-62), P1's plain version; ``mma_probe_stacked`` the
    same sum as the operands of one product (P1's library yardstick).
  * ``ray_triangle_depth_reference``: gen3c_tpu/ops/raycast.py
    ``ray_triangle_depth`` (:97-140), K6's plain version, chunked over rays.
  * ``gqa_attention_reference``: gen3c_tpu/models/ar_transformer.py
    ``_gqa_attention`` (:252-297), K8's plain version, line for line.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

MAX_EXPONENT = 80.0  # geometry.py _MAX_EXPONENT
_LOGITS_PER_CHUNK = 1 << 28  # fp32 logits live at once in the reference
# int8 x int8 products summed over this many terms stay below 2^24, so an
# fp32 matmul of the codes is exact (1024 * 128^2 = 2^24)
_EXACT_K_CHUNK = 1024
_ACC_PER_CHUNK = 1 << 28  # int32 accumulators formed at once in the reference
_RAY_PAIRS_PER_CHUNK = 1 << 24  # (ray, triangle) pairs formed at once in the reference
RAY_EPS = 1e-8  # raycast.py _EPS

INV_127 = float(np.float32(1.0) / np.float32(127.0))  # 1/127 rounded to fp32
Band = Tuple[int, int, int]  # (tokens per frame, window in frames, prefix frames)


def _logits(q: torch.Tensor, k: torch.Tensor, s: int, e: int,
            band: Optional[Band]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """fp32 scaled logits of queries [s, e), (B, H, e - s, Lk): formed in the
    input dtype, scaled in fp32, band-masked to -1e30 (dit.py:512-515); and
    the band's (e - s, Lk) mask of visible keys (None without a band)."""
    Lk = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q[:, s:e], k).float() * (1.0 / math.sqrt(q.shape[-1]))
    allowed = None
    if band is not None:
        hw, window, prefix = band
        qf = torch.arange(s, e, device=q.device) // hw
        kf = torch.arange(Lk, device=q.device) // hw
        allowed = ((qf[:, None] - kf[None, :]).abs() <= window) | (kf[None, :] < prefix)
        logits.masked_fill_(~allowed, -1e30)
    return logits, allowed


def _query_chunk(q: torch.Tensor, k: torch.Tensor) -> int:
    B, _, H, _ = q.shape
    return max(1, _LOGITS_PER_CHUNK // (B * H * k.shape[1]))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        band: Optional[Band] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v. q: (B, Lq, H, D), k/v: (B, Lk, H, D).

    The logits are formed in the input dtype, scaled and soft-maxed in
    fp32, and the probabilities cast back to v's dtype (dit.py:512-517).
    band=(hw, window, prefix): query token i may see key token j only if
    |i // hw - j // hw| <= window or j // hw < prefix; other logits are
    set to -1e30 before the softmax, as dit.py does.
    """
    return _forward(q, k, v, band, with_lse=False)[0]


def attention_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                band: Optional[Band] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``attention_reference``'s output and the fp32 row logsumexp of its
    scaled logits, (B, H, Lq): the plain version of K4's forward."""
    return _forward(q, k, v, band, with_lse=True)


def _forward(q, k, v, band, with_lse):
    Lq = q.shape[1]
    chunk = _query_chunk(q, k)
    outs, lses = [], []
    for s in range(0, Lq, chunk):
        logits, _ = _logits(q, k, s, min(s + chunk, Lq), band)
        if with_lse:
            lses.append(torch.logsumexp(logits, dim=-1))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, v))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out, (torch.cat(lses, dim=2) if with_lse else None)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                                 band: Optional[Band] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_reference`` given its output, the upstream
    gradient dout (like out) and the forward's lse: the plain version of K4.

    Chunked over queries like the forward, so it runs at the 7B
    self-attention length (autograd through ``attention_reference`` would
    keep every chunk's probabilities: ~406 GB for one 56,320-token layer).
    Per chunk: P = exp(S - lse), Delta = rowsum(dO * O) in fp32,
    dV += P^T dO, dS = P * (dO V^T - Delta), dQ = scale dS K and
    dK += scale dS^T Q. The products take their operands in the input
    dtype (P and dS rounded to it, as the kernel rounds them) and sum in
    fp32; dk and dv accumulate over chunks in fp32 and are cast once. The
    band masks as the forward does (K4-band's plain version).
    """
    Lq = q.shape[1]
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)  # (B, H, Lq)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dqs = []
    chunk = _query_chunk(q, k)
    for s in range(0, Lq, chunk):
        e = min(s + chunk, Lq)
        logits, allowed = _logits(q, k, s, e, band)
        p = torch.exp(logits - lse[:, :, s:e, None])
        if allowed is not None:
            # a row that sees no key: the forward's softmax over -1e30 logits
            # averaged v (exp(S - lse) cannot say so: lse lost its log(Lk))
            p[:, :, ~allowed.any(dim=1)] = 1.0 / k.shape[1]
        dv += torch.einsum("bhqk,bqhd->bkhd", p.to(dt), dout[:, s:e]).float()
        dp = torch.einsum("bqhd,bkhd->bhqk", dout[:, s:e], v).float()
        ds = p * (dp - delta[:, :, s:e, None])
        del p, dp
        if allowed is not None:
            ds.masked_fill_(~allowed, 0.0)  # the mask's logits are constants
        ds = ds.to(dt)
        dqs.append((torch.einsum("bhqk,bkhd->bqhd", ds, k).float() * scale).to(dt))
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, q[:, s:e]).float()
    return torch.cat(dqs, dim=1), (dk * scale).to(dt), dv.to(dt)


RING_Q_BLOCK = 512  # dit.py _ring_attention's q_block


def ring_fold_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        band: Optional[Band] = None, q_off: int = 0, k_off: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ring-attention step, K1ring's plain version: the attention of
    the queries q (B, Lq, H, D), at global positions q_off + i, over one KV
    shard k/v (B, Lk, H, D), at k_off + j; returns (out like q, the fp32 row
    logsumexp (B, H, Lq)).

    As dit.py folds a shard (:598-625): q, k and v in fp32, the logits
    scaled in fp32, 512-row query blocks, the band evaluated on global
    frames. A row that sees no key of the shard gets out 0 and lse -inf
    (dit.py gates its probabilities to 0, :617-619).
    """
    Lq, Lk = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for s in range(0, Lq, RING_Q_BLOCK):
        e = min(s + RING_Q_BLOCK, Lq)
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, s:e].float(), kf) * scale
        if band is not None:
            hw, window, prefix = band
            qf = (q_off + torch.arange(s, e, device=q.device)) // hw
            kfr = (k_off + torch.arange(Lk, device=q.device)) // hw
            allowed = ((qf[:, None] - kfr[None, :]).abs() <= window) | (kfr[None, :] < prefix)
            logits.masked_fill_(~allowed, -math.inf)
        m = logits.amax(dim=-1, keepdim=True)  # -inf for a row without a key
        p = torch.exp(logits - torch.where(m == -math.inf, torch.zeros_like(m), m))
        den = p.sum(dim=-1)  # (B, H, rows), 0 for a row without a key
        num = torch.einsum("bhqk,bkhd->bqhd", p, vf)
        inv = torch.where(den > 0, 1.0 / den, torch.zeros_like(den))
        outs.append((num * inv.transpose(1, 2)[..., None]).to(q.dtype))
        lses.append(m[..., 0] + torch.log(den))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def ring_merge_reference(acc: torch.Tensor, acc_lse: torch.Tensor,
                         out: Optional[torch.Tensor] = None, lse: Optional[torch.Tensor] = None,
                         final_dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
    """K1merge's plain version: fold one ring step's (out, lse) into the
    running state acc (B, L, H, D) fp32 and acc_lse (B, H, L) fp32 (it
    starts at 0 and -inf), in place; with final_dtype, return the merged
    result in that dtype instead and leave the state. Weights exp(lse - m)
    for m the larger lse; a row whose two lses are -inf stays 0 and -inf.
    out = lse = None folds nothing."""
    step_lse = torch.full_like(acc_lse, -math.inf) if lse is None else lse
    m = torch.maximum(acc_lse, step_lse)
    m_use = torch.where(m == -math.inf, torch.zeros_like(m), m)
    wa, ws = torch.exp(acc_lse - m_use), torch.exp(step_lse - m_use)
    total = wa + ws
    inv = torch.where(total > 0, 1.0 / total, torch.zeros_like(total))

    def per_row(w):  # (B, H, L) -> (B, L, H, 1)
        return (w * inv).transpose(1, 2)[..., None]

    merged = acc * per_row(wa)
    if out is not None:
        merged = merged + out.float() * per_row(ws)
    if final_dtype is not None:
        return merged.to(final_dtype)
    acc.copy_(merged)
    acc_lse.copy_(torch.where(total > 0, m_use + torch.log(total),
                              torch.full_like(total, -math.inf)))
    return None


def row_absmax_reference(x: torch.Tensor) -> torch.Tensor:
    """max |x| of each row of x (M, K), fp32 (M,): K7q's first pass where
    the row is split over ranks (``quantize_rows_reference(x, absmax)``)."""
    return x.float().abs().amax(dim=-1)


def quantize_rows_reference(x: torch.Tensor, absmax: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8: x (M, K) -> (codes (M, K) int8, scales (M,) fp32).

    scale = max(absmax * INV_127, 1e-12); code = clip(round_half_even(x /
    scale), -127, 127), all in fp32 (quantize.py:55-59, and :33-36 for a
    weight stored (out, in)). quantize.py writes ``absmax / 127.0``; XLA
    compiles that division by a constant into a multiply by the fp32
    reciprocal, and the port reproduces the compiled numbers. The codes
    are a true division. An all-zero row gets codes 0.

    absmax (M,) fp32, when given, is the row's absmax taken elsewhere: x is
    then a slice of longer rows (a row-parallel input, its columns split
    over tp ranks) and the max over every slice sets the scale, as it does
    for the whole row. Max is exact, so each slice's codes are those of
    the whole row's.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True) if absmax is None else absmax.float()[:, None]
    scale = (amax * INV_127).clamp_min(1e-12)
    codes = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return codes, scale.squeeze(-1)


def int8_matmul_reference(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 accumulators of int8 xq (M, K) x int8 wq (N, K)^T -> (M, N).

    torch has no integer matmul on CUDA, so the codes are multiplied as
    fp32 in K-chunks of 1024, each of which is exact, and summed in int32.
    """
    M, K = xq.shape
    N = wq.shape[0]
    acc = torch.zeros((M, N), dtype=torch.int32, device=xq.device)
    rows = max(1, _ACC_PER_CHUNK // max(N, 1))
    for m0 in range(0, M, rows):
        for k0 in range(0, K, _EXACT_K_CHUNK):
            part = xq[m0:m0 + rows, k0:k0 + _EXACT_K_CHUNK].float() @ \
                wq[:, k0:k0 + _EXACT_K_CHUNK].float().T
            acc[m0:m0 + rows] += part.to(torch.int32)
    return acc


def w8a8_matmul_reference(x: torch.Tensor, qweight: torch.Tensor, wscale: torch.Tensor,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """x (..., K) @ int8 qweight (N, K)^T with per-token int8 activations:
    quantize x's rows, accumulate exactly in int32, then
    ``(acc * xscale) * wscale`` in fp32 and cast (quantize.py:55-69)."""
    K = x.shape[-1]
    xq, xscale = quantize_rows_reference(x.reshape(-1, K))
    acc = int8_matmul_reference(xq, qweight)
    out = acc.float().mul_(xscale[:, None]).mul_(wscale.float()[None, :])
    return out.to(out_dtype).reshape(*x.shape[:-1], qweight.shape[0])


def mma_probe_reference(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """sum over i < reps of (a + i % 2) @ b, a (M, K), b (K, N): the loop of
    scripts/probe_int8_attention.py's Pallas kernel (P1's plain version).
    bf16: a + 1 rounded to bf16, each product exact in fp32 and summed in
    fp32 (in another order than the kernel's). int8: a + 1 wraps in int8,
    the products are exact (``int8_matmul_reference``) and summed in int32,
    wrapping as the kernel's int32 MMA sums do."""
    if a.dtype == torch.int8:
        bT = b.t().contiguous()
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32, device=a.device)
        for i in range(reps):
            acc += int8_matmul_reference((a.to(torch.int16) + i % 2).to(torch.int8), bT)
        return acc
    bf = b.float()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for i in range(reps):
        acc += (a.float() + i % 2).to(a.dtype).float() @ bf
    return acc


def mma_probe_stacked(a: torch.Tensor, b: torch.Tensor,
                      reps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """P1's sum as one product: (a', b'^T) with a' = [a | a + 1 | a | ...]
    (M, reps K) and b'^T = [b^T | b^T | ...] (N, reps K), a + 1 rounded or
    wrapped as in ``mma_probe_reference``, so that a' @ b' is the sum over
    i < reps of (a + i % 2) @ b. The operands of P1's library yardstick (one
    ``torch.mm`` or ``torch._int_mm``); the port never computes P1 so."""
    (M, K), N = a.shape, b.shape[1]
    if a.dtype == torch.int8:
        a1 = (a.to(torch.int16) + 1).to(torch.int8)
    else:
        a1 = (a.float() + 1).to(a.dtype)
    stacked = torch.empty((M, reps, K), dtype=a.dtype, device=a.device)
    stacked[:, 0::2] = a[:, None]
    stacked[:, 1::2] = a1[:, None]
    bT = b.t()[:, None, :].expand(N, reps, K).reshape(N, reps * K)
    return stacked.reshape(M, reps * K), bT


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


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross's formula, each product and difference a separate op."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0 b0 + a1 b1) + a2 b2 over the last axis, in that order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def ray_triangle_setup(v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """The ray-independent terms of Moller-Trumbore per triangle, (T, 13)
    fp32: e1 = v1 - v0, e2 = v2 - v0, s = -v0 (the origin minus v0),
    q = cross(s, e1) and dot(e2, q). K6 reads these rows."""
    e1, e2, s = v1 - v0, v2 - v0, -v0
    q = _cross(s, e1)
    return torch.cat([e1, e2, s, q, _dot(e2, q)[:, None]], dim=1).contiguous()


def _ray_triangle_hits(dirs: torch.Tensor, tri: torch.Tensor, keep=None) -> torch.Tensor:
    """The nearest hit per ray of ``dirs`` (R, 3) over the rows ``tri`` (T,
    13) of ``ray_triangle_setup``, 0.0 where none; ``keep(r0, r1)`` gives
    the (r1 - r0, T) bool pairs to test for rays r0:r1 (None: every pair)."""
    R, T = dirs.shape[0], tri.shape[0]
    out = torch.zeros(R, dtype=torch.float32, device=dirs.device)
    e1, e2, s, q, eq = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9], tri[:, 9:12], tri[:, 12]
    rows = max(1, _RAY_PAIRS_PER_CHUNK // max(T, 1))
    for r0 in range(0, R, rows):
        d = dirs[r0:r0 + rows, None, :]  # (c, 1, 3)
        h = _cross(d, e2[None])  # (c, T, 3)
        a = _dot(e1[None], h)
        f = 1.0 / torch.where(a.abs() < RAY_EPS, torch.ones_like(a), a)
        u = f * _dot(s[None], h)
        v = f * _dot(d, q[None])
        t = f * eq[None]
        hit = ((a.abs() >= RAY_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > RAY_EPS))
        if keep is not None:
            hit &= keep(r0, r0 + d.shape[0])
        best = torch.where(hit, t, torch.full_like(t, 1e10)).amin(dim=1)
        out[r0:r0 + rows] = torch.where(best < 1e10, best, torch.zeros_like(best))
    return out


def ray_triangle_depth_reference(ray_dirs: torch.Tensor, v0: torch.Tensor, v1: torch.Tensor,
                                 v2: torch.Tensor, tri_valid: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Smallest hit distance per ray, (R,) fp32, 0.0 where no triangle hits.

    ray_dirs (R, 3) with origins at 0; triangles v0/v1/v2 (T, 3); tri_valid
    (T,) bool marks the triangles to test (the JAX version's padding mask).
    Moller-Trumbore with eps 1e-8 as gen3c_tpu's ``ray_triangle_depth``:
    h = cross(d, e2), a = dot(e1, h), f = 1 / a, u = f dot(s, h),
    v = f dot(d, q), t = f dot(e2, q); a hit is |a| >= 1e-8, 0 <= u <= 1,
    v >= 0, u + v <= 1, t > 1e-8. Rays go in chunks of 2^24 pairs.
    """
    R, T = ray_dirs.shape[0], v0.shape[0]
    if T == 0 or R == 0:
        return torch.zeros(R, dtype=torch.float32, device=ray_dirs.device)
    tri = ray_triangle_setup(v0.float(), v1.float(), v2.float())
    keep = None if tri_valid is None else (lambda r0, r1: tri_valid[None])
    return _ray_triangle_hits(ray_dirs.float(), tri, keep)


# K6's culling rule. A ray d passes the fp32 hit test of a triangle's row
# only if d lies within the angle asin(eta) of the triangle's cone (the rays
# from the origin through the triangle that the row describes exactly:
# P0 = -s, P1 = P0 + e1, P2 = P0 + e2). Writing d = l0 P0 + l1 P1 + l2 P2
# (|d| = 1), the test's numerators are u a = -l1 det, v a = -l2 det and
# a - u a - v a = -l0 det (det = P0 . (P1 x P2)); each is computed with an
# error below E |d| (E_u = k |s||e2|, E_v = k |s||e1|, E_a = k |e1||e2|,
# the third E_a + E_u + E_v + 4u |e1||e2| for the rounding of u + v <= 1,
# k = 16u, 2.7 times the 5.9u that the cross, the dot and the rounded
# reciprocal sum to), and t > 1e-8 fixes the sign of a once |det| exceeds
# twice the error of dot(e2, q). So a passing ray has every
# l_j >= -E_j / |det|, and lies within eta = sum_j E_j |P_j| / |det| of the
# cone. Seen through the image plane z = 1 a turn by beta moves a ray by at
# most beta sec^2(polar angle), so the rectangle of the vertices' (x/z,
# y/z) widened by beta sec^2(theta_max + beta) <= eta / (cos(beta)
# cos^2(theta_max + beta)) (beta = asin(eta), cos(theta_max) the least
# z / |P_j|), then by RAY_BOX_REL of each coordinate and RAY_BOX_ABS (the
# fp32 roundings of the tile's d_x/d_z and of the rectangle), holds every
# ray that can pass. A triangle with a vertex at z <= 0, a non-finite term,
# eta > RAY_CULL_MAX_ETA or cos(theta_max + beta) < RAY_CULL_MIN_COS is
# uncullable: its rectangle is the whole plane. A tile whose rays include
# one with d_z <= 0 (or a non-finite d_x/d_z) tests every triangle. The
# rule is written in fp64 +, -, *, / and sqrt, each a separate correctly
# rounded operation, so that K6's setup kernel forms the same bits.
RAY_TILE = 256  # rays a K6 CTA culls as one tile: a 256-ray strip
RAY_CHUNK = 32  # triangles under one chunk bound (the kernel's first level)
_ROUND = 2.0 ** -24  # fp32 unit roundoff
RAY_TEST_ERR = 16.0 * _ROUND  # k above
RAY_CULL_MAX_ETA = 0.5  # sin of the widest turn allowed
RAY_CULL_MIN_COS = 0.17  # cos(theta_max + beta) >= 0.17: sec^2 stays below 35
RAY_BOX_REL = 1e-6  # of each rectangle coordinate (16x the fp32 rounding)
RAY_BOX_ABS = 1e-6  # ~1e-3 of a pixel at 704x1280, 50 degrees


def ray_triangle_bounds(tri: torch.Tensor) -> torch.Tensor:
    """Per triangle row of ``ray_triangle_setup`` (T, 13), the rectangle
    (x_lo, y_lo, x_hi, y_hi) fp32 of d_x/d_z, d_y/d_z that holds every ray
    d that can pass its fp32 hit test (see the rule above); (-inf, -inf,
    inf, inf) for an uncullable triangle. Computed in fp64, one operation at
    a time in K6's setup kernel's order."""
    t64 = tri.double()
    e1, e2, s = t64[:, 0:3], t64[:, 3:6], t64[:, 6:9]
    p0 = -s
    p1, p2 = p0 + e1, p0 + e2
    det = _dot(p0, _cross(p1, p2)).abs()
    n_e1, n_e2, n_s = (torch.sqrt(_dot(v, v)) for v in (e1, e2, s))
    err_a = RAY_TEST_ERR * n_e1 * n_e2
    err_u = RAY_TEST_ERR * n_s * n_e2
    err_v = RAY_TEST_ERR * n_s * n_e1
    err_w = err_a + err_u + err_v + 4 * _ROUND * n_e1 * n_e2
    err_t = RAY_TEST_ERR * n_e1 * n_e2 * n_s
    n_p0, n_p1, n_p2 = (torch.sqrt(_dot(v, v)) for v in (p0, p1, p2))
    eta = (err_w * n_p0 + err_u * n_p1 + err_v * n_p2) / det
    cos_polar = torch.minimum(torch.minimum(p0[:, 2] / n_p0, p1[:, 2] / n_p1), p2[:, 2] / n_p2)
    cos_beta = torch.sqrt(1.0 - eta * eta)
    cos_far = cos_polar * cos_beta - torch.sqrt(1.0 - cos_polar * cos_polar) * eta
    margin = eta / (cos_beta * cos_far * cos_far)
    cullable = (torch.isfinite(tri).all(dim=1) & (p0[:, 2] > 0) & (p1[:, 2] > 0) & (p2[:, 2] > 0)
                & (det > 2.0 * err_t) & (eta <= RAY_CULL_MAX_ETA) & (cos_far >= RAY_CULL_MIN_COS))
    bounds = []
    for axis in (0, 1):
        x0, x1, x2 = p0[:, axis] / p0[:, 2], p1[:, axis] / p1[:, 2], p2[:, axis] / p2[:, 2]
        lo = torch.minimum(torch.minimum(x0, x1), x2) - margin
        hi = torch.maximum(torch.maximum(x0, x1), x2) + margin
        bounds.append((lo - RAY_BOX_REL * lo.abs() - RAY_BOX_ABS,
                       hi + RAY_BOX_REL * hi.abs() + RAY_BOX_ABS))
    box = torch.stack([bounds[0][0], bounds[1][0], bounds[0][1], bounds[1][1]], dim=1)
    whole = torch.tensor([-math.inf, -math.inf, math.inf, math.inf], dtype=torch.float64,
                         device=tri.device)
    return torch.where(cullable[:, None], box, whole).float().contiguous()


def ray_chunk_bounds(boxes: torch.Tensor) -> torch.Tensor:
    """The union of every RAY_CHUNK consecutive triangle rectangles,
    (ceil(T / RAY_CHUNK), 4) fp32: K6's first culling level."""
    T = boxes.shape[0]
    pad = -T % RAY_CHUNK
    empty = torch.tensor([math.inf, math.inf, -math.inf, -math.inf], device=boxes.device)
    full = torch.cat([boxes, empty.expand(pad, 4)]).reshape(-1, RAY_CHUNK, 4)
    return torch.cat([full[..., :2].amin(dim=1), full[..., 2:].amax(dim=1)], dim=1).contiguous()


def ray_tiles(ray_dirs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's tiles of rays, RAY_TILE consecutive rays each (ray r is in tile
    r // RAY_TILE): their exact rectangles (n, 4) fp32 of d_x/d_z, d_y/d_z
    over the rays, and whether the tile culls (n,) bool: False when a ray
    has d_z <= 0 or a non-finite ratio (NaN included), and the tile then
    tests every triangle."""
    R = ray_dirs.shape[0]
    tile, n = torch.arange(R, device=ray_dirs.device) // RAY_TILE, -(-R // RAY_TILE)
    d = ray_dirs.float()
    rx, ry = d[:, 0] / d[:, 2], d[:, 1] / d[:, 2]
    good = (d[:, 2] > 0) & torch.isfinite(rx) & torch.isfinite(ry)

    def reduce(v, fill, how):
        out = torch.full((n,), fill, device=d.device)
        return out.scatter_reduce_(0, tile, torch.where(good, v, fill), how)

    box = torch.stack([reduce(rx, math.inf, "amin"), reduce(ry, math.inf, "amin"),
                       reduce(rx, -math.inf, "amax"), reduce(ry, -math.inf, "amax")], dim=1)
    bad = torch.zeros(n, device=d.device).index_add_(0, tile, (~good).float())
    return box, bad == 0


def ray_triangle_kept(tiles: torch.Tensor, cull: torch.Tensor,
                      boxes: torch.Tensor) -> torch.Tensor:
    """(n tiles, T) bool: the (tile, triangle) pairs K6 tests, those whose
    rectangles overlap (closed) or whose tile does not cull."""
    t, b = tiles[:, None], boxes[None]
    overlap = ((b[..., 0] <= t[..., 2]) & (b[..., 2] >= t[..., 0]) & (b[..., 1] <= t[..., 3])
               & (b[..., 3] >= t[..., 1]))
    return overlap | ~cull[:, None]


def ray_triangle_depth_culled_reference(ray_dirs: torch.Tensor, v0: torch.Tensor,
                                        v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """K6 as the kernel runs it, in plain torch: only the (tile, triangle)
    pairs that ``ray_triangle_kept`` keeps are tested. It equals
    ``ray_triangle_depth_reference`` bit for bit when no culled pair hits."""
    R, T = ray_dirs.shape[0], v0.shape[0]
    if T == 0 or R == 0:
        return torch.zeros(R, dtype=torch.float32, device=ray_dirs.device)
    tri = ray_triangle_setup(v0.float(), v1.float(), v2.float())
    kept = ray_triangle_kept(*ray_tiles(ray_dirs), ray_triangle_bounds(tri))
    return _ray_triangle_hits(ray_dirs.float(), tri,
                              lambda r0, r1: kept[torch.arange(r0, r1, device=kept.device) // RAY_TILE])


def ray_triangle_footprint_pairs(ray_dirs: torch.Tensor, boxes: torch.Tensor,
                                 pairs_at_once: int = 1 << 26) -> int:
    """The (ray, triangle) pairs a per-ray footprint test keeps: for each
    triangle the rays whose (d_x/d_z, d_y/d_z) lie in its rectangle (every
    ray for an uncullable one), plus every triangle for each ray with d_z
    <= 0 or a non-finite ratio. K6's bound counts 36 operations for each.
    Each triangle's rays are counted from the rays sorted by x or by y,
    whichever range is shorter."""
    d = ray_dirs.float()
    rx, ry = d[:, 0] / d[:, 2], d[:, 1] / d[:, 2]
    good = (d[:, 2] > 0) & torch.isfinite(rx) & torch.isfinite(ry)
    rx, ry = rx[good], ry[good]
    n_good, T = rx.numel(), boxes.shape[0]
    total = (d.shape[0] - n_good) * T
    if n_good == 0 or T == 0:
        return int(total)
    whole = torch.isinf(boxes).all(dim=1)
    total += int(whole.sum()) * n_good
    boxes = boxes[~whole]
    ranges = []
    for key, other, k_lo, k_hi, o_lo, o_hi in ((rx, ry, 0, 2, 1, 3), (ry, rx, 1, 3, 0, 2)):
        order = torch.argsort(key)
        keys = key[order].contiguous()
        i0 = torch.searchsorted(keys, boxes[:, k_lo].contiguous(), right=False)
        i1 = torch.searchsorted(keys, boxes[:, k_hi].contiguous(), right=True)
        ranges.append((i0, (i1 - i0).clamp(min=0), other[order], o_lo, o_hi))
    use_x = ranges[0][1] <= ranges[1][1]
    for which, (i0, n, other, o_lo, o_hi) in ((use_x, ranges[0]), (~use_x, ranges[1])):
        idx = torch.nonzero(which).flatten()
        ends = torch.cumsum(n[idx], 0)
        start = 0
        while start < idx.numel():
            stop = int(torch.searchsorted(ends, ends[start] - n[idx[start]] + pairs_at_once,
                                          right=True))
            stop = max(stop, start + 1)
            sel = idx[start:stop]
            cnt = n[sel]
            owner = torch.repeat_interleave(torch.arange(sel.numel(), device=d.device), cnt)
            first = torch.cumsum(cnt, 0) - cnt
            pos = i0[sel][owner] + torch.arange(owner.numel(), device=d.device) - first[owner]
            v = other[pos]
            total += int(((v >= boxes[sel, o_lo][owner]) & (v <= boxes[sel, o_hi][owner])).sum())
            start = stop
    return int(total)


def gqa_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal_offset: Optional[int] = None,
                            kv_valid_start: Optional[torch.Tensor] = None,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention over a KV cache, K8's plain version
    (ar_transformer.py ``_gqa_attention``, :252-297, line for line).

    q (B, Lq, Hq, d); k/v (B, Lk, Hkv, d), Hq % Hkv == 0. Key j is visible
    to query i iff kv_valid_start[b] <= j <= causal_offset + i;
    causal_offset None: every key (the T5 cross-attention), still cut by
    kv_valid_start. K and V are repeated to Hq heads, the logits formed in
    q's dtype, scaled by 1/sqrt(d) and soft-maxed in fp32 with -1e30 on the
    masked keys (a row that sees no key averages every key). int8 mode:
    k/v hold int8 codes, k_scale/v_scale (B, Lk, Hkv, 1) fp32 multiply
    logit column j and probability column j before P V. The output is in
    q's dtype. scale replaces 1/sqrt(d) (the unpadded width's, for inputs
    that ``cuda.pad_head`` widened)."""
    B, Lq, Hq, d = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    if k_scale is not None:
        k = k.to(q.dtype)
    if v_scale is not None:
        v = v.to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits * (1.0 / math.sqrt(d) if scale is None else scale)
    if k_scale is not None:
        ks = k_scale.repeat_interleave(rep, dim=2)  # (B, Lk, Hq, 1)
        logits = logits * ks[..., 0].transpose(1, 2)[:, :, None, :]
    kpos = torch.arange(Lk, device=q.device)[None, :]
    if causal_offset is not None:
        qpos = torch.arange(Lq, device=q.device)[:, None] + causal_offset
        mask = (kpos <= qpos)[None]  # (1, Lq, Lk)
        if kv_valid_start is not None:
            mask = mask & (kpos[None] >= kv_valid_start[:, None, None])
        logits = torch.where(mask[:, None], logits, torch.full_like(logits, -1e30))
    elif kv_valid_start is not None:
        mask = kpos >= kv_valid_start[:, None]  # (B, Lk)
        logits = torch.where(mask[:, None, None, :], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        vs = v_scale.repeat_interleave(rep, dim=2)  # (B, Lk, Hq, 1)
        probs = probs * vs[..., 0].transpose(1, 2)[:, :, None, :]
    probs = probs.to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def gqa_attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     dout: torch.Tensor, causal_offset: Optional[int] = None,
                                     kv_valid_start: Optional[torch.Tensor] = None,
                                     scale: Optional[float] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``gqa_attention_reference`` (no int8 scales; scale
    as there) at the
    upstream gradient dout, K8bwd's plain version: the gradient
    ``jax.grad`` takes of ar_transformer.py's ``_gqa_attention`` (:252-297),
    formed in fp32 and cast to the inputs' dtypes.

    P is the forward's softmax with -1e30 on the masked logits; dS = P (dO
    V^T - rowsum(P * dO V^T)) flows only to the visible logits (the
    ``where``), dq = dS K / sqrt(d), and dk, dv (dS^T q / sqrt(d), P^T dO)
    are summed over each KV head's rep query heads. A row that sees no key
    averages every key, as there: its dq is 0, but it adds dO / Lk to every
    row of dv (K8bwd's kernel, whose forward gives such a row 0, adds
    nothing)."""
    B, Lq, Hq, d = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    kr = kf.repeat_interleave(rep, dim=2)
    vr = vf.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = None
    if causal_offset is not None:
        qpos = torch.arange(Lq, device=q.device)[:, None] + causal_offset
        mask = (kpos <= qpos)[None]  # (1, Lq, Lk)
        if kv_valid_start is not None:
            mask = mask & (kpos[None] >= kv_valid_start[:, None, None])
        mask = mask[:, None]
    elif kv_valid_start is not None:
        mask = (kpos >= kv_valid_start[:, None])[:, None, None, :]
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = probs * (dp - (probs * dp).sum(dim=-1, keepdim=True))
    if mask is not None:
        ds = torch.where(mask, ds, torch.zeros_like(ds))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", probs, dof)
    dk = dk.reshape(B, Lk, Hkv, rep, d).sum(dim=3)
    dv = dv.reshape(B, Lk, Hkv, rep, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
