"""Hand-written Hopper kernels of the port, chosen by the tensor's device.

  K1   DiT self-attention        (gen3c_tpu/models/dit.py:445-471, Pallas splash)
  K2   DiT cross-attention       (dit.py:472-510, Pallas flash)
  K3   band self-attention       (dit.py:459-460, splash + make_temporal_band_mask :370-409)
  K1cp  K1 (or K3 under the band) on the H/cp heads of a Ulysses rank
                                 (dit.py:653-678, splash after the all-to-all)
  K1ag  K1 on a query shard over the all-gathered keys (dit.py:763-766)
  K1ring  one ring-attention step: the forward with lse of a query shard over
                                 one KV shard (dit.py:597-645, an XLA stand-in)
  K1merge the ring's online-softmax merge of a step into the running result
  K3lse  the band forward that keeps the row logsumexp (the forward of K4band)
  K4   attention backward        (splash/flash backward, dit.py:464-470 and :508, reached
                                  from gen3c_tpu/training/train_step.py:233)
  K4band  band attention backward (the splash backward under K3's mask, dit.py:459-470)
  K1vit  MoGe's ViT self-attention  (gen3c_tpu/aux/moge.py:159-173, XLA), fp32: three
                                 TF32 products on the tensor cores (attention_f32.cu)
  K5   forward-warp splat        (gen3c_tpu/ops/geometry.py:205-316)
  K6   nearest ray-triangle hit  (gen3c_tpu/ops/raycast.py:97-140)
  K7q  per-token int8 quantize   (gen3c_tpu/models/quantize.py:55-59), one pass a row;
                                 its row-scale mode for a row split over tp ranks:
                                 a pass that writes the slice's row absmax, then the
                                 codes with the max over the ranks
  K7   int8 x int8 GEMM + rescale (quantize.py:60-69), TMA + wgmma s8
  K8   GQA attention over the KV cache (gen3c_tpu/models/ar_transformer.py:252-297,
                                 XLA): causal, left padding, int8 codes with fp32 scales
  K8bwd  its backward for training (XLA's autodiff of the same function, reached
                                 from gen3c_tpu/training/ar_train.py:52): bf16 on
                                 TMA + wgmma (K4's pair in its GQA mode), fp32 on the
                                 CUDA cores
  P1   wgmma rate probe          (scripts/probe_int8_attention.py:37-62; ``mma_probe``)
  P2   K1's tile sweep           (scripts/sweep_attention.py:32-68; ``attention_point``:
                                 K1's wgmma forward built at a point of the sweep)

The bf16 attention family (K1, K2, K3, K1cp, K1ag, K3lse, K1ring, the
training forward with the row logsumexp, K4, K4band) runs
``csrc/attention_wgmma.cu`` (TMA + wgmma, its PTX helpers in
``csrc/hopper.h``) wherever ``cuda.attention_route`` says a TMA tensor map
describes the inputs, else the mma.sync bodies: K1, K2 and K3 in
``csrc/attention.cu``; K4, K4band and the training forward in
``csrc/attention_bwd.cu``; K1ring is ``attention_bwd.cu`` too and K1merge
``csrc/attention_merge.cu``; an fp32 forward (K1vit, the fp32 tiny
preset's K1, K2, K3) is ``csrc/attention_f32.cu``; P2 is
``attention_wgmma.cu``'s forward built at its sweep's points; K5 is
``csrc/splat.cu``; K6 is
``csrc/raycast.cu``; K7q and K7 are ``csrc/w8a8.cu``; K8 is ``csrc/gqa_attention.cu`` (its bf16
prefill and training forward ``attention_wgmma.cu``'s GQA mode); K8bwd in
bf16 is ``attention_wgmma.cu``'s backward pair in its GQA mode (a split
dK/dV grid where the key axis is short: ``cuda.gqa_bwd_plan``), in fp32
``csrc/gqa_attention_bwd.cu``; P1 is ``csrc/mma_probe.cu``. A CUDA tensor launches the compiled kernel (built at
first use, see ``build``); a CPU tensor runs the plain PyTorch version in
``reference``. There is no other switch: on a card the references run only
where a caller asks for them by name.

``launch_counts`` counts kernel launches per kernel id, so a run can show
that its main path went through the kernels (K4 once per backward call,
``k4_launches_by_forward`` by the forward it differentiates).
``route_counts`` splits the bf16 attention family's launches (every entry
above that ``csrc/attention_wgmma.cu`` can serve: K1, K2, K3, K1cp, K1ag,
K3lse, K1ring and the forwards with lse, K4, K4band) by the body
``cuda.attention_route`` chose: "wgmma" (TMA + wgmma,
``attention_wgmma.cu``) for inputs a TMA tensor map describes, "mma_sync"
(``attention.cu`` / ``attention_bwd.cu``) for the rest. A bf16 K8bwd call
counts "wgmma" too (it has no other body). P2 calls its forward by point
and takes no route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gen3c_tpu_torch.kernels.reference import (
    Band,
    attention_backward_reference,
    attention_forward_reference,
    attention_reference,
    gqa_attention_backward_reference,
    gqa_attention_reference,
    int8_matmul_reference,
    mma_probe_reference,
    quantize_rows_reference,
    ray_triangle_depth_reference,
    row_absmax_reference,
    ring_fold_reference,
    ring_merge_reference,
    splat_reference,
    w8a8_matmul_reference,
)

__all__ = [
    "attention", "attention_point", "splat", "ray_triangle_depth", "quantize_rows",
    "w8a8_matmul", "mma_probe", "ring_fold", "ring_merge", "gqa_attention", "launch_counts",
    "route_counts", "gqa_attention_reference", "gqa_attention_backward_reference",
    "reset_launch_counts", "attention_reference", "attention_forward_reference", "attention_backward_reference", "splat_reference",
    "ray_triangle_depth_reference", "quantize_rows_reference", "int8_matmul_reference",
    "row_absmax", "row_absmax_reference",
    "w8a8_matmul_reference", "mma_probe_reference", "ring_fold_reference",
    "ring_merge_reference",
]

launch_counts = {"K1": 0, "K2": 0, "K3": 0, "K3lse": 0, "K4": 0, "K4band": 0, "K5": 0, "K6": 0,
                 "K7q": 0, "K7": 0, "P1": 0, "P2": 0, "K1cp": 0, "K1ag": 0, "K1ring": 0,
                 "K1merge": 0, "K1vit": 0, "K8": 0, "K8bwd": 0}
# K4's launches split by the forward they differentiate (K1 self-, K2 cross-attention,
# K1cp a context-parallel rank's self-attention heads)
k4_launches_by_forward = {"K1": 0, "K2": 0, "K1cp": 0}
# the bf16 attention family's launches by body (cuda.attention_route)
route_counts = {"wgmma": 0, "mma_sync": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, k4_launches_by_forward, route_counts):
        for key in counts:
            counts[key] = 0


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{what}: no kernel or reference for device {t.device}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kernel_id: str = "K1", band: Optional[Band] = None) -> torch.Tensor:
    """Non-causal attention, q (B, Lq, H, D), k/v (B, Lk, H, D).

    kernel_id names the TPU kernel this call stands in for ("K1" for
    self-attention, "K2" for cross-attention, "K1cp" for a Ulysses rank's
    heads, "K1ag" for a query shard over all-gathered keys, "K1vit" for
    MoGe's ViT); it selects the launch count. band=(hw, window, prefix) is the temporal band of K3 (see
    ``attention_reference``); a forward-only "K1" call with a band counts as
    K3, a "K1cp" call as K1cp with or without one.

    Without a gradient to track (grad mode off, or no input requiring
    grad) this is one forward launch. Otherwise it is ``_Attention``: a
    forward that also keeps the row logsumexp (counted under kernel_id, or
    K3lse with a band) and K4 as its backward (K4band with a band). Under
    per-block remat the forward of a block runs twice per training step
    (forward, then the recompute before its backward), so the forward
    counts two launches per block and step and the backward one.
    """
    on_cuda = _on_cuda(q, "attention")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, kernel_id, band)
    if not on_cuda:
        return attention_reference(q, k, v, band)
    from gen3c_tpu_torch.kernels import cuda

    out = cuda.attention(q, k, v, band)
    launch_counts["K3" if band is not None and kernel_id == "K1" else kernel_id] += 1
    return out


class _Attention(torch.autograd.Function):
    """Attention whose backward is K4, or K4band under a band (dq, dk, dv
    from the saved q, k, v, output and logsumexp) on a card,
    ``attention_backward_reference`` on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, kernel_id, band):
        if q.device.type == "cuda":
            from gen3c_tpu_torch.kernels import cuda

            out, lse = cuda.attention_fwd_lse(q, k, v, band)
            launch_counts["K3lse" if band is not None else kernel_id] += 1
        else:
            out, lse = attention_forward_reference(q, k, v, band)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.band, ctx.kernel_id = band, kernel_id
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            from gen3c_tpu_torch.kernels import cuda

            dq, dk, dv = cuda.attention_bwd(q, k, v, out, dout, lse, ctx.band)
            if ctx.band is not None:
                launch_counts["K4band"] += 1
            else:
                launch_counts["K4"] += 1
                k4_launches_by_forward[ctx.kernel_id] += 1
        else:
            dq, dk, dv = attention_backward_reference(q, k, v, out, dout, lse, ctx.band)
        return dq, dk, dv, None, None


def ring_fold(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, band: Optional[Band] = None,
              q_off: int = 0, k_off: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1ring: one ring-attention step, (out like q, fp32 lse (B, H, Lq))
    of the queries (global positions q_off + i) over one KV shard (k_off +
    j); rows the band leaves without a key give 0 and -inf. See
    ``ring_fold_reference``."""
    if not _on_cuda(q, "ring_fold"):
        return ring_fold_reference(q, k, v, band, q_off, k_off)
    from gen3c_tpu_torch.kernels import cuda

    out = cuda.attention_ring_fold(q, k, v, band, q_off, k_off)
    launch_counts["K1ring"] += 1
    return out


def ring_merge(acc: torch.Tensor, acc_lse: torch.Tensor, out: Optional[torch.Tensor] = None,
               lse: Optional[torch.Tensor] = None,
               final_dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
    """K1merge: fold a ring step's (out, lse) into the running fp32 state
    (acc, acc_lse) in place, or with final_dtype return the merged result
    in that dtype; see ``ring_merge_reference``."""
    if not _on_cuda(acc, "ring_merge"):
        return ring_merge_reference(acc, acc_lse, out, lse, final_dtype)
    from gen3c_tpu_torch.kernels import cuda

    merged = cuda.attention_merge(acc, acc_lse, out, lse, final_dtype)
    launch_counts["K1merge"] += 1
    return merged


def quantize_rows(x: torch.Tensor, absmax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization (K7q): x (M, K) -> (int8 codes
    (M, K), fp32 scales (M,)); see ``quantize_rows_reference``. absmax (M,)
    fp32: the rows' absmax taken elsewhere (K7q's row-scale mode, x a slice
    of the rows: ``row_absmax``)."""
    if not _on_cuda(x, "quantize_rows"):
        return quantize_rows_reference(x, absmax)
    from gen3c_tpu_torch.kernels import cuda

    out = cuda.quantize_rows(x, absmax)
    launch_counts["K7q"] += 1
    return out


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """K7q's row-absmax pass: max |x| of each row of x (M, K), fp32 (M,)."""
    if not _on_cuda(x, "row_absmax"):
        return row_absmax_reference(x)
    from gen3c_tpu_torch.kernels import cuda

    out = cuda.row_absmax(x)
    launch_counts["K7q"] += 1
    return out


def w8a8_matmul(x: torch.Tensor, qweight: torch.Tensor, wscale: torch.Tensor,
                out_dtype: torch.dtype, tp=None) -> torch.Tensor:
    """x (..., K) @ int8 qweight (N, K)^T with dynamic per-token int8
    activations: K7q on x's rows, then K7 (int32 accumulation, rescale by
    both scales, cast to out_dtype). gen3c_tpu's ``w8a8_matmul``.

    tp: the axis (``parallel.mesh.Axis``) of a row-parallel linear, x and
    qweight this rank's columns of the rows: each token's scale is the
    absmax over the whole row (K7q's row-absmax pass, then the max over
    tp, then its codes), K7's int32 sums are added over tp (exact), then
    rescaled, so that every rank holds the one-device product, bit for bit."""
    K = x.shape[-1]
    if tp is not None and tp.size > 1:
        return _w8a8_row_parallel(x, qweight, wscale, out_dtype, tp)
    if not _on_cuda(x, "w8a8_matmul"):
        return w8a8_matmul_reference(x, qweight, wscale, out_dtype)
    from gen3c_tpu_torch.kernels import cuda

    xq, xscale = quantize_rows(x.reshape(-1, K))
    out = cuda.int8_gemm(xq, qweight, xscale, wscale, out_dtype)
    launch_counts["K7"] += 1
    return out.reshape(*x.shape[:-1], qweight.shape[0])


def _w8a8_row_parallel(x, qweight, wscale, out_dtype, tp) -> torch.Tensor:
    from gen3c_tpu_torch.parallel import collectives

    x2 = x.reshape(-1, x.shape[-1])
    absmax = collectives.all_reduce(row_absmax(x2), tp, "max")
    xq, xscale = quantize_rows(x2, absmax)
    if _on_cuda(x, "w8a8_matmul"):
        from gen3c_tpu_torch.kernels import cuda

        acc = cuda.int8_gemm(xq, qweight, None, None, torch.int32)
        launch_counts["K7"] += 1
    else:
        acc = int8_matmul_reference(xq, qweight)
    acc = collectives.all_reduce(acc, tp)
    out = acc.float().mul_(xscale[:, None]).mul_(wscale.float()[None, :])
    return out.to(out_dtype).reshape(*x.shape[:-1], qweight.shape[0])


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal_offset: Optional[int] = None,
                  kv_valid_start: Optional[torch.Tensor] = None,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8: grouped-query attention of q (B, Lq, Hq, d) over k/v (B, Lk, Hkv,
    d), a KV cache read in place: key j is visible to query i iff
    kv_valid_start[b] <= j <= causal_offset + i (causal_offset None: every
    key); int8 k/v with fp32 k_scale/v_scale (B, Lk, Hkv, 1). See
    ``gqa_attention_reference``. On a card one launch (``cuda.gqa_route``'s
    body: a decode's key splits merged inside it) reads only the keys some
    query can see and never repeats heads; a row that sees no key (a
    left-pad query) gives 0 there, where the plain version averages every
    key: such rows are never read (their keys are masked in every layer).

    With a gradient to track (grad mode on and q, k or v requiring grad;
    no int8 scales) this is ``_GqaAttention``: K8's forward with the row
    logsumexp (counted K8) and K8bwd as its backward."""
    on_cuda = _on_cuda(q, "gqa_attention")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if k_scale is not None or v_scale is not None:
            raise ValueError("gqa_attention: an int8 cache has no backward")
        return _GqaAttention.apply(q, k, v, causal_offset, kv_valid_start)
    if not on_cuda:
        return gqa_attention_reference(q, k, v, causal_offset, kv_valid_start, k_scale, v_scale)
    from gen3c_tpu_torch.kernels import cuda

    out = cuda.gqa_attention(q, k, v, causal_offset, kv_valid_start, k_scale, v_scale)
    launch_counts["K8"] += 1
    return out


class _GqaAttention(torch.autograd.Function):
    """K8 whose backward is K8bwd (dq, dk, dv from the saved q, k, v,
    output and row logsumexp; dk and dv summed over each KV head's query
    heads) on a card, ``gqa_attention_backward_reference`` on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal_offset, kv_valid_start):
        lse = None
        if q.device.type == "cuda":
            from gen3c_tpu_torch.kernels import cuda

            out, lse = cuda.gqa_attention_fwd_lse(q, k, v, causal_offset, kv_valid_start)
            launch_counts["K8"] += 1
        else:
            out = gqa_attention_reference(q, k, v, causal_offset, kv_valid_start)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal_offset, ctx.kv_valid_start = causal_offset, kv_valid_start
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            from gen3c_tpu_torch.kernels import cuda

            dq, dk, dv = cuda.gqa_attention_bwd(q, k, v, out, dout, lse, ctx.causal_offset,
                                                ctx.kv_valid_start)
            launch_counts["K8bwd"] += 1
        else:
            dq, dk, dv = gqa_attention_backward_reference(q, k, v, dout, ctx.causal_offset,
                                                          ctx.kv_valid_start)
        return dq, dk, dv, None, None


def attention_point(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    point: Tuple[int, int, int]) -> torch.Tensor:
    """P2: K1's forward (``csrc/attention_wgmma.cu``) built at a point of its
    sweep, (consumer warpgroups, keys per tile, ring stages); (2, 64, 4) is
    K1's own (``cuda.K1_POINT``), which gives K1's bits. bf16 q (B, Lq, H,
    D), k/v (B, Lk, H, D) that a TMA tensor map describes. The tile sweep's
    kernel: the port's attention always runs K1's point (``attention``)."""
    if not _on_cuda(q, "attention_point"):
        return attention_reference(q, k, v)
    from gen3c_tpu_torch.kernels import cuda

    out = cuda.attention_point(q, k, v, point)
    launch_counts["P2"] += 1
    return out


def ray_triangle_depth(ray_dirs: torch.Tensor, v0: torch.Tensor, v1: torch.Tensor,
                       v2: torch.Tensor) -> torch.Tensor:
    """K6: the nearest hit distance per ray, (R,) fp32, 0.0 where no triangle
    hits (gen3c_tpu's ``ray_triangle_depth``). ray_dirs (R, 3) with origins
    at 0, triangles v0/v1/v2 (T, 3), all fp32; T may be 0 (zeros, nothing
    launched). See ``ray_triangle_depth_reference``; on a card the triangles
    are culled per 256 rays (``reference.ray_triangle_bounds``), which
    keeps its bits. One K6 launch counted per call (setup and depth
    kernels)."""
    if not _on_cuda(ray_dirs, "ray_triangle_depth"):
        return ray_triangle_depth_reference(ray_dirs, v0, v1, v2)
    if v0.shape[0] == 0 or ray_dirs.shape[0] == 0:
        return torch.zeros(ray_dirs.shape[0], dtype=torch.float32, device=ray_dirs.device)
    from gen3c_tpu_torch.kernels import cuda

    out = cuda.ray_triangle_depth(ray_dirs, v0, v1, v2)
    launch_counts["K6"] += 1
    return out


def splat(
    frame1: torch.Tensor,
    mask1: Optional[torch.Tensor],
    depth1: torch.Tensor,
    flow12: torch.Tensor,
    flow12_mask: Optional[torch.Tensor] = None,
    is_image: bool = False,
    depth_weight_scale: float = 50.0,
    group: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear forward splat: (warped (b,c,h,w), mask2 (b,1,h,w)).

    Same contract as gen3c_tpu.ops.geometry.bilinear_splatting; ``group``
    consecutive batch entries share one log-depth maximum (default: the
    whole batch, as there). On a card one K5 is counted per call, which
    runs ``cuda.splat``'s three kernels.
    """
    if not _on_cuda(frame1, "splat"):
        return splat_reference(frame1, mask1, depth1, flow12, flow12_mask,
                               is_image, depth_weight_scale, group)
    from gen3c_tpu_torch.kernels import cuda

    out = cuda.splat(frame1, mask1, depth1, flow12, flow12_mask, is_image, depth_weight_scale,
                     group)
    launch_counts["K5"] += 1
    return out


def mma_probe(a: torch.Tensor, b: torch.Tensor, reps: int,
              form: Optional[str] = None) -> torch.Tensor:
    """P1: sum over i < reps of (a + i % 2) @ b, a (M, K) and b (K, N) both
    bf16 (fp32 out) or both int8 (int32 out); see ``mma_probe_reference``.
    On a card, ``csrc/mma_probe.cu`` issues it on wgmma as ``form``
    (``cuda.MMA_PROBE_FORMS``; default the widest the N tile allows) over
    ``cuda.mma_probe_plan``'s units, each CTA's operands resident in shared
    memory, then sums the units' partials: one launch counted for both."""
    if not _on_cuda(a, "mma_probe"):
        return mma_probe_reference(a, b, reps)
    from gen3c_tpu_torch.kernels import cuda

    out = cuda.mma_probe(a, b, reps, form)
    launch_counts["P1"] += 1
    return out
