"""Hand-written Hopper kernels of the port, chosen by the tensor's device.

  K1   DiT self-attention        (gen3c_tpu/models/dit.py:445-471, Pallas splash)
  K2   DiT cross-attention       (dit.py:472-510, Pallas flash)
  K3   band self-attention       (dit.py:459-460, splash + make_temporal_band_mask :370-409)
  K5   forward-warp splat        (gen3c_tpu/ops/geometry.py:205-316)
  K7q  per-token int8 quantize   (gen3c_tpu/models/quantize.py:55-59)
  K7   int8 x int8 GEMM + rescale (quantize.py:60-69)

K1, K2 and K3 share ``csrc/attention.cu``; K5 is ``csrc/splat.cu``; K7q
and K7 are ``csrc/w8a8.cu``. A CUDA tensor launches the compiled kernel
(built at first use, see ``build``); a CPU tensor runs the plain PyTorch
version in ``reference``. There is no other switch: on a card the
references run only where a caller asks for them by name.

``launch_counts`` counts kernel launches per kernel id, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gen3c_tpu_torch.kernels.reference import (
    Band,
    attention_reference,
    int8_matmul_reference,
    quantize_rows_reference,
    splat_max_logd,
    splat_normalize,
    splat_reference,
    w8a8_matmul_reference,
)

__all__ = [
    "attention", "splat", "quantize_rows", "w8a8_matmul", "launch_counts",
    "reset_launch_counts", "attention_reference", "splat_reference",
    "quantize_rows_reference", "int8_matmul_reference", "w8a8_matmul_reference",
]

launch_counts = {"K1": 0, "K2": 0, "K3": 0, "K5": 0, "K7q": 0, "K7": 0}


def reset_launch_counts() -> None:
    for key in launch_counts:
        launch_counts[key] = 0


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
    self-attention, "K2" for cross-attention); it selects the launch count.
    band=(hw, window, prefix) is the temporal band of K3 (see
    ``attention_reference``); a call with a band counts as K3.

    The kernels have no backward yet (K4): on a card, inputs that require
    grad are refused rather than given a result that autograd would treat
    as a constant.
    """
    if not _on_cuda(q, "attention"):
        return attention_reference(q, k, v, band)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "attention on CUDA has no backward kernel yet (K4, the splash/flash "
            "backward, is not ported): call it under torch.no_grad()")
    from gen3c_tpu_torch.kernels import cuda

    out = cuda.attention(q, k, v, band)
    launch_counts["K3" if band is not None else kernel_id] += 1
    return out


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization (K7q): x (M, K) -> (int8 codes
    (M, K), fp32 scales (M,)); see ``quantize_rows_reference``."""
    if not _on_cuda(x, "quantize_rows"):
        return quantize_rows_reference(x)
    from gen3c_tpu_torch.kernels import cuda

    out = cuda.quantize_rows(x)
    launch_counts["K7q"] += 1
    return out


def w8a8_matmul(x: torch.Tensor, qweight: torch.Tensor, wscale: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """x (..., K) @ int8 qweight (N, K)^T with dynamic per-token int8
    activations: K7q on x's rows, then K7 (int32 accumulation, rescale by
    both scales, cast to out_dtype). gen3c_tpu's ``w8a8_matmul``."""
    K = x.shape[-1]
    if not _on_cuda(x, "w8a8_matmul"):
        return w8a8_matmul_reference(x, qweight, wscale, out_dtype)
    from gen3c_tpu_torch.kernels import cuda

    xq, xscale = quantize_rows(x.reshape(-1, K))
    out = cuda.int8_gemm(xq, qweight, xscale, wscale, out_dtype)
    launch_counts["K7"] += 1
    return out.reshape(*x.shape[:-1], qweight.shape[0])


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
    whole batch, as there).
    """
    if not _on_cuda(frame1, "splat"):
        return splat_reference(frame1, mask1, depth1, flow12, flow12_mask,
                               is_image, depth_weight_scale, group)
    from gen3c_tpu_torch.kernels import cuda

    b, c, h, w = frame1.shape
    max_logd = splat_max_logd(depth1, group)
    acc = cuda.splat_accumulate(frame1, mask1, depth1, flow12, flow12_mask,
                                max_logd, depth_weight_scale)
    launch_counts["K5"] += 1
    return splat_normalize(acc, c, h, w, is_image)
