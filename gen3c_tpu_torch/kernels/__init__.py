"""Hand-written Hopper kernels of the port, chosen by the tensor's device.

  K1  DiT self-attention   (gen3c_tpu/models/dit.py:445-471, Pallas splash)
  K2  DiT cross-attention  (dit.py:472-510, Pallas flash)
  K5  forward-warp splat   (gen3c_tpu/ops/geometry.py:205-316)

K1 and K2 share ``csrc/attention.cu``; K5 is ``csrc/splat.cu``. A CUDA
tensor launches the compiled kernel (built at first use, see ``build``);
a CPU tensor runs the plain PyTorch version in ``reference``. There is no
other switch: on a card the references run only where a caller asks for
them by name.

``launch_counts`` counts kernel launches per kernel id, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gen3c_tpu_torch.kernels.reference import (
    attention_reference,
    splat_max_logd,
    splat_normalize,
    splat_reference,
)

__all__ = [
    "attention", "splat", "launch_counts", "reset_launch_counts",
    "attention_reference", "splat_reference",
]

launch_counts = {"K1": 0, "K2": 0, "K5": 0}


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
              kernel_id: str = "K1") -> torch.Tensor:
    """Non-causal attention, q (B, Lq, H, D), k/v (B, Lk, H, D).

    kernel_id names the TPU kernel this call stands in for ("K1" for
    self-attention, "K2" for cross-attention); it selects the launch count.
    """
    if not _on_cuda(q, "attention"):
        return attention_reference(q, k, v)
    from gen3c_tpu_torch.kernels import cuda

    out = cuda.attention(q, k, v)
    launch_counts[kernel_id] += 1
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
