"""Cache renders with the target frames split over ranks (port of
gen3c_tpu/parallel/cache_sharding.py).

Each target frame's splat render is independent, so the 121-frame warp
render splits across the ranks of an axis: the targets are padded to a
multiple of the axis size with the last one, each rank renders its
contiguous share through the cache's own render (``forward_warp``, K5 on
a card), and an all-gather over the axis puts every frame on every rank.
The cache (its images, points and masks) is the same on every rank.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gen3c_tpu_torch.cache.cache3d import Cache3DBase
from gen3c_tpu_torch.parallel import collectives
from gen3c_tpu_torch.parallel.mesh import Axis


def _pad(t: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([t, t[:, -1:].expand(t.shape[0], pad, *t.shape[2:])], dim=1) if pad else t


def sharded_render_cache(cache: Cache3DBase, axis: Axis, target_w2cs,
                         target_intrinsics) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cache.render_cache(target_w2cs, target_intrinsics)`` with the F
    target frames split over ``axis``: (pixels (1, F, N, C, H, W), masks
    (1, F, N, 1, H, W)) on every rank, as one process renders them (a
    ``Cache3DBuffer``'s noise augmentation, which gen3c_tpu's sharded
    render leaves out too, is not added)."""
    w2cs = torch.as_tensor(target_w2cs, dtype=torch.float32, device=cache.device)
    ks = torch.as_tensor(target_intrinsics, dtype=torch.float32, device=cache.device)
    B, F = w2cs.shape[:2]
    if B != 1:
        raise ValueError("the sharded render takes one batch entry")
    pad = (-F) % axis.size
    w2cs, ks = _pad(w2cs, pad), _pad(ks, pad)
    n = (F + pad) // axis.size
    lo = axis.rank * n
    px, mk = Cache3DBase.render_cache(cache, w2cs[:, lo:lo + n], ks[:, lo:lo + n],
                                      start_frame_idx=lo)
    if axis.size > 1:
        px, mk = (collectives.all_gather(t, 1, axis) for t in (px, mk))
    return px[:, :F].contiguous(), mk[:, :F].contiguous()
