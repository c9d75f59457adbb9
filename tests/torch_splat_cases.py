"""Seeded numpy inputs of the splat (K5) shared by the CPU tests (against
gen3c_tpu) and the cuda tests (the kernel against its plain version). No
jax here: the cuda tests run where jax is absent."""

import numpy as np


def splat_inputs(rng, b, c, h, w, integer_flow=False, with_masks=True):
    """frame (b, c, h, w) in [-1, 1], mask, depth (some <= 0), flow (b, 2, h,
    w) reaching past every border (or whole-pixel shifts), flow_mask."""
    frame = rng.uniform(-1, 1, (b, c, h, w)).astype(np.float32)
    if integer_flow:
        # whole-pixel shifts: floor == ceil at every target
        flow = rng.integers(-3, 4, (b, 2, h, w)).astype(np.float32)
    else:
        # reaches past every border, so some points fall off the grid
        flow = rng.uniform(-0.6 * w, 0.6 * w, (b, 2, h, w)).astype(np.float32)
    depth = rng.uniform(-0.5, 4.0, (b, 1, h, w)).astype(np.float32)  # some <= 0
    depth[0, 0, :2] = 0.0
    mask = (rng.uniform(size=(b, 1, h, w)) > 0.2).astype(np.float32) if with_masks else None
    fmask = (rng.uniform(size=(b, 1, h, w)) > 0.1).astype(np.float32) if with_masks else None
    return frame, mask, depth, flow, fmask


def nonfinite_splat_inputs():
    """Two 12x17 buffers, a NaN depth in buffer 0 and a +inf depth in buffer
    1 (whose pixel lands inside the grid); each buffer is its own group."""
    frame, mask, depth, flow, fmask = splat_inputs(np.random.default_rng(7), 2, 3, 12, 17)
    depth[0, 0, 5, 6] = np.nan
    depth[1, 0, 7, 3] = np.inf
    flow[1, :, 7, 3] = 0.25
    mask[1, 0, 7, 3] = fmask[1, 0, 7, 3] = 1.0
    return frame, mask, depth, flow, fmask
