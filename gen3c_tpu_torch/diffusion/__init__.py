"""EDM schedule and sampler (port of gen3c_tpu/diffusion)."""
