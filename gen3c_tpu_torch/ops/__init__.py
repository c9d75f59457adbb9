"""Camera and geometry ops (port of gen3c_tpu/ops)."""
