"""Networks: DiT, VAE, conditioner, GEN3C wrapper (port of gen3c_tpu/models)."""
