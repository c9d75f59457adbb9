"""Generation pipelines (port of gen3c_tpu/pipelines)."""
