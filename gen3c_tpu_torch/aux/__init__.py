"""Auxiliary models of the GEN3C pipelines (port of gen3c_tpu/aux/): MoGe depth."""
