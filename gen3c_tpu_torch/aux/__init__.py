"""Auxiliary models of the GEN3C pipelines (port of gen3c_tpu/aux/): MoGe depth,
the guardrails (the blocklist, Llama-Guard-3, Aegis, the SigLIP video filter,
the RetinaFace face blur) and the prompt upsamplers (the Pixtral VLM)."""
