"""gen3c_tpu_torch: the PyTorch + CUDA port of gen3c_tpu for NVIDIA Hopper.

Mirrors the layout of ``gen3c_tpu`` (``ops/``, ``cache/``, ``models/``,
``diffusion/``, ``pipelines/``), which stays the reference it is tested
against. Plain tensor code is PyTorch; the kernels that ``gen3c_tpu`` ran
through Pallas (and the splat it ran as a sort-based stand-in) are
hand-written CUDA in ``kernels/``. This package never imports JAX, nor
any module of ``gen3c_tpu``.

Covered so far, on one device: single-image GEN3C generation (the exact
path and the ``--perf_preset fast`` path) through
``pipelines.gen3c_single_image``, and DiT training (full-state or LoRA,
full or band attention, synthetic latents or packaged RGBD clips) through
``training.train``.
"""

__version__ = "0.1.0"
