"""gen3c_tpu_torch: the PyTorch + CUDA port of gen3c_tpu for NVIDIA Hopper.

Mirrors the layout of ``gen3c_tpu`` (``ops/``, ``cache/``, ``models/``,
``diffusion/``, ``pipelines/``), which stays the reference it is tested
against. Plain tensor code is PyTorch; the kernels that ``gen3c_tpu`` ran
through Pallas (and the splat it ran as a sort-based stand-in) are
hand-written CUDA in ``kernels/``. This package never imports JAX.

Covered so far: single-image GEN3C generation (the exact path: Euler
solver, batched CFG, no step caching, single device) through
``pipelines.gen3c_single_image``.
"""

__version__ = "0.1.0"
