"""Context- and CFG-parallel denoising over ``torch.distributed`` (port of
gen3c_tpu/parallel/{mesh,cp}.py): one process per rank, as the reference's
``torchrun --nproc_per_node N``. Tensor, sequence and pipeline parallelism,
``cache_sharding.py`` and FSDP are not ported (ROADMAP item 15)."""

from gen3c_tpu_torch.parallel.mesh import Axis, Groups, make_groups, maybe_distributed_init

__all__ = ["Axis", "Groups", "make_groups", "maybe_distributed_init"]
