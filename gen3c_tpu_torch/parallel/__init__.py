"""Context-, CFG- and data-parallel denoising and training over
``torch.distributed`` (port of gen3c_tpu/parallel/{mesh,cp}.py and the
dp / cp shardings of gen3c_tpu/training/train_step.py): one process per
rank, as the reference's ``torchrun --nproc_per_node N``. Tensor and
sequence parallelism (ROADMAP item 15b), pipeline parallelism,
``cache_sharding.py`` and FSDP (15c) are not ported."""

from gen3c_tpu_torch.parallel.mesh import Axis, Groups, make_groups, maybe_distributed_init

__all__ = ["Axis", "Groups", "make_groups", "maybe_distributed_init"]
