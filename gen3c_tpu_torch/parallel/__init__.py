"""Context-, CFG-, data-, tensor- and sequence-parallel denoising and
training over ``torch.distributed`` (port of gen3c_tpu/parallel/{mesh,cp,
sharding}.py and the shardings of gen3c_tpu/training/train_step.py): one
process per rank, as the reference's ``torchrun --nproc_per_node N``.
Pipeline parallelism, ``cache_sharding.py`` and FSDP (ROADMAP item 15c)
and the AR transformer's tensor parallelism (15b-ar) are not ported."""

from gen3c_tpu_torch.parallel.mesh import Axis, Groups, make_groups, maybe_distributed_init

__all__ = ["Axis", "Groups", "make_groups", "maybe_distributed_init"]
