"""Context-, CFG-, data-, tensor- and sequence-parallel denoising and
training over ``torch.distributed`` (port of gen3c_tpu/parallel/{mesh,cp,
sharding}.py and the shardings of gen3c_tpu/training/train_step.py): one
process per rank, as the reference's ``torchrun --nproc_per_node N``.
FSDP (``sharding.shard_fsdp``), the AR transformer under tensor
parallelism (``sharding.shard_ar_params``), GPipe pipeline parallelism
(``pp``) and sharded cache renders (``cache_sharding``) are ported too;
serving over several cards is ``serving.models.Gen3cPersistentModel``'s."""

from gen3c_tpu_torch.parallel.mesh import (
    Axis,
    Groups,
    make_groups,
    maybe_distributed_init,
    pp_axis,
)

__all__ = ["Axis", "Groups", "make_groups", "maybe_distributed_init", "pp_axis"]
