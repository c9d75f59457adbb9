"""Process groups for parallel denoising (port of gen3c_tpu/parallel/mesh.py).

The JAX package lays its devices out as one (dp, cfg, cp, tp) mesh:

  cfg — CFG parallel (size 2: the conditioned and unconditioned forwards
        run on different ranks, one sum per denoise step combines them)
  cp  — context parallel (latent-T / token sharding in the denoiser)

Here every device is a process, a rank of ``torch.distributed`` as
``torchrun`` starts them, and each mesh axis is a process group. Ranks
follow the mesh's row-major order: rank = cfg_index * cp + cp_index (dp and
tp, not ported, are 1). ``maybe_distributed_init`` joins the job torchrun
describes; ``make_groups`` replaces ``make_mesh``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

ITEM_15 = "ROADMAP item 15"


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group (None for a
    size-1 axis), this rank's index along it and its size."""

    group: Optional[dist.ProcessGroup] = None
    rank: int = 0
    size: int = 1


@dataclasses.dataclass(frozen=True)
class Groups:
    """The cfg and cp axes of this rank (``make_groups``)."""

    cfg: Axis = Axis()
    cp: Axis = Axis()

    @property
    def parallel(self) -> bool:
        return self.cfg.size > 1 or self.cp.size > 1


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's index on its host ($LOCAL_RANK, as torchrun sets it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def process_rank() -> int:
    """This process's global rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def maybe_distributed_init(backend: Optional[str] = None, device="cuda") -> bool:
    """Join the job that ``torchrun`` describes in the environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) with ``backend`` (default: NCCL
    for a CUDA device, gloo for the CPU). Returns True when the default
    process group exists (it may already have), False in a single process
    (no WORLD_SIZE, or 1). gen3c_tpu/parallel/mesh.py's
    ``maybe_distributed_init``."""
    if not dist.is_available():
        return False
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    dist.init_process_group(backend or default_backend(device),
                            init_method=f"tcp://{addr}:{port}",
                            rank=int(os.environ["RANK"]), world_size=world)
    return True


def make_groups(dp: int = 1, cfg: int = 1, cp: int = 1, tp: int = 1,
                backend: Optional[str] = None) -> Groups:
    """The cfg and cp process groups of a (dp, cfg, cp, tp) mesh over the
    ranks of the default process group, and this rank's place in each.

    backend names the groups' backend (default: the default group's); a
    caller may ask for gloo on CUDA tensors, whose collectives then pass
    through host memory (``collectives``). The world size must be cfg * cp;
    dp > 1 or tp > 1 raise NotImplementedError (ROADMAP item 15). Every
    rank must call this with the same arguments (``dist.new_group``)."""
    if dp != 1 or tp != 1:
        raise NotImplementedError(
            f"data and tensor parallelism (dp={dp}, tp={tp}) are not ported to "
            f"gen3c_tpu_torch yet ({ITEM_15})")
    if cfg not in (1, 2):
        raise ValueError(f"cfg axis must be 1 or 2, got {cfg}")
    if cp < 1:
        raise ValueError(f"cp must be >= 1, got {cp}")
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if cfg * cp != world:
        raise ValueError(f"cfg*cp = {cfg * cp} ranks, but the world size is {world}")
    if world == 1:
        return Groups()
    cfg_i, cp_i = divmod(dist.get_rank(), cp)
    cfg_axis = cp_axis = Axis()
    # every rank creates every group, in the same order, as new_group asks
    if cp > 1:
        for c in range(cfg):
            group = dist.new_group([c * cp + j for j in range(cp)], backend=backend)
            if c == cfg_i:
                cp_axis = Axis(group, cp_i, cp)
    if cfg > 1:
        for j in range(cp):
            group = dist.new_group([c * cp + j for c in range(cfg)], backend=backend)
            if j == cp_i:
                cfg_axis = Axis(group, cfg_i, cfg)
    return Groups(cfg_axis, cp_axis)
