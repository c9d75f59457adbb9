"""Process groups for parallel denoising and training (port of gen3c_tpu/parallel/mesh.py).

The JAX package lays its devices out as one (dp, cfg, cp, tp) mesh:

  dp  — data parallel (the training batch split across replicas)
  cfg — CFG parallel (size 2: the conditioned and unconditioned forwards
        run on different ranks, one sum per denoise step combines them)
  cp  — context parallel (latent-T / token sharding in the denoiser)
  tp  — tensor parallel (not ported: ROADMAP item 15b)

Here every device is a process, a rank of ``torch.distributed`` as
``torchrun`` starts them, and each mesh axis is a process group. Ranks
follow the mesh's row-major order: rank = (dp_index * cfg + cfg_index) *
cp + cp_index (tp is 1). ``maybe_distributed_init`` joins the job torchrun
describes; ``make_groups`` replaces ``make_mesh``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

ITEM_15B = "ROADMAP item 15b"  # tensor and sequence parallelism
ITEM_15C = "ROADMAP item 15c"  # pipeline parallelism, sharded renders, FSDP
ITEM_15D = "ROADMAP item 15d"  # serving over several cards


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group (None for a
    size-1 axis), this rank's index along it and its size."""

    group: Optional[dist.ProcessGroup] = None
    rank: int = 0
    size: int = 1


@dataclasses.dataclass(frozen=True)
class Groups:
    """The dp, cfg and cp axes of this rank (``make_groups``), and ``world``:
    every rank of the mesh (the ranks a training step's gradients are
    summed over)."""

    cfg: Axis = Axis()
    cp: Axis = Axis()
    dp: Axis = Axis()
    world: Axis = Axis()

    @property
    def parallel(self) -> bool:
        return any(a.size > 1 for a in (self.cfg, self.cp, self.dp, self.world))


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


def make_groups(dp: int = 1, cfg: int = 1, cp: Optional[int] = 1, tp: int = 1,
                backend: Optional[str] = None) -> Groups:
    """The dp, cfg and cp process groups of a (dp, cfg, cp, tp) mesh over
    the ranks of the default process group, and this rank's place in each.

    cp None takes every rank dp * cfg leave (gen3c_tpu's ``make_mesh``).
    backend names the groups' backend (default: the default group's); a
    caller may ask for gloo on CUDA tensors, whose collectives then pass
    through host memory (``collectives``). The world size must be dp * cfg
    * cp; tp > 1 raises NotImplementedError (ROADMAP item 15b). Every rank
    must call this with the same arguments (``dist.new_group``)."""
    if tp != 1:
        raise NotImplementedError(
            f"tensor parallelism (tp={tp}) is not ported to gen3c_tpu_torch yet ({ITEM_15B})")
    if cfg not in (1, 2):
        raise ValueError(f"cfg axis must be 1 or 2, got {cfg}")
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if cp is None:
        if world % (dp * cfg):
            raise ValueError(f"dp*cfg = {dp * cfg} does not divide the ranks: the world size "
                             f"is {world}")
        cp = world // (dp * cfg)
    if cp < 1:
        raise ValueError(f"cp must be >= 1, got {cp}")
    if dp * cfg * cp != world:
        raise ValueError(f"dp*cfg*cp = {dp * cfg * cp} ranks, but the world size is {world}")
    if world == 1:
        return Groups()
    rank = dist.get_rank()
    dp_i, rest = divmod(rank, cfg * cp)
    cfg_i, cp_i = divmod(rest, cp)

    def axis(members, index, size):
        """Every rank creates every group of an axis, in the same order, as
        new_group asks; this rank keeps the one it is in."""
        mine = Axis()
        for ranks in members:
            group = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                mine = Axis(group, index, size)
        return mine

    def at(d, c, j):
        return (d * cfg + c) * cp + j

    cp_axis = cfg_axis = dp_axis = Axis()
    if cp > 1:
        cp_axis = axis([[at(d, c, j) for j in range(cp)] for d in range(dp) for c in range(cfg)],
                       cp_i, cp)
    if cfg > 1:
        cfg_axis = axis([[at(d, c, j) for c in range(cfg)] for d in range(dp) for j in range(cp)],
                        cfg_i, cfg)
    if dp > 1:
        dp_axis = axis([[at(d, c, j) for d in range(dp)] for c in range(cfg) for j in range(cp)],
                       dp_i, dp)
    world_axis = axis([list(range(world))], rank, world)
    return Groups(cfg_axis, cp_axis, dp_axis, world_axis)
