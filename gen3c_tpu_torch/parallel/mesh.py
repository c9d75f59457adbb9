"""Process groups for parallel denoising and training (port of gen3c_tpu/parallel/mesh.py).

The JAX package lays its devices out as one (dp, cfg, cp, tp) mesh:

  dp  — data parallel (the training batch split across replicas)
  cfg — CFG parallel (size 2: the conditioned and unconditioned forwards
        run on different ranks, one sum per denoise step combines them)
  cp  — context parallel (latent-T / token sharding in the denoiser)
  tp  — tensor parallel (Megatron column / row shards of the DiT's linears,
        ``parallel.sharding``; with sequence parallelism also the tokens
        between them)

Here every device is a process, a rank of ``torch.distributed`` as
``torchrun`` starts them, and each mesh axis is a process group. Ranks
follow the mesh's row-major order, tp fastest: rank = ((dp_index * cfg +
cfg_index) * cp + cp_index) * tp + tp_index. ``maybe_distributed_init``
joins the job torchrun describes; ``make_groups`` replaces ``make_mesh``.
Pipeline parallelism (``parallel.pp``) runs on a plain axis of its own,
``pp_axis``: gen3c_tpu builds ``Mesh(devices, ("pp",))`` for it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group (None for a
    size-1 axis), this rank's index along it and its size."""

    group: Optional[dist.ProcessGroup] = None
    rank: int = 0
    size: int = 1


@dataclasses.dataclass(frozen=True)
class Groups:
    """The dp, cfg, cp and tp axes of this rank (``make_groups``), ``world``:
    every rank of the mesh, and ``shard_peers``: the ranks that hold this
    rank's tp shard, over which a sharded leaf's gradient and the loss are
    summed (dp x cfg x cp at its tp index: the world at tp 1)."""

    cfg: Axis = Axis()
    cp: Axis = Axis()
    dp: Axis = Axis()
    world: Axis = Axis()
    tp: Axis = Axis()
    shard_peers: Axis = Axis()

    @property
    def parallel(self) -> bool:
        return any(a.size > 1 for a in (self.cfg, self.cp, self.dp, self.world, self.tp))


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
    """The dp, cfg, cp and tp process groups of a (dp, cfg, cp, tp) mesh
    over the ranks of the default process group, and this rank's place in
    each.

    cp None takes every rank dp * cfg * tp leave (gen3c_tpu's
    ``make_mesh``). backend names the groups' backend (default: the
    default group's); a caller may ask for gloo on CUDA tensors, whose
    collectives then pass through host memory (``collectives``). The world
    size must be dp * cfg * cp * tp. Every rank must call this with the
    same arguments (``dist.new_group``)."""
    if cfg not in (1, 2):
        raise ValueError(f"cfg axis must be 1 or 2, got {cfg}")
    if dp < 1 or tp < 1:
        raise ValueError(f"dp and tp must be >= 1, got dp={dp}, tp={tp}")
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if cp is None:
        if world % (dp * cfg * tp):
            raise ValueError(f"dp*cfg*tp = {dp * cfg * tp} does not divide the ranks: the "
                             f"world size is {world}")
        cp = world // (dp * cfg * tp)
    if cp < 1:
        raise ValueError(f"cp must be >= 1, got {cp}")
    if dp * cfg * cp * tp != world:
        raise ValueError(f"dp*cfg*cp*tp = {dp * cfg * cp * tp} ranks, but the world size is "
                         f"{world}")
    if world == 1:
        return Groups()
    rank = dist.get_rank()
    rest, tp_i = divmod(rank, tp)
    dp_i, rest = divmod(rest, cfg * cp)
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

    def at(d, c, j, k=0):
        return ((d * cfg + c) * cp + j) * tp + k

    cells = [(d, c, j) for d in range(dp) for c in range(cfg) for j in range(cp)]
    cp_axis = cfg_axis = dp_axis = tp_axis = shard_peers = Axis()
    if cp > 1:
        cp_axis = axis([[at(d, c, j, k) for j in range(cp)] for d in range(dp)
                        for c in range(cfg) for k in range(tp)], cp_i, cp)
    if cfg > 1:
        cfg_axis = axis([[at(d, c, j, k) for c in range(cfg)] for d in range(dp)
                         for j in range(cp) for k in range(tp)], cfg_i, cfg)
    if dp > 1:
        dp_axis = axis([[at(d, c, j, k) for d in range(dp)] for c in range(cfg)
                        for j in range(cp) for k in range(tp)], dp_i, dp)
    if tp > 1:
        tp_axis = axis([[at(*cell, k) for k in range(tp)] for cell in cells], tp_i, tp)
        if len(cells) > 1:  # else this rank alone holds its shard
            shard_peers = axis([[at(*cell, k) for cell in cells] for k in range(tp)],
                               (dp_i * cfg + cfg_i) * cp + cp_i, len(cells))
    world_axis = axis([list(range(world))], rank, world)
    if tp == 1:
        shard_peers = world_axis
    return Groups(cfg_axis, cp_axis, dp_axis, world_axis, tp_axis, shard_peers)


def pp_axis(backend: Optional[str] = None) -> Axis:
    """A pipeline axis over every rank of the default process group, stage
    s = rank s (gen3c_tpu's ``Mesh(devices, ("pp",))``); one rank: a
    size-1 axis. Every rank must call this (``dist.new_group``)."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world == 1:
        return Axis()
    return Axis(dist.new_group(list(range(world)), backend=backend), dist.get_rank(), world)
