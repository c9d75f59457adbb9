"""CPU ranks for the port's context-parallel tests.

``Ranks(world)`` spawns ``world`` processes joined by one gloo process
group, each a rank as ``torchrun`` would start it; ``run(task, **kw)`` runs
one of this module's tasks on every rank with the same (numpy) arguments
and returns the ranks' results in rank order. A pool serves several
tests, so that the processes start once. The tasks import torch and
gen3c_tpu_torch only.

A task whose axes span fewer ranks than the pool has runs as replicas:
with 4 ranks and cfg * cp = 2, ranks {0, 1} and {2, 3} each run it on
groups of their own (the layout ``mesh.make_groups`` gives 2 ranks).
"""

from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import numpy as np

TIMEOUT_S = 120  # a collective that waits longer than this fails the task


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _loop(rank: int, world: int, port: int, tasks, results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    while True:
        item = tasks.get()
        if item is None:
            break
        name, kw = item
        try:
            results.put((rank, True, globals()[name](rank, world, **kw)))
        except BaseException:  # noqa: BLE001 - sent back to the test as its failure
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class Ranks:
    def __init__(self, world: int):
        ctx = mp.get_context("spawn")
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        port = _free_port()
        self.procs = [ctx.Process(target=_loop, args=(r, world, port, self.tasks[r], self.results),
                                  daemon=True) for r in range(world)]
        for proc in self.procs:
            proc.start()

    def submit(self, task: str, **kw) -> None:
        for q in self.tasks:
            q.put((task, kw))

    def collect(self, timeout: float = 2 * TIMEOUT_S) -> list:
        got = {}
        while len(got) < self.world:
            try:
                rank, ok, payload = self.results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(self.world)) - set(got))} gave no "
                                   f"result in {timeout} s") from None
            got[rank] = (ok, payload)
        failed = [f"rank {r}:\n{p}" for r, (ok, p) in sorted(got.items()) if not ok]
        if failed:
            raise RuntimeError("\n".join(failed))
        return [got[r][1] for r in range(self.world)]

    def run(self, task: str, **kw) -> list:
        self.submit(task, **kw)
        return self.collect()

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for proc in self.procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()


# ------------------------------ tasks ------------------------------

_LAYOUTS = {}
_NETS = {}


def layout_groups(rank: int, world: int, dp: int = 1, cfg: int = 1, cp: int = 1, tp: int = 1):
    """This rank's Groups of a (dp, cfg, cp, tp) mesh: ``make_groups`` when
    it spans the pool, else its replica's, laid out as make_groups lays out
    dp * cfg * cp * tp ranks (tp fastest) from the replica's first rank;
    every rank creates every group, in one order, as new_group asks."""
    import torch.distributed as dist

    from gen3c_tpu_torch.parallel.mesh import Axis, Groups, make_groups

    key = (dp, cfg, cp, tp)
    if key not in _LAYOUTS:
        n = dp * cfg * cp * tp
        if n == world:
            _LAYOUTS[key] = make_groups(dp=dp, cfg=cfg, cp=cp, tp=tp, backend="gloo")
        else:
            cells = [(d, c, j) for d in range(dp) for c in range(cfg) for j in range(cp)]
            axes = {}
            for base in range(0, world, n):
                def at(d, c, j, k, base=base):
                    return base + ((d * cfg + c) * cp + j) * tp + k

                members = []
                if cp > 1:
                    members += [("cp", [at(d, c, j, k) for j in range(cp)]) for d in range(dp)
                                for c in range(cfg) for k in range(tp)]
                if cfg > 1:
                    members += [("cfg", [at(d, c, j, k) for c in range(cfg)]) for d in range(dp)
                                for j in range(cp) for k in range(tp)]
                if dp > 1:
                    members += [("dp", [at(d, c, j, k) for d in range(dp)]) for c in range(cfg)
                                for j in range(cp) for k in range(tp)]
                if tp > 1:
                    members += [("tp", [at(*cell, k) for k in range(tp)]) for cell in cells]
                    if len(cells) > 1:
                        members += [("shard_peers", [at(*cell, k) for cell in cells])
                                    for k in range(tp)]
                members.append(("world", list(range(base, base + n))))
                for name, ranks in members:
                    g = dist.new_group(ranks, backend="gloo")
                    if rank in ranks:
                        axes[name] = Axis(g, ranks.index(rank), len(ranks))
            _LAYOUTS[key] = Groups(
                cfg=axes.get("cfg", Axis()), cp=axes.get("cp", Axis()), dp=axes.get("dp", Axis()),
                world=axes["world"], tp=axes.get("tp", Axis()),
                shard_peers=axes.get("shard_peers", Axis()) if tp > 1 else axes["world"])
    return _LAYOUTS[key]


def _net(dit_kw: dict, state: dict, groups=None, min_size=None):
    """The fp32 GeneralDIT of ``dit_kw`` with ``state`` (numpy), quantized
    (``quantize_dit_(min_size=)``) when min_size is given and cut to this
    rank's tp shards (``shard_params``) over a tp axis of ``groups``;
    cached by its config, min_size and tp place (each test sends the same
    state with it)."""
    import torch

    from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT
    from gen3c_tpu_torch.models.quantize import quantize_dit_
    from gen3c_tpu_torch.parallel.sharding import shard_params

    tp = None if groups is None else groups.tp
    key = (tuple(sorted(dit_kw.items())), min_size, None if tp is None else (tp.size, tp.rank))
    if key not in _NETS:
        net = GeneralDIT(DiTConfig(dtype=torch.float32, **dit_kw))
        net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
        if min_size is not None:
            quantize_dit_(net, min_size=min_size)
        if groups is not None:
            shard_params(net, groups)
        _NETS[key] = net
    return _NETS[key]


def attention(rank, world, cp: int, impl: str, q, k, v, band=None) -> dict:
    """models.dit.cp_self_attention on this rank's shard of q/k/v
    (B, L, H, D): its output shard, its index on the cp axis and the ring
    steps it folded and skipped."""
    import torch

    from gen3c_tpu_torch.models import dit

    axis = layout_groups(rank, world, cp=cp).cp
    n = q.shape[1] // cp
    sl = slice(axis.rank * n, (axis.rank + 1) * n)
    dit.ring_steps.update(folded=0, skipped=0)
    with torch.no_grad():
        out = dit.cp_self_attention(*(torch.from_numpy(np.ascontiguousarray(t[:, sl]))
                                      for t in (q, k, v)), axis, impl, band)
    return {"out": out.numpy(), "cp_rank": axis.rank, "ring_steps": dict(dit.ring_steps)}


def forward(rank, world, cp: int, dit_kw: dict, state: dict, x, t, ctx, tp: int = 1,
            sp: bool = False, min_size=None) -> dict:
    """GeneralDIT.forward(cp=, tp=, sp=) on this rank's latent-T shard of x
    (the net quantized with min_size when given, then cut to this rank's tp
    shards): its output, its places and the leaves it holds a shard of."""
    import torch

    from gen3c_tpu_torch.parallel.sharding import sharded_leaves

    groups = layout_groups(rank, world, cp=cp, tp=tp)
    net = _net(dit_kw, state, groups if tp > 1 else None, min_size)
    n = x.shape[2] // cp
    xs = np.ascontiguousarray(x[:, :, groups.cp.rank * n:(groups.cp.rank + 1) * n])
    with torch.no_grad():
        out = net(torch.from_numpy(xs), torch.from_numpy(t), torch.from_numpy(ctx), fps=24.0,
                  cp=groups.cp if cp > 1 else None, tp=groups.tp if tp > 1 else None, sp=sp)
    return {"out": out.numpy(), "cp_rank": groups.cp.rank, "tp_rank": groups.tp.rank,
            "sharded": sorted(sharded_leaves(net))}


def sample(rank, world, cfg: int, cp: int, dit_kw: dict, state: dict, arrays: dict,
           opts: dict, tp: int = 1, sp: bool = False) -> np.ndarray:
    """parallel.cp.cp_generate_samples over a (cfg, cp, tp) layout (sp:
    sequence parallelism): the whole final latent as this rank returns it."""
    import torch

    from gen3c_tpu_torch.parallel.cp import cp_generate_samples

    groups = layout_groups(rank, world, cfg=cfg, cp=cp, tp=tp)
    net = _net(dit_kw, state, groups if tp > 1 else None)
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return cp_generate_samples(groups, net, sequence_parallel=sp, **tensors, **opts).numpy()


def mv_forward(rank, world, tp: int, x, t, ctx) -> dict:
    """A tiny multiview net (tests/test_torch_multiview_world.py's TINY_MV,
    seeded, its gates randomized) whole and cut to this rank's tp shards:
    both forwards, the sharded one through GeneralDIT's blocks under tp."""
    import torch

    from gen3c_tpu_torch.models.dit_multiview import MultiviewDiTConfig
    from gen3c_tpu_torch.parallel.sharding import shard_params, sharded_leaves
    from gen3c_tpu_torch.training.train import build_net

    cfg = MultiviewDiTConfig(max_img_h=16, max_img_w=16, max_frames=8, in_channels=16,
                             out_channels=16, model_channels=96, num_blocks=2, num_heads=4,
                             crossattn_emb_channels=32, adaln_lora_dim=8, n_views=3,
                             view_condition_dim=4, add_repeat_frame_embedding=True,
                             dtype=torch.float32)
    net = build_net(cfg, "cpu", seed=3)
    net.randomize_degenerate_inits(torch.Generator().manual_seed(9))
    groups = layout_groups(rank, world, tp=tp)
    args = [torch.from_numpy(a) for a in (x, t, ctx)]
    with torch.no_grad():
        whole = net(*args, fps=24.0).numpy()
        shard_params(net, groups)
        out = net(*args, fps=24.0, tp=groups.tp).numpy()
    return {"whole": whole, "out": out, "sharded": len(sharded_leaves(net))}


def build(rank, world, parallel: str, quantize=False) -> dict:
    """pipelines.factory.build_gen3c_model("gen3c_tiny", parallel=) over the
    pool (gloo on the CPU): the groups' sizes, sequence parallelism, the
    rows of block 0's q projection and the leaves this rank holds a shard
    of."""
    from gen3c_tpu_torch.parallel.sharding import sharded_leaves
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model

    model, _ = build_gen3c_model("gen3c_tiny", device="cpu", num_devices=world,
                                 parallel=parallel, quantize=quantize, dist_backend="gloo")
    g = model.groups
    q = model.net.blocks.block0.blocks[0].block.attn.to_q[0].weight
    return {"cfg": g.cfg.size, "cp": g.cp.size, "tp": g.tp.size, "sp": model.sequence_parallel,
            "q_rows": q.shape[0], "sharded": len(sharded_leaves(model.net))}


def relayout(rank, world, strategies: list) -> list:
    """build_gen3c_model("gen3c_tiny", parallel="cp") over the pool, then
    pipelines.factory.parallelize by each strategy in turn: per strategy
    the groups' sizes, sequence parallelism, the rows of block 0's q
    projection and whether they equal a fresh build's by that strategy;
    or the ValueError it raised."""
    import torch

    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model, parallelize

    def q(m):
        return m.net.blocks.block0.blocks[0].block.attn.to_q[0].weight

    model, _ = build_gen3c_model("gen3c_tiny", device="cpu", num_devices=world,
                                 parallel="cp", dist_backend="gloo")
    out = []
    for parallel in strategies:
        try:
            g = parallelize(model, parallel, world, backend="gloo")
        except ValueError as e:
            out.append({"error": str(e)})
            continue
        fresh, _ = build_gen3c_model("gen3c_tiny", device="cpu", num_devices=world,
                                     parallel=parallel, dist_backend="gloo")
        out.append({"cfg": g.cfg.size, "cp": g.cp.size, "tp": g.tp.size,
                    "sp": model.sequence_parallel, "q_rows": q(model).shape[0],
                    "as_fresh": bool(torch.equal(q(model), q(fresh)))})
    return out


# ------------------------------ training over a (dp, cp, tp) mesh ------------------------------

def train_module(kind: str, state: dict, logvar: bool):
    """The fp32 module a training test trains: the tiny GEN3C DiT or the tiny
    action DiT (``kind`` "gen3c" / "action"), with the logvar head when
    ``logvar``; its parameters from ``state`` (numpy, port names)."""
    import torch

    from gen3c_tpu_torch.models.dit import GeneralDIT
    from gen3c_tpu_torch.models.dit_action import ActionDiT
    from gen3c_tpu_torch.training.losses import LogvarHead
    from gen3c_tpu_torch.training.train_step import NetWithLogvar

    cfg = train_cfg(kind)
    net = ActionDiT(cfg) if kind == "action" else GeneralDIT(cfg)
    module = NetWithLogvar(net, LogvarHead()) if logvar else net
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return module


def train_cfg(kind: str):
    from gen3c_tpu_torch.pipelines.factory import GEN3C_TINY_PRESET
    from gen3c_tpu_torch.utils import registry

    if kind == "action":
        return registry.get_experiment("video2world_action_tiny").dit
    return GEN3C_TINY_PRESET.dit


def run_train_steps(groups, kind: str, state: dict, batches: list, draws: list, opt_kw: dict,
                    step_kw: dict, data_type: str = "video", fsdp: bool = False) -> dict:
    """Steps of the port's train step on ``batches`` with the injected global
    ``draws`` (dicts of numpy StepDraws fields): over ``groups`` through
    ``make_sharded_train_step`` (over a tp axis on the module's shards,
    ``shard_params``; with fsdp cut over dp too, ``shard_fsdp``), or on one
    device (groups None) through ``train_step``. Returns per-step loss,
    grad_norm, sigma_mean, the final params and first moments (numpy, port
    names; shards gathered) and the elements of this rank's params, first
    moments and EMA."""
    import torch

    from gen3c_tpu_torch.parallel import sharding
    from gen3c_tpu_torch.training import train_step as tts

    cfg = train_cfg(kind)
    module = train_module(kind, state, step_kw.get("loss_add_logvar", False))
    dims = {} if groups is None else sharding.shard_params(module, groups)
    cut = sharding.shard_fsdp(module, groups) if fsdp else {}
    opt = tts.make_optimizer(**opt_kw)
    st = tts.init_train_state(module, opt)
    if groups is not None:
        step = tts.make_sharded_train_step(groups, cfg, opt, data_type=data_type,
                                           fsdp_axis="dp" if fsdp else None, **step_kw)
    else:
        def step(s, b, rng, draws):
            return tts.train_step(s, b, rng, cfg, opt, data_type=data_type, draws=draws,
                                  **step_kw)
    out = {"loss": [], "grad_norm": [], "sigma_mean": []}
    for b, d in zip(batches, draws):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        td = tts.StepDraws(**{k: None if v is None else torch.from_numpy(np.asarray(v))
                              for k, v in d.items()})
        st, m = step(st, tb, None, draws=td)
        for k in out:
            out[k].append(float(m[k]))
    sd = st.state_dict()
    out["held"] = {part: sum(t.numel() for t in sd[part].values()) for part in ("params", "mu",
                                                                               "ema")}
    if dims or cut:
        sd = sharding.gather_to_host(sd, dims, groups.tp, True, cut, groups.dp)
    out["params"] = {n: p.numpy().copy() for n, p in sd["params"].items()}
    out["mu"] = {n: p.numpy().copy() for n, p in sd["mu"].items()}
    out["step"] = st.step
    out["sharded"] = sorted(dims)
    out["fsdp"] = sorted(cut)
    return out


def train(rank, world, dp: int, cp: int, tp: int = 1, **kw) -> dict:
    """``run_train_steps`` over this rank's (dp, cp, tp) mesh, plus its
    place."""
    groups = layout_groups(rank, world, dp=dp, cp=cp, tp=tp)
    out = run_train_steps(groups, **kw)
    out.update(dp_rank=groups.dp.rank, cp_rank=groups.cp.rank, tp_rank=groups.tp.rank,
               world_rank=groups.world.rank)
    return out


def trainer_run(rank, world, dp: int, tp: int, job_dir: str, max_iter: int,
                fsdp: bool = False) -> dict:
    """``Trainer`` over this rank's (dp, tp) mesh (fsdp: with FSDP) on the
    tiny GEN3C DiT (seeded, ``train.build_net``) and the synthetic stream,
    up to ``max_iter`` steps, resuming from ``job_dir``'s latest
    checkpoint (a replica after the first: ``<job_dir>_replica<i>``): the
    step it reached and its parameters in the one-device form."""
    import dataclasses

    from gen3c_tpu_torch.parallel import sharding
    from gen3c_tpu_torch.training.train import build_net
    from gen3c_tpu_torch.training.trainer import Trainer

    groups = layout_groups(rank, world, dp=dp, tp=tp)
    replica = rank // (dp * tp)
    if replica:  # a replica of its own writes a job of its own
        job_dir = f"{job_dir}_replica{replica}"
    cfg = train_cfg("gen3c")
    config = dataclasses.replace(trainer_config(job_dir, max_iter), fsdp=fsdp)
    trainer = Trainer(config, cfg, build_net(cfg, "cpu", 0), groups=groups)
    state = trainer.train(trainer_data())
    params = {n: p.detach() for n, p in state.named_params().items()}
    if trainer.shard_dims or trainer.fsdp_dims:
        params = sharding.gather_to_host(params, trainer.shard_dims, groups.tp, True,
                                         trainer.fsdp_dims, groups.dp)
    return {"step": state.step, "params": {n: p.numpy().copy() for n, p in params.items()},
            "sharded": len(trainer.shard_dims), "fsdp": len(trainer.fsdp_dims)}


def save_gather(rank, world, dp: int, tp: int, fsdp: bool = False) -> dict:
    """``sharding.gather_to_host`` (Trainer's checkpoint gather) of a train
    state cut over this rank's (dp, tp) mesh from a one-device state whose
    moments are drawn at random, with every all-gather's output watched:
    how many earlier ones were still alive at each gather, the gathers
    made, whether the host state (where this rank writes, world rank 0;
    else None) equals the one-device state bit for bit, and whether every
    host tensor lies in host memory and is no view of the state."""
    import weakref

    import torch

    from gen3c_tpu_torch.parallel import collectives, sharding
    from gen3c_tpu_torch.training.train import build_net
    from gen3c_tpu_torch.training.train_step import init_train_state, make_optimizer

    groups = layout_groups(rank, world, dp=dp, tp=tp)
    parts = ("params", "mu", "nu", "ema")
    whole = init_train_state(build_net(train_cfg("gen3c"), "cpu", 0), make_optimizer())
    gen = torch.Generator().manual_seed(0)
    for part in (whole.opt_state.mu, whole.opt_state.nu):
        for t in part.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    net = build_net(train_cfg("gen3c"), "cpu", 0)
    dims = sharding.shard_params(net, groups)
    cut = sharding.shard_fsdp(net, groups) if fsdp else {}
    state = init_train_state(net, make_optimizer())
    for mine, one in ((state.opt_state.mu, whole.opt_state.mu),
                      (state.opt_state.nu, whole.opt_state.nu)):
        for n, t in sharding.shard_tensors(one, dims, groups.tp, cut, groups.dp).items():
            mine[n].copy_(t)
    sd = state.state_dict()
    buffers, alive_at_gather = [], []
    real = collectives.all_gather

    def watched(x, dim, axis):
        # a copy of the gather (its strides kept) that only the caller holds:
        # gloo's work may hold the receive buffer a moment after it returns
        alive_at_gather.append(sum(ref() is not None for ref in buffers))
        out = real(x, dim, axis).clone()
        buffers.append(weakref.ref(out))
        return out

    keep = groups.world.rank == 0
    collectives.all_gather = watched
    try:
        host = sharding.gather_to_host(sd, dims, groups.tp, keep, cut, groups.dp)
    finally:
        collectives.all_gather = real
    equal = on_host = None
    if keep:
        one = whole.state_dict()
        equal = all(set(host[k]) == set(one[k]) and all(torch.equal(host[k][n], one[k][n])
                                                       for n in one[k]) for k in parts) \
            and host["step"] == sd["step"] and host["count"] == sd["count"]
        live = {t.data_ptr() for k in parts for t in sd[k].values()}
        on_host = all(t.device.type == "cpu" and t.is_contiguous()
                      and t.data_ptr() not in live for k in parts for t in host[k].values())
    return {"alive_at_gather": max(alive_at_gather), "gathers": len(alive_at_gather),
            "sharded": len(dims), "fsdp": len(cut), "host_none": host is None, "equal": equal,
            "on_host": on_host}


def trainer_config(job_dir: str, max_iter: int):
    """The checkpoint test's TrainerConfig: a save a step, warmup 1, no
    prefetch thread."""
    from gen3c_tpu_torch.training.trainer import TrainerConfig

    return TrainerConfig(job_dir=job_dir, max_iter=max_iter, save_every=1, warmup_steps=1,
                         prefetch_batches=0, lr=1e-3, text_dropout_rate=0.3)


def trainer_data():
    """The checkpoint test's batches: 2 synthetic clips of 2 latent frames."""
    from gen3c_tpu_torch.training.trainer import synthetic_latent_dataset

    return synthetic_latent_dataset(2, 16, 2, 8, 12, extra_channels=train_cfg("gen3c").in_channels
                                    - 16)


def collective_gradcheck(rank, world, cp: int, op: str) -> bool:
    """torch.autograd.gradcheck (fp64) of one differentiable collective over
    a cp axis of the pool, as a function of every rank's input at once: each
    rank holds the same global input X (its shard X[r] goes in) and gathers
    the global output Y; the scaffolding's own adjoints (take: the shard's
    cotangent summed over the ranks; gather: the rank's chunk of the
    replicated cotangent) make F: X -> Y the same function on every rank, so
    gradcheck's numerical Jacobian (every rank perturbing the same element
    of X in step) and the analytic one (the collective's backward between
    the two) must agree."""
    import torch
    import torch.distributed as dist

    from gen3c_tpu_torch.parallel import collectives as coll

    axis = layout_groups(rank, world, cp=cp).cp
    n, r = axis.size, axis.rank

    class Take(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x[r].clone()

        @staticmethod
        def backward(ctx, g):
            full = torch.zeros((n,) + tuple(g.shape), dtype=g.dtype)
            full[r] = g
            dist.all_reduce(full, group=axis.group)
            return full

    class Gather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y):
            out = [torch.empty_like(y) for _ in range(n)]
            dist.all_gather(out, y.contiguous(), group=axis.group)
            return torch.stack(out)

        @staticmethod
        def backward(ctx, g):
            return g[r].clone()

    fns = {"seq_to_heads": lambda x: coll.seq_to_heads(x, axis),
           "heads_to_seq": lambda x: coll.heads_to_seq(x, axis),
           "all_gather": lambda x: coll.all_gather(x, 1, axis),
           "all_reduce": lambda x: coll.all_reduce(x, axis),
           "all_reduce_mean": lambda x: coll.all_reduce(x, axis, "mean"),
           "reduce_scatter": lambda x: coll.reduce_scatter(x, 2, axis),
           # the tensor-parallel operators' adjoints hold where their inputs
           # (copy_to_tp) or outputs (reduce_from_tp, gather_to_replicas) are
           # the same on every rank: copy_to_tp's rank-specific consumers
           # scale it by r + 1, the other two keep the rank's own copy
           "copy_to_tp": lambda x: coll.copy_to_tp(x, axis) * (r + 1),
           "reduce_from_tp": lambda x: coll.reduce_from_tp(x, axis),
           "gather_to_replicas": lambda x: coll.gather_to_replicas(x, 1, axis)}
    shape = {"heads_to_seq": (1, 2 * n, 1, 3)}.get(op, (1, 2, n, 3))  # (B, L, H, D) shards
    take = (lambda x: x) if op == "copy_to_tp" else Take.apply  # copy_to_tp: X replicated
    gather = (lambda y: y) if op in ("reduce_from_tp", "gather_to_replicas") else Gather.apply
    g = torch.Generator().manual_seed(11)
    X = torch.randn((n,) + shape, generator=g, dtype=torch.float64, requires_grad=True)
    return torch.autograd.gradcheck(lambda x: gather(fns[op](take(x))), (X,),
                                    eps=1e-6, atol=1e-8, rtol=1e-6)


# ------------------------------ the AR transformer under tp ------------------------------

def _ar_model(cfg_kw: dict, state: dict, quant=None):
    """The port's ARTransformer of ``cfg_kw`` (dtype by name) with ``state``
    (numpy, port names); quant "q" / "q8": the quantized structure
    (every linear and the table, min_size 1) before the state loads."""
    import torch

    from gen3c_tpu_torch.models.ar_transformer import ARConfig, ARTransformer
    from gen3c_tpu_torch.models.quantize import quantize_ar_params

    kw = dict(cfg_kw)
    kw["dtype"] = getattr(torch, kw.get("dtype", "float32"))
    for k in ("latent_shape", "original_latent_shape"):
        if k in kw:
            kw[k] = tuple(kw[k])
    model = ARTransformer(ARConfig(**kw))
    if quant is not None:
        quantize_ar_params(model, act_quant=quant == "q8", structure_only=True, min_size=1)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def ar_tp(rank, world, tp: int, cfg_kw: dict, state: dict, tokens, quant=None, context=None,
          decode: bool = False) -> dict:
    """The AR model whole and cut to this rank's tp shards
    (``shard_ar_params``): the prefill's logits of ``tokens`` on both; with
    decode, greedy ``generate`` (bf16 and int8 caches), ``generate_bucketed``
    and ``generate_with_embeddings`` on both; the cut entries, the cache's
    heads and K8's launches under tp."""
    import torch

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.models import ar_transformer as tar
    from gen3c_tpu_torch.parallel.sharding import shard_ar_params

    groups = layout_groups(rank, world, tp=tp)
    model = _ar_model(cfg_kw, state, quant)
    ids = torch.from_numpy(tokens).long()
    ctx = None if context is None else torch.from_numpy(context)

    def run():
        out = {"logits": model(ids, context=ctx)[0].float().numpy()}
        if decode:
            for kv in (False, True):  # teacher-forced: a 10-token prefill, then one at a time
                cache = tar.init_kv_cache(model.cfg, ids.shape[0], dtype=model.cfg.dtype,
                                          quantized=kv, tp=model.tp_size)
                steps = [model(ids[:, :10], cache=cache, context=ctx)[0][:, -1]]
                for i in range(10, ids.shape[1]):
                    steps.append(model(ids[:, i:i + 1], cache=cache, context=ctx)[0][:, -1])
                out[f"decode_int8={kv}"] = torch.stack(steps, 1).float().numpy()
            for kv in (False, True):
                out[f"generate_int8={kv}"] = tar.generate(
                    model, ids, 6, temperature=0.0, context=ctx, quantize_kv=kv).numpy()
            rows = [tokens[0, 3:], tokens[1]]
            out["bucketed"] = tar.generate_bucketed(model, rows, 5, temperature=0.0,
                                                    context=ctx, bucket=8).numpy()
            emb = model.embed(ids[:, :5])
            out["embeddings"] = tar.generate_with_embeddings(model, emb, 5, temperature=0.0,
                                                             context=ctx).numpy()
        return out

    with torch.no_grad():
        whole = run()
        dims = shard_ar_params(model, groups)
        kernels.reset_launch_counts()
        cut = run()
    cache = tar.init_kv_cache(model.cfg, 1, tp=model.tp_size)
    return {"whole": whole, "tp": cut, "sharded": sorted(dims), "tp_rank": groups.tp.rank,
            "cache_heads": cache.k.shape[3], "q_rows": model.layers[0].attention.wq.weight.shape[0]}


def ar_tp_train(rank, world, dp: int, tp: int, fsdp: bool, cfg_kw: dict, state: dict,
                batches: list, contexts: list, lr: float, loss_kw: dict) -> dict:
    """``make_sharded_ar_train_step`` over this rank's (dp, tp) mesh on the
    AR model of ``cfg_kw`` with ``state``, cut to its tp shards
    (``shard_ar_params``) and with fsdp over dp too (``shard_fsdp``), one
    AdamW step a batch: per step loss, accuracy, grad norm and the summed
    gradients the optimizer took, the final params, first moments and
    gradients gathered to the one-device form (``gather_to_host``), and
    the elements of this rank's params."""
    import torch

    from gen3c_tpu_torch import kernels
    from gen3c_tpu_torch.parallel import sharding
    from gen3c_tpu_torch.training import ar_train
    from gen3c_tpu_torch.training.train_step import AdamW

    groups = layout_groups(rank, world, dp=dp, tp=tp)
    model = _ar_model(cfg_kw, state)
    dims = sharding.shard_ar_params(model, groups)
    cut = sharding.shard_fsdp(model, groups) if fsdp else {}
    seen = []

    class Recording(AdamW):
        def update(self, grads, *args, **kw):
            seen.append({n: g.detach().clone() for n, g in grads.items()})
            return super().update(grads, *args, **kw)

    opt = Recording(lr)
    opt_state = opt.init(sharding.named_leaves(model))
    step = ar_train.make_sharded_ar_train_step(groups, opt, fsdp=fsdp)
    kernels.reset_launch_counts()
    out = {"loss": [], "accuracy": [], "grad_norm": []}
    for tokens, ctx in zip(batches, contexts):
        model, opt_state, m = step(model, opt_state, torch.from_numpy(tokens).long(),
                                   None if ctx is None else torch.from_numpy(ctx), **loss_kw)
        for k in out:
            out[k].append(float(m[k]))
    tp_dims = sharding.ar_sharded_leaves(model)
    fsdp_dims = sharding.fsdp_leaves(model)

    def gather(tensors):
        host = sharding.gather_to_host(tensors, tp_dims, groups.tp, True, fsdp_dims, groups.dp)
        return {n: t.numpy().copy() for n, t in host.items()}

    params = {n: p.detach() for n, p in sharding.named_leaves(model).items()}
    out.update(params=gather(params), mu=gather(opt_state.mu), grads=gather(seen[0]),
               held=sum(p.numel() for p in params.values()), sharded=sorted(dims),
               fsdp=sorted(cut), tp_rank=groups.tp.rank, dp_rank=groups.dp.rank,
               launches=dict(kernels.launch_counts),
               q_heads=model.layers[0].attention.wq.weight.shape[0] // model.cfg.head_dim)
    return out


def ar_tp_hidden(rank, world, tp: int, cfg_kw: dict, state: dict, tokens) -> dict:
    """The tp-cut model's ``train_hidden`` through its (gathered) LM head,
    and its inference forward's logits."""
    import torch

    from gen3c_tpu_torch.models import ar_transformer as tar
    from gen3c_tpu_torch.parallel.sharding import shard_ar_params

    groups = layout_groups(rank, world, tp=tp)
    model = _ar_model(cfg_kw, state)
    shard_ar_params(model, groups)
    ids = torch.from_numpy(tokens).long()
    with torch.no_grad():
        return {"hidden_logits": model.logits(tar.train_hidden(model, ids)).numpy(),
                "forward": model(ids)[0].numpy()}


def vocab_argmax(rank, world, tp: int, logits) -> list:
    """``ar_train.vocab_parallel_argmax`` of ``logits`` (rows, V) over a tp
    axis, this rank holding its V/tp columns."""
    import torch

    from gen3c_tpu_torch.parallel import collectives
    from gen3c_tpu_torch.training.ar_train import vocab_parallel_argmax

    groups = layout_groups(rank, world, tp=tp)
    axis = groups.tp
    full = torch.from_numpy(logits)
    n = full.shape[-1] // axis.size
    local = full[..., axis.rank * n:(axis.rank + 1) * n]
    local_max = local.max(dim=-1).values
    gmax = collectives.all_reduce(local_max, axis, op="max")
    return vocab_parallel_argmax(local, local_max, gmax, axis.rank * n, axis).tolist()


# ------------------------------ serving over several ranks ------------------------------

def _serving_model(parallel: str, ckpt: str):
    """The tiny GEN3C serving model (2 steps, heuristic depth, ``ckpt``'s
    weights) over this pool's ranks with ``parallel``, on the CPU over gloo."""
    from gen3c_tpu_torch.serving.models import Gen3cPersistentModel

    return Gen3cPersistentModel(
        "gen3c_tiny", checkpoint_dir=ckpt, num_steps=2, depth_source="heuristic",
        num_devices=2, parallel=parallel, cp_attn="ulysses" if parallel == "cp" else None,
        device="cpu", dist_backend="gloo", channel_timeout_s=TIMEOUT_S)


def serving_session(rank, world, parallel: str, ckpt: str, seed_req, req, cancel_req,
                    next_req, align: list, scale_maps: list) -> dict:
    """A session of the served model over 2 ranks: rank 0 seeds, runs
    ``req`` (its second chunk started from ``align``'s frame, its non-rigid
    depth fit ``scale_maps``' arrays, as the single-process tests align
    them), runs ``cancel_req`` with a cancel set by its first chunk, runs
    ``next_req``, clears the cache (a request then fails), reseeds and runs
    ``next_req`` again, then stops; rank 1 follows. Every rank reports the
    outcome of each inference it ran (frames, or the exception) and its
    chunks a call."""
    import torch

    import gen3c_tpu_torch.ops.camera as tcam

    model = _serving_model(parallel, ckpt)
    fits = [torch.from_numpy(np.array(a)) for a in scale_maps]
    fit = tcam._nonrigid_scale_map
    tcam._nonrigid_scale_map = lambda *args: fits.pop(0)
    try:
        return _session(model, seed_req, req, cancel_req, next_req, align)
    finally:
        tcam._nonrigid_scale_map = fit


def _session(model, seed_req, req, cancel_req, next_req, align: list) -> dict:
    import threading

    generate = model.pipeline.generate
    pending = list(align)
    outcomes = []
    run = model._run_inference

    def recorded(*args, **kwargs):
        try:
            res = run(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - reported, then raised on
            outcomes.append({"error": type(e).__name__,
                             "chunks": len(model.last_timings.get("generate", []))})
            raise
        outcomes.append({"frames": res.images.copy(),
                         "chunks": len(model.last_timings["generate"])})
        return res

    model._run_inference = recorded
    first_chunk = []

    def aligned_generate(*args, **kwargs):
        video, prompt = generate(*args, **kwargs)
        if pending:
            first_chunk.append(video.copy())
            video[-1] = pending.pop(0)
        return video, prompt

    model.pipeline.generate = aligned_generate
    out = {"rank": model.channel.rank, "leads": model.leads}
    if not model.leads:
        out["calls"] = model.follow()
    else:
        seeded = model.seed_model(seed_req)
        out["seed_depths"] = seeded.depths
        progress = []
        model.run_inference(req, on_chunk=lambda d, t, v: progress.append((d, t, len(v))))
        out["progress"] = progress
        ev = threading.Event()
        cancelled_after = []

        def cancel_on_first(d, t, v):
            cancelled_after.append(d)
            ev.set()

        try:
            model.run_inference(cancel_req, on_chunk=cancel_on_first, cancel_event=ev)
            out["cancel"] = "not raised"
        except Exception as e:  # noqa: BLE001
            out["cancel"] = type(e).__name__
        out["cancelled_after"] = cancelled_after
        model.run_inference(next_req)
        model.clear_cache()
        try:
            model.run_inference(next_req)
            out["after_clear"] = "ran"
        except AssertionError:
            out["after_clear"] = "refused"
        model.seed_model(seed_req)
        model.run_inference(next_req)
        model.shutdown()
    out["first_chunk"] = first_chunk[0] if first_chunk else None
    out["outcomes"] = outcomes
    return out


def serving_http(rank, world, parallel: str, ckpt: str, seed_wire: bytes, req_wire: bytes
                 ) -> dict:
    """The whole HTTP round trip over 2 ranks: rank 0 serves on port 0
    (``serving.server.serve``) while rank 1 follows; seed, a synchronous
    inference, its result, the metadata, then the server's shutdown sends
    "stop" and rank 1's ``follow`` returns."""
    import threading
    import urllib.request

    from gen3c_tpu_torch.serving.serialization import loads_api_message
    from gen3c_tpu_torch.serving.server import serve

    model = _serving_model(parallel, ckpt)
    if not model.leads:
        return {"rank": rank, "calls": model.follow()}
    server, service = serve(host="127.0.0.1", port=0, model=model)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def call(method, path, body=None):
        request = urllib.request.Request(base + path, data=body, method=method)
        with urllib.request.urlopen(request, timeout=TIMEOUT_S) as resp:
            return resp.status, resp.read()

    try:
        codes = {"seed": call("POST", "/seed-model", seed_wire)[0],
                 "submit": call("POST", "/request-inference", req_wire)[0]}
        t_end = time.time() + TIMEOUT_S
        while time.time() < t_end:  # the service's worker thread runs the job
            state = json.loads(call("GET", "/job-status?request_id=http")[1])["state"]
            if state in ("done", "error", "cancelled"):
                break
            time.sleep(0.2)
        codes["result"], body = call("GET", "/inference-result?request_id=http")
        codes["preview"] = call("POST", "/render-preview", req_wire)[0]  # rank 0's alone
        meta = json.loads(call("GET", "/metadata")[1])
        codes["clear"] = call("POST", "/clear-cache")[0]
    finally:
        server.shutdown()
        server.server_close()
        service.shutdown()
        service.worker.join(timeout=TIMEOUT_S)
        model.shutdown()
    return {"rank": rank, "state": state, "codes": codes,
            "frames": loads_api_message(body).images, "seeded": meta["seeded"],
            "cache_after_clear": model.cache is None}


# ------------------------------ pipeline parallelism, sharded renders ------------------------------

def pp_forward(rank, world, pp: int, state: dict, x, t, ctx, n_microbatches: int,
               cut: bool = False) -> dict:
    """``pp_dit_forward`` of the tiny GEN3C DiT (fp32, ``state``) over a pp
    axis of ``pp`` ranks (a replica's cp axis of the pool) and the
    gradient of sum(out ** 2) with respect to x (``backward``); cut: the
    net keeps its stage's blocks only (``shard_pp_params``)."""
    import torch

    from gen3c_tpu_torch.parallel import collectives
    from gen3c_tpu_torch.parallel.pp import pp_dit_forward, shard_pp_params

    axis = layout_groups(rank, world, cp=pp).cp
    net = train_module("gen3c", state, False)
    kept = shard_pp_params(net, axis) if cut else None
    xt = torch.from_numpy(x).requires_grad_(True)
    collectives.reset_traffic()
    out = pp_dit_forward(axis, net, xt, torch.from_numpy(t), torch.from_numpy(ctx),
                         n_microbatches=n_microbatches)
    (out.float() ** 2).sum().backward()
    return {"out": out.detach().numpy(), "grad_x": xt.grad.numpy(), "stage": axis.rank,
            "kept": kept, "blocks": len(net.blocks), "p2p": dict(collectives.traffic["p2p"])}


def sharded_render(rank, world, n: int, image, depth, k, w2cs, ks) -> dict:
    """``sharded_render_cache`` of a static Cache3DBuffer over a cp axis of
    ``n`` ranks, and the one-process ``render_cache`` of the same cache."""
    import torch

    from gen3c_tpu_torch.cache import Cache3DBuffer
    from gen3c_tpu_torch.parallel.cache_sharding import sharded_render_cache

    axis = layout_groups(rank, world, cp=n).cp
    w2c0 = np.eye(4, dtype=np.float32)
    cache = Cache3DBuffer(frame_buffer_max=2, input_image=torch.from_numpy(image[None]),
                          input_depth=torch.from_numpy(depth[None, None]),
                          input_w2c=torch.from_numpy(w2c0[None]),
                          input_intrinsics=torch.from_numpy(k[None]))
    px, mk = sharded_render_cache(cache, axis, torch.from_numpy(w2cs), torch.from_numpy(ks))
    one_px, one_mk = cache.render_cache(torch.from_numpy(w2cs), torch.from_numpy(ks))
    return {"px": px.numpy(), "mk": mk.numpy(), "one_px": one_px.numpy(),
            "one_mk": one_mk.numpy()}
