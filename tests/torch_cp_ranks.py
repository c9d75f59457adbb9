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
import multiprocessing as mp
import os
import queue
import socket
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

_GROUPS = {}
_NETS = {}


def _groups(rank: int, world: int, cfg: int, cp: int):
    """This rank's Groups for a (cfg, cp) layout: ``make_groups`` when it
    spans the pool, else its replica's (every rank creates every group, in
    one order, as new_group asks)."""
    import torch.distributed as dist

    from gen3c_tpu_torch.parallel.mesh import Axis, Groups, make_groups

    key = (cfg, cp)
    if key not in _GROUPS:
        n = cfg * cp
        if n == world:
            _GROUPS[key] = make_groups(cfg=cfg, cp=cp, backend="gloo")
        else:
            mine = Groups()
            for base in range(0, world, n):
                cfg_i, cp_i = divmod(rank - base, cp)
                here = 0 <= rank - base < n
                if cp > 1:
                    for c in range(cfg):
                        g = dist.new_group([base + c * cp + j for j in range(cp)], backend="gloo")
                        if here and c == cfg_i:
                            mine = Groups(mine.cfg, Axis(g, cp_i, cp))
                if cfg > 1:
                    for j in range(cp):
                        g = dist.new_group([base + c * cp + j for c in range(cfg)], backend="gloo")
                        if here and j == cp_i:
                            mine = Groups(Axis(g, cfg_i, cfg), mine.cp)
            _GROUPS[key] = mine
    return _GROUPS[key]


def _net(dit_kw: dict, state: dict):
    """The fp32 GeneralDIT of ``dit_kw`` with ``state`` (numpy), cached by
    its config (each test sends the same state with it)."""
    import torch

    from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT

    key = tuple(sorted(dit_kw.items()))
    if key not in _NETS:
        net = GeneralDIT(DiTConfig(dtype=torch.float32, **dit_kw))
        net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
        _NETS[key] = net
    return _NETS[key]


def attention(rank, world, cp: int, impl: str, q, k, v, band=None) -> dict:
    """models.dit.cp_self_attention on this rank's shard of q/k/v
    (B, L, H, D): its output shard, its index on the cp axis and the ring
    steps it folded and skipped."""
    import torch

    from gen3c_tpu_torch.models import dit

    axis = _groups(rank, world, 1, cp).cp
    n = q.shape[1] // cp
    sl = slice(axis.rank * n, (axis.rank + 1) * n)
    dit.ring_steps.update(folded=0, skipped=0)
    with torch.no_grad():
        out = dit.cp_self_attention(*(torch.from_numpy(np.ascontiguousarray(t[:, sl]))
                                      for t in (q, k, v)), axis, impl, band)
    return {"out": out.numpy(), "cp_rank": axis.rank, "ring_steps": dict(dit.ring_steps)}


def forward(rank, world, cp: int, dit_kw: dict, state: dict, x, t, ctx) -> dict:
    """GeneralDIT.forward(cp=...) on this rank's latent-T shard of x."""
    import torch

    axis = _groups(rank, world, 1, cp).cp
    n = x.shape[2] // cp
    xs = np.ascontiguousarray(x[:, :, axis.rank * n:(axis.rank + 1) * n])
    with torch.no_grad():
        out = _net(dit_kw, state)(torch.from_numpy(xs), torch.from_numpy(t), torch.from_numpy(ctx),
                                  fps=24.0, cp=axis)
    return {"out": out.numpy(), "cp_rank": axis.rank}


def sample(rank, world, cfg: int, cp: int, dit_kw: dict, state: dict, arrays: dict,
           opts: dict) -> np.ndarray:
    """parallel.cp.cp_generate_samples over a (cfg, cp) layout: the whole
    final latent as this rank returns it."""
    import torch

    from gen3c_tpu_torch.parallel.cp import cp_generate_samples

    groups = _groups(rank, world, cfg, cp)
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return cp_generate_samples(groups, _net(dit_kw, state), **tensors, **opts).numpy()


# ------------------------------ training over a (dp, cp) mesh ------------------------------

_MESHES = {}


def mesh_groups(rank: int, world: int, dp: int, cp: int):
    """This rank's Groups of a (dp, cp) training mesh (cfg 1): ``make_groups``
    when it spans the pool, else its replica's, laid out as make_groups lays
    out dp * cp ranks (rank = dp_index * cp + cp_index) from the replica's
    first rank; every rank creates every group, in one order."""
    import torch.distributed as dist

    from gen3c_tpu_torch.parallel.mesh import Axis, Groups, make_groups

    key = (dp, cp)
    if key not in _MESHES:
        n = dp * cp
        if n == world:
            _MESHES[key] = make_groups(dp=dp, cp=cp, backend="gloo")
        else:
            axes = {}
            for base in range(0, world, n):
                here = 0 <= rank - base < n
                dp_i, cp_i = divmod(rank - base, cp)
                members = []
                if cp > 1:
                    members += [("cp", d, [base + d * cp + j for j in range(cp)])
                                for d in range(dp)]
                if dp > 1:
                    members += [("dp", j, [base + d * cp + j for d in range(dp)])
                                for j in range(cp)]
                members.append(("world", 0, list(range(base, base + n))))
                for name, which, ranks in members:
                    g = dist.new_group(ranks, backend="gloo")
                    if here and rank in ranks:
                        index = {"cp": cp_i, "dp": dp_i, "world": rank - base}[name]
                        axes[name] = Axis(g, index, len(ranks))
            _MESHES[key] = Groups(cp=axes.get("cp", Axis()), dp=axes.get("dp", Axis()),
                                  world=axes["world"])
    return _MESHES[key]


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
                    step_kw: dict, data_type: str = "video") -> dict:
    """Steps of the port's train step on ``batches`` with the injected global
    ``draws`` (dicts of numpy StepDraws fields): over ``groups`` through
    ``make_sharded_train_step``, or on one device (groups None) through
    ``train_step``. Returns per-step loss, grad_norm, sigma_mean and the
    final params (numpy, port names)."""
    import torch

    from gen3c_tpu_torch.training import train_step as tts

    cfg = train_cfg(kind)
    module = train_module(kind, state, step_kw.get("loss_add_logvar", False))
    opt = tts.make_optimizer(**opt_kw)
    st = tts.init_train_state(module, opt)
    if groups is not None:
        step = tts.make_sharded_train_step(groups, cfg, opt, data_type=data_type, **step_kw)
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
    out["params"] = {n: p.detach().numpy().copy() for n, p in module.named_parameters()}
    out["step"] = st.step
    return out


def train(rank, world, dp: int, cp: int, **kw) -> dict:
    """``run_train_steps`` over this rank's (dp, cp) mesh, plus the K1cp
    launches of its forward (the Ulysses ranks' attention) and its place."""
    from gen3c_tpu_torch import kernels

    groups = mesh_groups(rank, world, dp, cp)
    kernels.reset_launch_counts()
    out = run_train_steps(groups, **kw)
    out.update(dp_rank=groups.dp.rank, cp_rank=groups.cp.rank, world_rank=groups.world.rank)
    return out


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

    axis = _groups(rank, world, 1, cp).cp
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
           "all_reduce_mean": lambda x: coll.all_reduce(x, axis, "mean")}
    shape = {"heads_to_seq": (1, 2 * n, 1, 3)}.get(op, (1, 2, n, 3))  # (B, L, H, D) shards
    g = torch.Generator().manual_seed(11)
    X = torch.randn((n,) + shape, generator=g, dtype=torch.float64, requires_grad=True)
    return torch.autograd.gradcheck(lambda x: Gather.apply(fns[op](Take.apply(x))), (X,),
                                    eps=1e-6, atol=1e-8, rtol=1e-6)
