"""The collectives of context- and CFG-parallel denoising, each a plain
function on tensors and a mesh ``Axis`` (port of the ``jax.lax``
collectives gen3c_tpu uses inside its shard_map):

  seq_to_heads / heads_to_seq  the tiled all-to-all that swaps a sequence
                               split for a head split and back (Ulysses,
                               gen3c_tpu/models/dit.py:668-678)
  all_gather                   the tiled all-gather along one axis (the
                               all-gather KV strategy, dit.py:764-765, and
                               the samples at the end, parallel/cp.py)
  ring_shift                   rank r sends to r + 1 and receives from r - 1
                               (``ppermute``, dit.py:646-647)
  all_reduce                   sum, mean or max over the axis (``psum`` /
                               ``pmean``, diffusion/sampler.py:81-82,
                               390-398, 691-692; the max: a row-parallel
                               W8A8 input's absmax, which GSPMD takes over
                               the row's shards)
  reduce_scatter               this rank's chunk of the sum over the axis
                               (``psum_scatter``, the sequence-parallel
                               row output, dit.py:774-776, 793-795)
  send / recv                  one tensor from one rank of the axis to
                               another, under a tag (the pipeline's
                               activations and their gradients, the
                               ``ppermute`` of gen3c_tpu/parallel/pp.py)

and Megatron's two tensor-parallel operators, where the sum and its
adjoint part ways (dit.py:771-778, 792-798 under autodiff):

  copy_to_tp                   identity forward, all-reduce backward: the
                               input of a column-parallel linear
  reduce_from_tp               all-reduce forward, identity backward: a
                               row-parallel linear's partial sums
  gather_to_replicas           all-gather forward whose consumers are
                               the same on every rank (the SP net's
                               output), this rank's chunk backward

Each one is differentiable where a gradient is tracked (grad mode on and
the input requiring grad): a ``torch.autograd.Function`` whose backward
is its adjoint, the collective that carries the cotangents back:
seq_to_heads and heads_to_seq are each other's, all_gather's is
reduce_scatter (all-to-all, then the sum in rank order) and
reduce_scatter's is all_gather, all_reduce's is itself (each rank's
cotangent of its copy of the sum, summed; a mean divides by the axis
size). ``all_reduce`` is the right adjoint only where every rank's
consumer of the sum differs; a row-parallel output feeds the same
computation on every tp rank, whose cotangents are equal, and summing
them would hand each rank tp times the gradient: that is reduce_from_tp.
A training step under context parallelism differentiates its Ulysses
attention through them, one under tensor parallelism its Megatron
linears.

On NCCL they take CUDA tensors directly. On gloo, which the caller chooses
for CPU tensors, or for CUDA tensors when the ranks share one card (NCCL
refuses two ranks of a communicator on one GPU), an op that gloo does not
take on CUDA tensors (``GLOO_CUDA_OPS``) goes through pinned host memory:
copied out, exchanged, copied back. That staging is what gloo is on a
card, not a fallback.

The layouts keep copies to the one each exchange needs: ``seq_to_heads``
and ``all_gather`` return strided views of their receive buffers, whose
sequence axis has a single stride (the buffer is ordered (rank, position,
batch, ...)), which the attention kernels read as they are.

``traffic`` counts, per op, the calls, the bytes of other ranks' data this
rank received (all-to-all (n-1)/n of the buffer, all-gather n-1 shards, a
ring shift one shard, all-reduce n-1 copies of the tensor, reduce-scatter
(n-1)/n of the buffer, as its all-to-all) and the host
seconds spent in the op (for gloo on a card, the copies and the exchange;
for NCCL, the enqueue).
"""

from __future__ import annotations

import time
from typing import List

import torch
import torch.distributed as dist

from gen3c_tpu_torch.parallel.mesh import Axis

# gloo ops that take CUDA tensors themselves: torch 2.11's gloo backend on
# an H100 runs all_reduce, all_to_all_single and all_gather on them and
# aborts the process on send/recv (gen3c_tpu_torch/scripts/
# probe_collectives.py checks each). The others are staged through host memory.
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_to_all", "all_gather"})

traffic = {op: {"calls": 0, "bytes": 0, "seconds": 0.0}
           for op in ("all_to_all", "all_gather", "ring_shift", "all_reduce", "reduce_scatter",
                      "p2p")}


def reset_traffic() -> None:
    for counts in traffic.values():
        counts.update(calls=0, bytes=0, seconds=0.0)


def _record(op: str, nbytes: int, t0: float) -> None:
    traffic[op]["calls"] += 1
    traffic[op]["bytes"] += int(nbytes)
    traffic[op]["seconds"] += time.perf_counter() - t0


def _staged(op: str, t: torch.Tensor, axis: Axis) -> bool:
    return t.is_cuda and dist.get_backend(axis.group) == "gloo" and op not in GLOO_CUDA_OPS


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (the copy waits for the stream)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _all_to_all(send: torch.Tensor, axis: Axis, op: str = "all_to_all") -> torch.Tensor:
    """dist.all_to_all_single over dim 0 of a contiguous (n, ...) buffer,
    counted under ``op``."""
    t0 = time.perf_counter()
    staged = _staged("all_to_all", send, axis)
    src = _host(send) if staged else send
    recv = torch.empty_like(src)
    dist.all_to_all_single(recv, src, group=axis.group)
    if staged:
        recv = recv.to(send.device)
    _record(op, _nbytes(send) * (axis.size - 1) // axis.size, t0)
    return recv


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _seq_to_heads(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.axis), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _heads_to_seq(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _reduce_scatter(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.axis), None, None


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherToReplicas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, x.shape[dim]
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n).contiguous(), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, op):
        ctx.axis, ctx.op = axis, op
        return _all_reduce(x, axis, op)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis, ctx.op), None, None


def seq_to_heads(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(B, L/n, H, D) sequence shard -> (B, L, H/n, D) head shard: rank r
    gets heads [r H/n, (r+1) H/n) of every rank's positions, in rank order
    (``jax.lax.all_to_all(split_axis=2, concat_axis=1, tiled=True)``). The
    result is a view of the receive buffer, (n, L/n, B, H/n, D) in memory:
    one sequence stride of B H/n D elements. Its adjoint is heads_to_seq."""
    return _SeqToHeads.apply(x, axis) if _tracked(x) else _seq_to_heads(x, axis)


def _seq_to_heads(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    B, Lloc, H, D = x.shape
    n = axis.size
    if H % n:
        raise ValueError(f"Ulysses needs the heads ({H}) to divide the cp size ({n})")
    send = x.reshape(B, Lloc, n, H // n, D).permute(2, 1, 0, 3, 4).contiguous()
    recv = _all_to_all(send, axis)  # (n source ranks, L/n, B, H/n, D)
    return recv.view(n * Lloc, B, H // n, D).permute(1, 0, 2, 3)


def heads_to_seq(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The inverse of ``seq_to_heads``: (B, L, H/n, D) -> (B, L/n, H, D),
    contiguous (``jax.lax.all_to_all(split_axis=1, concat_axis=2)``). Its
    adjoint is seq_to_heads."""
    return _HeadsToSeq.apply(x, axis) if _tracked(x) else _heads_to_seq(x, axis)


def _heads_to_seq(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    B, L, Hc, D = x.shape
    n = axis.size
    send = x.reshape(B, n, L // n, Hc, D).permute(1, 2, 0, 3, 4).contiguous()
    recv = _all_to_all(send, axis)  # (n source ranks = head groups, L/n, B, H/n, D)
    return recv.permute(2, 1, 0, 3, 4).reshape(B, L // n, n * Hc, D)


def all_gather(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The shards of every rank concatenated along ``dim`` in rank order
    (``jax.lax.all_gather(axis=dim, tiled=True)``). A view of the receive
    buffer, (n, shard length, the other dims) in memory: ``dim`` keeps a
    single stride. Its adjoint is ``reduce_scatter``."""
    return _AllGather.apply(x, dim, axis) if _tracked(x) else _all_gather(x, dim, axis)


def _all_gather(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    n = axis.size
    t0 = time.perf_counter()
    send = x.movedim(dim, 0).contiguous()
    staged = _staged("all_gather", send, axis)
    src = _host(send) if staged else send
    out = torch.empty((n,) + tuple(src.shape), dtype=src.dtype, device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=axis.group)
    if staged:
        out = out.to(x.device)
    _record("all_gather", _nbytes(send) * (n - 1), t0)
    return out.view((n * send.shape[0],) + tuple(send.shape[1:])).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """Rank r's shard of the sum over the axis of x (every rank's full
    length along ``dim``): chunk r of each rank's x, summed in rank order
    (``jax.lax.psum_scatter(scatter_dimension=dim, tiled=True)``), through
    one all-to-all (gloo has no reduce-scatter). The adjoint of
    ``all_gather``, whose own adjoint it is; counted under
    "reduce_scatter"."""
    return _ReduceScatter.apply(x, dim, axis) if _tracked(x) else _reduce_scatter(x, dim, axis)


def _reduce_scatter(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    n = axis.size
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: {x.shape[dim]} along dim {dim} does not split "
                         f"{n} ways")
    send = x.movedim(dim, 0)
    send = send.reshape((n, send.shape[0] // n) + tuple(send.shape[1:])).contiguous()
    recv = _all_to_all(send, axis, "reduce_scatter")  # (source rank, shard, the other dims)
    out = recv[0].clone()
    for part in recv[1:]:
        out += part
    return out.movedim(0, dim)


def ring_shift(tensors: List[torch.Tensor], axis: Axis) -> List[torch.Tensor]:
    """Each tensor sent to the next rank of the axis and replaced by the
    previous rank's (``jax.lax.ppermute`` with perm j -> j + 1 mod n)."""
    n, r = axis.size, axis.rank
    nxt = dist.get_global_rank(axis.group, (r + 1) % n)
    prv = dist.get_global_rank(axis.group, (r - 1) % n)
    out = []
    for t in tensors:
        t0 = time.perf_counter()
        staged = _staged("ring_shift", t, axis)
        src = _host(t) if staged else t.contiguous()
        recv = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, nxt, axis.group),
               dist.P2POp(dist.irecv, recv, prv, axis.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        out.append(recv.to(t.device) if staged else recv)
        _record("ring_shift", _nbytes(t), t0)
    return out


def copy_to_tp(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """x itself; its cotangent is summed over the axis (Megatron's copy to
    the tensor-parallel region): the input of a column-parallel linear,
    whose ranks each take a part of the gradient."""
    return _CopyToTp.apply(x, axis) if _tracked(x) else x


def reduce_from_tp(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of x over the axis; its cotangent passes unchanged
    (Megatron's reduce from the tensor-parallel region): a row-parallel
    linear's partial sums, whose sum every rank then uses alike."""
    return _ReduceFromTp.apply(x, axis) if _tracked(x) else _all_reduce(x, axis)


def gather_to_replicas(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """``all_gather`` of shards that every rank then consumes the same way
    (the sequence-parallel net's output, before a loss every tp rank
    computes alike): the cotangent is equal on every rank, so its adjoint
    is this rank's chunk of it, not their sum."""
    return _GatherToReplicas.apply(x, dim, axis) if _tracked(x) else _all_gather(x, dim, axis)


def all_reduce(x: torch.Tensor, axis: Axis, op: str = "sum") -> torch.Tensor:
    """The sum (or mean, or max) of x over the axis, a new tensor on x's
    device. The sum's and the mean's adjoint is itself: each rank's
    cotangent of its copy, summed (or averaged); the max (a row's absmax
    over its slices, for a scale) carries no gradient."""
    if op == "max":
        return _all_reduce(x.detach(), axis, op)
    return _AllReduce.apply(x, axis, op) if _tracked(x) else _all_reduce(x, axis, op)


def _all_reduce(x: torch.Tensor, axis: Axis, op: str = "sum") -> torch.Tensor:
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"all_reduce takes 'sum', 'mean' or 'max', not {op!r}")
    t0 = time.perf_counter()
    staged = _staged("all_reduce", x, axis)
    y = _host(x) if staged else x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=axis.group)
    if staged:
        y = y.to(x.device)
    if op == "mean":
        y = y / axis.size
    _record("all_reduce", _nbytes(x) * (axis.size - 1), t0)
    return y


def send(t: torch.Tensor, dst: int, tag: int, axis: Axis) -> None:
    """t to rank ``dst`` of the axis under ``tag``, waited for (a CUDA
    tensor staged through host memory on gloo); counted under "p2p" with
    the bytes sent."""
    t0 = time.perf_counter()
    src = _host(t) if _staged("p2p", t, axis) else t.contiguous()
    dist.send(src, dist.get_global_rank(axis.group, dst), group=axis.group, tag=tag)
    _record("p2p", _nbytes(t), t0)


def recv(shape, dtype: torch.dtype, device, src: int, tag: int, axis: Axis) -> torch.Tensor:
    """The tensor rank ``src`` of the axis sends under ``tag``: a new one of
    ``shape`` and ``dtype`` on ``device``; counted under "p2p" with the
    bytes received."""
    t0 = time.perf_counter()
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    buf = (torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
           if _staged("p2p", out, axis) else out)
    dist.recv(buf, dist.get_global_rank(axis.group, src), group=axis.group, tag=tag)
    if buf is not out:
        out.copy_(buf)
    _record("p2p", _nbytes(out), t0)
    return out
