"""GPipe pipeline parallelism for the DiT (port of gen3c_tpu/parallel/pp.py).

The blocks are split into S contiguous stages over a pipeline axis
(``parallel.mesh.pp_axis``, gen3c_tpu's ``Mesh(devices, ("pp",))``): stage
s runs blocks [s N/S, (s+1) N/S). The batch is cut into M microbatches
and flows through the classic schedule, M + S - 1 ticks: at tick t stage
s runs microbatch t - s (when there is one) with that microbatch's
AdaLN embedding, AdaLN-LoRA vector and context, stage 0 taking it from
the patch embedding and every other stage from the stage before, which
sends it point to point (``collectives.send`` / ``recv``) under a tag of
its microbatch and direction. The last stage's outputs reach every rank
(summed with the other ranks' zeros: the same bits), and the final layer
and the unpatchify run everywhere. The patch, position and time
embeddings run on every rank too (small beside the blocks).

The schedule is differentiable: a received activation's backward sends
its gradient to the stage before, under the microbatch's backward tag,
and a sent one's receives it from the stage after. Every rank computes
the same loss of the replicated output, so the output's adjoint is this
rank's own cotangent, taken on the last stage only: summing the ranks'
would hand the pipeline S times the gradient. An input's gradient lands
where the input is used: x's (and the patch embedding's) on stage 0, a
block's on its stage, the time embedding's a part on every stage, the
final layer's whole on every rank. Every rank must run the backward
(``backward()``, or ``autograd.grad`` with respect to x, which every
stage's graph reaches) in the same order, microbatch by microbatch, as
autograd runs it alike on each.

The port keeps the blocks as modules: ``shard_pp_params`` drops the
blocks of the other stages (gen3c_tpu stacks them on a leading axis and
shards it, ``stack_block_params`` / ``shard_pp_params``). Bubble fraction
(S - 1) / (M + S - 1); pick M >= S.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from gen3c_tpu_torch.parallel import collectives
from gen3c_tpu_torch.parallel.mesh import Axis

_FWD, _BWD = 0, 1  # the tag's direction bit


def _tag(mb: int, direction: int) -> int:
    return 2 * mb + direction


def stage_blocks(num_blocks: int, axis: Axis) -> Tuple[int, int]:
    """This rank's stage's blocks [lo, hi)."""
    if num_blocks % axis.size:
        raise ValueError(f"num_blocks={num_blocks} must divide the pp size {axis.size}")
    n = num_blocks // axis.size
    return axis.rank * n, (axis.rank + 1) * n


@torch.no_grad()
def shard_pp_params(net: nn.Module, axis: Axis) -> Tuple[int, int]:
    """Keep this rank's stage's contiguous blocks in ``net`` and free the
    others, in place: (lo, hi) of the kept range. The embedders, the
    norms and the final layer stay replicated."""
    names = list(net.blocks)
    if len(names) != net.cfg.num_blocks:
        raise ValueError(f"the net holds {len(names)} of its {net.cfg.num_blocks} blocks: "
                         "cut already")
    lo, hi = stage_blocks(len(names), axis)
    for name in names[:lo] + names[hi:]:
        del net.blocks[name]
    return lo, hi


class _Recv(torch.autograd.Function):
    """Microbatch mb's activation from the stage before; backward: its
    gradient sent back there. ``anchor`` (this stage's own tokens of mb,
    unused) puts the receive on every path from x to the output, so that
    a backward toward x reaches it; its gradient is zero."""

    @staticmethod
    def forward(ctx, anchor, mb, axis):
        ctx.mb, ctx.axis = mb, axis
        return collectives.recv(anchor.shape, anchor.dtype, anchor.device, axis.rank - 1,
                                _tag(mb, _FWD), axis)

    @staticmethod
    def backward(ctx, g):
        collectives.send(g, ctx.axis.rank - 1, _tag(ctx.mb, _BWD), ctx.axis)
        return torch.zeros_like(g), None, None


class _Send(torch.autograd.Function):
    """Microbatch mb's activation to the stage after; returns a scalar
    whose backward receives the activation's gradient from there."""

    @staticmethod
    def forward(ctx, x, mb, axis):
        ctx.mb, ctx.axis = mb, axis
        ctx.meta = (x.shape, x.dtype, x.device)
        collectives.send(x, axis.rank + 1, _tag(mb, _FWD), axis)
        return torch.zeros((), dtype=torch.float32, device=x.device)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.meta
        return (collectives.recv(shape, dtype, device, ctx.axis.rank + 1, _tag(ctx.mb, _BWD),
                                 ctx.axis), None, None)


class _FromLastStage(torch.autograd.Function):
    """The last stage's outputs on every rank (each rank's zeros summed with
    them); its backward hands the last stage its own cotangent (every rank
    holds the same one) and the sends' scalars a zero, so that their
    backwards run."""

    @staticmethod
    def forward(ctx, out, axis, *sent):
        ctx.last = axis.rank == axis.size - 1
        ctx.n = len(sent)
        return collectives.all_reduce(out if ctx.last else torch.zeros_like(out), axis)

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros((), dtype=torch.float32, device=g.device)
        return (g if ctx.last else None, None) + (zero,) * ctx.n


def pp_dit_forward(axis: Axis, net: nn.Module, x: torch.Tensor, timesteps: torch.Tensor,
                   crossattn_emb: torch.Tensor, n_microbatches: int = 2,
                   fps: Optional[float] = 24.0) -> torch.Tensor:
    """The GeneralDIT forward pipelined over ``axis`` (gen3c_tpu's
    ``pp_dit_forward``): x (B, C, T, H, W), timesteps (B,), crossattn_emb
    (B, M_ctx, D_ctx), the same on every rank; returns the whole output
    (B, C_out, T, H, W) on every rank. ``net`` holds every block (each
    rank runs its stage's) or its stage's only (``shard_pp_params``). B
    must divide by n_microbatches; RoPE uses the whole grid's table (no
    token sharding here: pp composes with cp and tp on axes of their own
    in gen3c_tpu); band attention is not pipelined there either."""
    cfg = net.cfg
    if cfg.attn_temporal_window is not None:
        raise ValueError("pp_dit_forward runs full self-attention (no band), as gen3c_tpu's")
    B, _, T, H, W = x.shape
    M, S, s = n_microbatches, axis.size, axis.rank
    if B % M:
        raise ValueError(f"the batch of {B} does not split into {M} microbatches")
    lo, hi = stage_blocks(cfg.num_blocks, axis)
    blocks = list(net.blocks.values())
    if len(blocks) == cfg.num_blocks:
        blocks = blocks[lo:hi]
    elif len(blocks) != hi - lo:
        raise ValueError(f"the net holds {len(blocks)} blocks: neither all "
                         f"{cfg.num_blocks} nor its stage's {hi - lo}")
    dtype = cfg.dtype
    tokens = net.patchify(x.to(dtype), None)
    _, Tp, Hp, Wp, D = tokens.shape
    L = Tp * Hp * Wp
    tokens = tokens.reshape(B, L, D)
    rope = net.rope(Tp, Hp, Wp, fps, x.device)
    extra = net.extra_pos_embedder(Tp, Hp, Wp).to(dtype).reshape(1, L, D)
    emb, lora = net.time_embedding(timesteps)
    ctx = crossattn_emb.to(dtype)
    Bm = B // M
    mb_tokens, mb_emb, mb_lora, mb_ctx = (t.split(Bm) for t in (tokens, emb, lora, ctx))

    outputs, sent = [], []
    for t in range(M + S - 1):
        mb = t - s  # the microbatch this stage runs at tick t
        if not 0 <= mb < M:
            continue
        h = mb_tokens[mb] if s == 0 else _Recv.apply(mb_tokens[mb], mb, axis)
        for blk in blocks:
            h = blk(h, mb_emb[mb], mb_lora[mb], extra, mb_ctx[mb], rope)
        if s == S - 1:
            outputs.append(h)
        else:
            sent.append(_Send.apply(h, mb, axis))
    out = torch.cat(outputs) if outputs else torch.zeros((B, L, D), dtype=dtype, device=x.device)
    if S > 1:
        out = _FromLastStage.apply(out, axis, *sent)
    out = net.final(out, emb, lora)
    return net.unpatchify(out.reshape(B, Tp, Hp, Wp, -1), T, H, W)
