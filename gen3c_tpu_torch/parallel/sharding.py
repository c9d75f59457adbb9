"""Tensor-parallel shards of the DiT's parameters (port of
gen3c_tpu/parallel/sharding.py:31-98).

Megatron's column and row sharding, as gen3c_tpu's PartitionSpecs lay it
out on its (in, out) weights; ``nn.Linear`` holds (out, in), so each spec
names the other dimension here:

  attention q/k/v  (D, D)   P(None, 'tp') -> dim 0: the rows of H/tp heads
  attention out    (D, D)   P('tp', None) -> dim 1: their columns
  mlp fc1 (layer1) (D, 4D)  P(None, 'tp') -> dim 0
  mlp fc2 (layer2) (4D, D)  P('tp', None) -> dim 1
  everything else (norms, AdaLN, embedders, the final layer): replicated

JAX's specs match the leaf names ``/q/w`` ... ``fc2/w``; a quantized entry
is {"q"|"q8", "scale"}, so its leaves stay whole (P()) on every rank, and
so does a ``QuantLinear`` here. A sub-block (an ``Attention`` or a
``GPT2FeedForward``) is sharded only if all its q/k/v/out or fc1/fc2 are
plain linears: a whole one beside a sharded one could not be summed, so
the sub-block then keeps every linear whole and each rank computes it
entire, as GSPMD does for JAX's whole leaves. The same names match in the
multiview and action nets' blocks; their embedders stay replicated.

Here the weights are sliced in place (``shard_params``) and the modules
run their Megatron collectives themselves (``models.dit``: ``tp=`` and
``sp=``); ``gather_to_host`` / ``shard_tensors`` convert a state between
the sharded and the one-device form (checkpoints keep the latter). The
batch's layout (``batch_pspec``: B on dp, latent T on cp, the same slice
on every tp rank) is ``training.train_step.shard_step_inputs``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from gen3c_tpu_torch.parallel import collectives
from gen3c_tpu_torch.parallel.mesh import ITEM_15C, Axis, Groups

# (a sub-block's linear, its shard dimension on the (out, in) weight)
_ATTENTION = (("to_q.0", 0), ("to_k.0", 0), ("to_v.0", 0), ("to_out.0", 1))
_MLP = (("layer1", 0), ("layer2", 1))
# replicated leaves applied to this rank's H/tp heads only: their gradient
# is a part on each tp rank (the per-head RMSNorm scales of q and k)
_HEAD_NORMS = ("to_q.1.weight", "to_k.1.weight")


def _sub_blocks(net: nn.Module):
    """(name, module, its linears and dims) of every Attention and
    GPT2FeedForward in ``net``."""
    from gen3c_tpu_torch.models.dit import Attention, GPT2FeedForward

    for name, mod in net.named_modules():
        if isinstance(mod, Attention):
            yield name, mod, _ATTENTION
        elif isinstance(mod, GPT2FeedForward):
            yield name, mod, _MLP


def dit_shard_dims(net: nn.Module, fsdp_axis: Optional[str] = None) -> Dict[str, Optional[int]]:
    """The tp shard dimension of every entry of ``net.state_dict()``: 0 or
    1 for the column and row linears of a sub-block whose linears are all
    plain, None for a replicated entry (gen3c_tpu's ``dit_param_pspecs``).
    fsdp_axis (FSDP, ROADMAP item 15c) raises NotImplementedError."""
    if fsdp_axis is not None:
        raise NotImplementedError(f"FSDP is not ported ({ITEM_15C})")
    dims: Dict[str, Optional[int]] = {k: None for k in net.state_dict()}
    for name, mod, linears in _sub_blocks(net):
        if all(type(mod.get_submodule(lin)) is nn.Linear for lin, _ in linears):
            for lin, d in linears:
                dims[f"{name}.{lin}.weight"] = d
    return dims


def sharded_leaves(net: nn.Module) -> Dict[str, int]:
    """The parameters that ``shard_params`` sliced, by name: their shard
    dimension (empty for a net that runs whole)."""
    return {f"{name}.{lin}.weight": d for name, mod, linears in _sub_blocks(net)
            if mod.tp_size > 1 for lin, d in linears}


def head_norm_leaves(net: nn.Module) -> set:
    """The replicated parameters of the sharded attentions that act on
    this rank's heads only (q's and k's RMSNorm scales): each tp rank's
    gradient of them is a part, to be summed over tp."""
    from gen3c_tpu_torch.models.dit import Attention

    return {f"{name}.{leaf}" for name, mod, _ in _sub_blocks(net)
            if isinstance(mod, Attention) and mod.tp_size > 1 for leaf in _HEAD_NORMS}


def _narrow(t: torch.Tensor, dim: int, tp: Axis) -> torch.Tensor:
    if t.shape[dim] % tp.size:
        raise ValueError(f"a dimension of {t.shape[dim]} does not split over tp={tp.size}")
    n = t.shape[dim] // tp.size
    return t.narrow(dim, tp.rank * n, n)


@torch.no_grad()
def shard_params(net: nn.Module, groups: Groups) -> Dict[str, int]:
    """Slice a replicated net down to this rank's tp shards, in place
    (gen3c_tpu's ``shard_params``): the column linears keep their rows of
    this rank's H/tp heads (or 4D/tp hidden units), the row linears the
    matching columns, and each sharded sub-block records the tp size it
    runs at (``tp_size``). Every rank must hold the same weights before.
    Returns ``sharded_leaves(net)``; at tp 1, or on a net already cut for
    this tp size, nothing changes, and a net cut for another raises."""
    tp = groups.tp
    cut = {mod.tp_size for _, mod, _ in _sub_blocks(net)} - {1}
    if cut - {tp.size}:
        raise ValueError(f"the net is cut to tp={sorted(cut)} shards, not tp={tp.size}")
    if tp.size == 1 or cut:
        return sharded_leaves(net)  # whole, or cut for this tp size already
    dims = {k: d for k, d in dit_shard_dims(net).items() if d is not None}
    for name, mod, linears in _sub_blocks(net):
        if f"{name}.{linears[0][0]}.weight" not in dims:
            continue  # a quantized linear: the sub-block stays whole
        heads = getattr(mod, "num_heads", tp.size)
        if heads % tp.size:
            raise ValueError(f"num_heads={heads} must divide tp={tp.size}")
        for lin_name, d in linears:
            lin = mod.get_submodule(lin_name)
            w = lin.weight
            lin.weight = nn.Parameter(_narrow(w, d, tp).clone(), requires_grad=w.requires_grad)
            lin.out_features, lin.in_features = lin.weight.shape
        mod.tp_size = tp.size
    return sharded_leaves(net)


@torch.no_grad()
def gather_to_host(state: dict, dims: Dict[str, int], tp: Axis, keep: bool) -> Optional[dict]:
    """The one-device form of a sharded state, in host memory, a tensor at
    a time: each tensor of ``state`` named in ``dims`` is gathered over tp
    along its dimension and copied to the host before the next is
    gathered, so that the device holds one gathered tensor at most beside
    the state (gen3c_tpu saves with ``jax.device_get``, shard by shard);
    the other tensors are copied as they are, a nested dict (a
    ``TrainState.state_dict``'s params, moments, EMA) the same way,
    anything else kept. Every rank of the tp axis must call this; the host
    copies are made and returned only where ``keep`` (the rank that
    writes), else None."""
    out = {} if keep else None
    for n, t in state.items():
        if isinstance(t, dict):
            t = gather_to_host(t, dims, tp, keep)
        elif n in dims:
            # the gather's contiguous receive buffer, (tp * shard, ...) with
            # dims[n] first: copied as it lies, turned back on the host
            t = collectives.all_gather(t, dims[n], tp).movedim(dims[n], 0)
            t = t.to("cpu", copy=True).movedim(0, dims[n]).contiguous() if keep else None
        elif torch.is_tensor(t) and keep:
            t = t.detach().to("cpu", copy=True)
        if keep:
            out[n] = t
    return out


def shard_tensors(tensors: Dict[str, torch.Tensor], dims: Dict[str, int],
                  tp: Axis) -> Dict[str, torch.Tensor]:
    """This rank's shard of a one-device state: ``gather_to_host``'s
    inverse, a slice a tensor named in ``dims``."""
    return {n: _narrow(t, dims[n], tp) if n in dims else t for n, t in tensors.items()}

