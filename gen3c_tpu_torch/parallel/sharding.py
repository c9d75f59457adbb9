"""Tensor-parallel and FSDP shards of the DiT's and the AR transformer's
parameters (port of gen3c_tpu/parallel/sharding.py).

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

FSDP (``dit_param_pspecs(fsdp_axis="dp")``): q/k/v/fc1 are P(dp, tp) and
out/fc2 P(tp, dp), so the dimension tp leaves whole is split over dp (dim
1 of a column linear here, dim 0 of a row one), and every other 2-d leaf
of at least ``FSDP_MIN_SIZE`` elements splits its larger dimension over
dp (a linear's (in, out) order there, so a tie goes to its input here).
``shard_fsdp`` keeps this rank's 1/dp of each such parameter and
gathers it over dp each time a module reads it (a
``torch.nn.utils.parametrize`` parametrization, ``collectives.
all_gather``): a block's weights are gathered as it runs and dropped
after, and gathered again where remat recomputes the block (ZeRO-3); the
gather's adjoint, the reduce-scatter, leaves each rank its shard of the
gradient summed over dp. AdamW's moments and the EMA are then kept per
shard. ``named_leaves`` names each such shard as the whole parameter.

The AR transformer (``ar_param_pspecs``): wq/wk/wv/w1/w3 and the
cross-attention's wq/wk/wv column-parallel (dim 0), wo/w2 and its wo
row-parallel (dim 1), the token table vocab-parallel (dim 0) and the LM
head column-parallel (dim 0); a quantized entry's codes shard like the
weight, a column entry's per-output-channel scale follows its rows and a
row entry's stays whole (``ar_shard_dims``, ``shard_ar_params``). Under
FSDP (``ar_param_pspecs(fsdp_axis="dp")``) those linears' other dimension
is split over dp (``ar_fsdp_dims``), through ``shard_fsdp`` as the DiT's.

Here the weights are sliced in place (``shard_params``, ``shard_fsdp``,
``shard_ar_params``) and the modules run their Megatron collectives
themselves (``models.dit``: ``tp=`` and ``sp=``; ``models.ar_transformer``:
``model.tp``); ``gather_to_host`` / ``shard_tensors`` convert a state
between the sharded and the one-device form (checkpoints keep the
latter). The batch's layout (``batch_pspec``: B on dp, latent T on cp, the
same slice on every tp rank) is ``training.train_step.shard_step_inputs``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from gen3c_tpu_torch.parallel import collectives
from gen3c_tpu_torch.parallel.mesh import Axis, Groups

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


# leaves with at least this many elements get FSDP-sharded (sharding.py _FSDP_MIN_SIZE)
FSDP_MIN_SIZE = 1 << 16


def dit_shard_dims(net: nn.Module, fsdp_axis: Optional[str] = None) -> Dict[str, Any]:
    """The tp shard dimension of every entry of ``net.state_dict()``: 0 or
    1 for the column and row linears of a sub-block whose linears are all
    plain, None for a replicated entry (gen3c_tpu's ``dit_param_pspecs``).

    fsdp_axis "dp": (tp dimension, dp dimension) a entry instead: a tp
    linear's other dimension; else, for a 2-d entry of at least
    FSDP_MIN_SIZE elements (of the whole net: call this before slicing),
    its larger dimension in JAX's layout (a linear's (in, out), a tie to
    the input); else None."""
    if fsdp_axis not in (None, "dp"):
        raise ValueError(f"FSDP shards over the 'dp' axis, not {fsdp_axis!r}")
    dims: Dict[str, Optional[int]] = {k: None for k in net.state_dict()}
    for name, mod, linears in _sub_blocks(net):
        if all(type(mod.get_submodule(lin)) is nn.Linear for lin, _ in linears):
            for lin, d in linears:
                dims[f"{name}.{lin}.weight"] = d
    if fsdp_axis is None:
        return dims
    from gen3c_tpu_torch.models.quantize import QuantLinear

    linear = {f"{n}.weight" for n, m in net.named_modules()
              if isinstance(m, (nn.Linear, QuantLinear))}
    out = {}
    for k, t in net.state_dict().items():
        d = None
        if dims[k] is not None:
            d = 1 - dims[k]
        elif t.ndim == 2 and t.numel() >= FSDP_MIN_SIZE:
            rows, cols = t.shape
            d = (1 if cols >= rows else 0) if k in linear else (0 if rows >= cols else 1)
        out[k] = (dims[k], d)
    return out


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


class _GatherDp(nn.Module):
    """The FSDP parametrization of a parameter: this rank's shard -> the
    parameter, gathered over dp along ``dim`` (its adjoint the
    reduce-scatter: the shard's gradient summed over dp)."""

    def __init__(self, dim: int, dp: Axis):
        super().__init__()
        self.dim, self.dp = dim, dp

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return collectives.all_gather(shard, self.dim, self.dp)


def fsdp_leaves(module: nn.Module) -> Dict[str, int]:
    """The parameters ``shard_fsdp`` cut over dp, by (plain) name: their dp
    dimension (empty for a module that holds them whole)."""
    found = {}
    for name, mod in module.named_modules():
        plist = getattr(mod, "parametrizations", None)
        if plist is None:
            continue
        for leaf, chain in plist.items():
            gather = [f for f in chain if isinstance(f, _GatherDp)]
            if gather:
                found[f"{name}.{leaf}" if name else leaf] = gather[0].dim
    return found


def named_leaves(module: nn.Module) -> Dict[str, nn.Parameter]:
    """``module.named_parameters()`` with each FSDP shard under the name of
    the parameter it is a shard of (``x.weight``, not parametrize's
    ``x.parametrizations.weight.original``): the names of the train state,
    its checkpoints and its gradients."""
    fsdp = fsdp_leaves(module)
    out = {}
    for n, p in module.named_parameters():
        if n.endswith(".original"):
            plain = n[:-len(".original")].replace(".parametrizations.", ".")
            n = plain if plain in fsdp else n
        out[n] = p
    return out


@torch.no_grad()
def shard_fsdp(module: nn.Module, groups: Groups) -> Dict[str, int]:
    """FSDP (gen3c_tpu's ``shard_params(..., fsdp_axis="dp")``): cut each
    parameter ``dit_shard_dims(fsdp_axis="dp")`` gives a dp dimension (of
    an ``ARTransformer``: ``ar_fsdp_dims``) to this rank's 1/dp along it,
    in place, and gather it over dp wherever a
    module reads it (``_GatherDp``). Call it after ``shard_params`` (the tp
    shards are cut further). Returns ``fsdp_leaves(module)``: nothing at
    dp 1 (a no-op, as JAX's dp-1 mesh) or on a module cut already."""
    dp = groups.dp
    done = fsdp_leaves(module)
    if dp.size == 1 or done:
        return done
    params = dict(module.named_parameters())
    if hasattr(module, "tok_embeddings"):  # the AR transformer
        dims = ar_fsdp_dims(module)
    else:
        dims = {k: d for k, (_, d) in dit_shard_dims(module, "dp").items()
                if d is not None and k in params}
    from torch.nn.utils import parametrize

    for name, d in dims.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        p = params[name]
        setattr(owner, leaf, nn.Parameter(_narrow(p.detach(), d, dp).clone(),
                                          requires_grad=p.requires_grad))
        parametrize.register_parametrization(owner, leaf, _GatherDp(d, dp), unsafe=True)
    return fsdp_leaves(module)


def _ar_dim(key: str) -> Optional[int]:
    module, _, leaf = key.rpartition(".")
    if module == "tok_embeddings":
        return 0 if leaf == "weight" else None  # a quantized table's scale stays whole
    if module == "output" or module.endswith(_AR_COLUMN):
        return 0  # the weight's rows, and a quantized one's per-row scale
    if module.endswith(_AR_ROW):
        return 1 if leaf == "weight" else None
    return None


_AR_COLUMN = ("attention.wq", "attention.wk", "attention.wv", "feed_forward.w1",
              "feed_forward.w3")  # the cross-attention's wq/wk/wv end the same way
_AR_ROW = ("attention.wo", "feed_forward.w2")


def ar_sharded_leaves(model: nn.Module) -> Dict[str, int]:
    """The parameters of an ``ARTransformer`` that ``shard_ar_params`` cut,
    by (one-device) name: their tp dimension (empty for a whole model)."""
    if getattr(model, "tp", None) is None:
        return {}
    dims = {n: _ar_dim(n) for n in named_leaves(model)}
    return {n: d for n, d in dims.items() if d is not None}


def ar_head_norm_leaves(model: nn.Module) -> set:
    """The self-attention's q and k RMSNorm scales of a tp-cut
    ``ARTransformer``: replicated, applied to this rank's heads only, so
    each tp rank's gradient of them is a part."""
    if getattr(model, "tp", None) is None or not model.cfg.use_qk_normalization:
        return set()
    return {f"layers.{i}.attention.{norm}.weight" for i in range(len(model.layers))
            for norm in ("q_norm", "k_norm")}


def ar_fsdp_dims(model: nn.Module) -> Dict[str, int]:
    """The dp dimension of each FSDP leaf of an ``ARTransformer``
    (``ar_param_pspecs(fsdp_axis="dp")``): the column linears' input
    dimension (P(dp, tp) on JAX's (in, out) weights: dim 1 here), the row
    linears' output dimension (P(tp, dp): dim 0); the token table, the LM
    head and the norms stay whole over dp."""
    out = {}
    for n in named_leaves(model):
        module, _, leaf = n.rpartition(".")
        if leaf != "weight":
            continue
        if module.endswith(_AR_COLUMN):
            out[n] = 1
        elif module.endswith(_AR_ROW):
            out[n] = 0
    return out


def ar_shard_dims(model: nn.Module) -> Dict[str, Optional[int]]:
    """The tp shard dimension of every entry of an ``ARTransformer``'s state
    dict (gen3c_tpu's ``ar_param_pspecs`` in the (out, in) layout): 0 for
    the column linears' weights and per-row scales, the LM head's and the
    token table's rows, 1 for the row linears' weights, None for the rest
    (norms, a row entry's scale, a quantized table's scale)."""
    return {k: _ar_dim(k) for k in model.state_dict()}


@torch.no_grad()
def shard_ar_params(model: nn.Module, groups: Groups) -> Dict[str, int]:
    """Cut an ``ARTransformer`` to this rank's tp shards in place (gen3c_tpu's
    ``shard_ar_params``) and set ``model.tp``, after which every forward
    and ``generate`` runs tensor-parallel. The heads and the KV heads must
    divide tp (each rank runs whole heads, the GQA ratio unchanged); the
    vocabulary and the MLP's hidden units must too. Every rank must hold
    the same weights before. Returns the cut entries' dimensions (nothing
    at tp 1; a model cut for this tp size already is left as it is)."""
    tp = groups.tp
    if tp.size == 1:
        return {}
    cfg = model.cfg
    if model.tp is not None:
        if model.tp.size != tp.size:
            raise ValueError(f"the model is cut to tp={model.tp.size} shards, not tp={tp.size}")
        return {k: d for k, d in ar_shard_dims(model).items() if d is not None}
    if cfg.n_heads % tp.size or cfg.n_kv_heads % tp.size:
        raise ValueError(f"n_heads={cfg.n_heads} and n_kv_heads={cfg.n_kv_heads} must divide "
                         f"tp={tp.size}: each rank runs whole query and KV heads")
    dims = {k: d for k, d in ar_shard_dims(model).items() if d is not None}
    for key, d in dims.items():
        owner_name, _, leaf = key.rpartition(".")
        owner = model.get_submodule(owner_name)
        t = getattr(owner, leaf)
        part = _narrow(t.detach(), d, tp).clone()
        if isinstance(t, nn.Parameter):
            part = nn.Parameter(part, requires_grad=t.requires_grad)
        setattr(owner, leaf, part)
        if leaf == "weight":
            if hasattr(owner, "out_features"):
                owner.out_features, owner.in_features = part.shape
            elif hasattr(owner, "num_embeddings"):
                owner.num_embeddings = part.shape[0]
    model.tp = tp
    return dims


@torch.no_grad()
def gather_to_host(state: dict, dims: Dict[str, int], tp: Axis, keep: bool,
                   fsdp: Optional[Dict[str, int]] = None, dp: Axis = Axis()) -> Optional[dict]:
    """The one-device form of a sharded state, in host memory, a tensor at
    a time: each tensor of ``state`` named in ``fsdp`` is gathered over dp
    along its dimension there, then each named in ``dims`` over tp along
    its own, and copied to the host before the next is gathered, so that
    the device holds one gathered tensor at most beside the state
    (gen3c_tpu saves with ``jax.device_get``, shard by shard); the other
    tensors are copied as they are, a nested dict (a
    ``TrainState.state_dict``'s params, moments, EMA) the same way,
    anything else kept. Every rank of the tp and dp axes must call this;
    the host copies are made and returned only where ``keep`` (the rank
    that writes), else None."""
    fsdp = fsdp or {}
    out = {} if keep else None
    for n, t in state.items():
        if isinstance(t, dict):
            t = gather_to_host(t, dims, tp, keep, fsdp, dp)
        elif n in dims or n in fsdp:
            # each gather's contiguous receive buffer, (n * shard, ...) with
            # its dimension first: the last copied as it lies, turned back
            # on the host
            if n in fsdp:
                t, d = collectives.all_gather(t, fsdp[n], dp), fsdp[n]
            if n in dims:
                t, d = collectives.all_gather(t, dims[n], tp), dims[n]
            t = t.movedim(d, 0).to("cpu", copy=True).movedim(0, d).contiguous() if keep else None
        elif torch.is_tensor(t) and keep:
            t = t.detach().to("cpu", copy=True)
        if keep:
            out[n] = t
    return out


def shard_tensors(tensors: Dict[str, torch.Tensor], dims: Dict[str, int], tp: Axis,
                  fsdp: Optional[Dict[str, int]] = None,
                  dp: Axis = Axis()) -> Dict[str, torch.Tensor]:
    """This rank's shard of a one-device state: ``gather_to_host``'s
    inverse, a slice over tp of a tensor named in ``dims``, then over dp of
    one named in ``fsdp``."""
    fsdp = fsdp or {}
    out = {}
    for n, t in tensors.items():
        if n in dims:
            t = _narrow(t, dims[n], tp)
        if n in fsdp:
            t = _narrow(t, fsdp[n], dp)
        out[n] = t
    return out
