"""Reference GeneralDIT checkpoints -> the port's DiT (port of gen3c_tpu/models/convert.py).

The port's ``GeneralDIT`` keeps the reference's parameter names
(``bridge.py``), so a reference state dict loads with ``load_state_dict``
once ``dit_state_for_net`` has unwrapped and accounted for its keys:

  * the {"model", "ema"} wrapper and the '-'-mangled EMA keys
    (``normalize_reference_checkpoint``);
  * a leading "net." on every key;
  * keys with no parameter: TransformerEngine "_extra_state" (FP8
    metadata), the EDM ``logvar`` head (training only,
    ``convert_logvar_state_dict``) and the RoPE buffers under
    "pos_embedder." (the learnable "extra_pos_embedder." loads);
  * the legacy Conv3d patch embedding ``x_embedder.proj.weight`` (D, C,
    pt, ph, pw), reshaped to the Linear ``x_embedder.proj.1.weight``;
  * the augment-sigma and action embedders, which JAX's converter carries
    but the GEN3C forward never reads (forward-dead under AdaLN-LoRA; the
    port's GEN3C net has no such parameters): accounted for and dropped.
    An ``ActionDiT`` (models/dit_action.py) has the action embedders, so
    for it they load like any other parameter.

``convert_multiview_dit_state_dict`` builds gen3c_tpu's multiview tree
from a Sample-AV state dict; the port's ``MultiviewGeneralDIT`` loads the
same state dict through ``dit_state_for_net`` (its sincos position tables
are not in a checkpoint, and it has no learnable extra position slots).

``strict=True`` raises on any other key the net does not have, as
``convert_dit_state_dict(strict=True)`` does. ``convert_dit_state_dict``
itself is here too: it builds the JAX package's parameter tree (linears
transposed to (in, out)) from the same state dict, which is what
``utils.checkpoint.save_params_npz`` writes as ``gen3c_tpu/dit.npz``.

The AR world model's converters (gen3c_tpu/models/convert.py:236-490) give
the state dict of the port's ``models.ar_transformer.ARTransformer``,
whose keys are the reference Cosmos AR names: ``convert_cosmos_ar_state_dict``
selects and casts a Cosmos AR checkpoint's keys, ``convert_hf_llama`` maps
a Hugging Face LlamaForCausalLM's. ``shard_ar_tp_state_dict`` and
``merge_ar_tp_state_dicts`` cut a Cosmos AR state dict into Megatron
tensor-parallel shards and join them again (checkpoint format only).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Iterable, Mapping, Optional

import torch

from gen3c_tpu_torch.models.dit import DiTConfig
from gen3c_tpu_torch.utils import log

# JAX's converter consumes these when present; the GEN3C forward reads none
_CARRIED = ("augment_sigma_embedder.", "action_embedder_B_D.", "action_embedder_B_3D.")


def _a(x) -> torch.Tensor:
    return torch.as_tensor(x)


def _t(x) -> torch.Tensor:
    return _a(x).T.contiguous()


def normalize_reference_checkpoint(ckpt: Mapping[str, Any], use_ema: bool = False
                                   ) -> Dict[str, Any]:
    """Unwrap a reference checkpoint dict to a flat state dict: {"model":
    sd, "ema": ema_sd} gives "model"'s weights, with ``use_ema`` the EMA
    weights laid over them, their "-"-mangled keys ("net-blocks-block0...")
    mapped back to "."; any other dict is returned as it is."""
    if "model" in ckpt and isinstance(ckpt["model"], Mapping):
        sd = dict(ckpt["model"])
        if use_ema and isinstance(ckpt.get("ema"), Mapping):
            sd.update({k.replace("-", "."): v for k, v in ckpt["ema"].items()})
        return sd
    return dict(ckpt)


def _skippable(key: str) -> bool:
    """Keys with no DiT parameter: TE FP8 metadata, the EDM logvar head and
    the RoPE position buffers (not the learnable extra_pos_embedder)."""
    if "_extra_state" in key:
        return True
    k = key[4:] if key.startswith("net.") else key
    return k.startswith(("logvar", "pos_embedder."))


def convert_logvar_state_dict(state_dict: Mapping[str, Any],
                              dtype: torch.dtype = torch.float32
                              ) -> Optional[Dict[str, torch.Tensor]]:
    """The EDM logvar head (Sequential(FourierFeatures(128), Linear(128, 1,
    bias=False))) as ``training.losses.LogvarHead``'s state dict {"freqs",
    "phases", "w" (128, 1)}, or None when the checkpoint has none. Keys may
    carry a leading "model."."""
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("model."):
            k = k[len("model."):]
        if k.startswith("logvar."):
            sd[k] = v
    if not sd:
        return None
    return {"freqs": _a(sd["logvar.0.freqs"]).to(dtype),
            "phases": _a(sd["logvar.0.phases"]).to(dtype),
            "w": _t(sd["logvar.1.weight"]).to(dtype)}


def _stripped(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the skippable keys and the "net." prefix; reshape the legacy
    Conv3d patch embedding into the Linear's layout (the Rearrange "(c r m
    n)" + Linear of the inference net: a pure reshape)."""
    sd = {}
    for k, v in state_dict.items():
        if _skippable(k):
            continue
        sd[k[len("net."):] if k.startswith("net.") else k] = v
    if "x_embedder.proj.weight" in sd:
        w = _a(sd.pop("x_embedder.proj.weight"))
        sd["x_embedder.proj.1.weight"] = w.reshape(w.shape[0], -1)
    return sd


def _drift(leftover) -> ValueError:
    leftover = sorted(leftover)
    return ValueError(f"{len(leftover)} unconsumed checkpoint keys (key-mapping drift?): "
                      f"{leftover[:8]}{'...' if len(leftover) > 8 else ''}")


def dit_state_for_net(state_dict: Mapping[str, Any], expected: Iterable[str],
                      strict: bool = True) -> Dict[str, torch.Tensor]:
    """A reference DiT state dict -> the state dict of a ``GeneralDIT``
    whose keys are ``expected`` (``net.state_dict().keys()``). strict:
    raise ValueError on any key that is neither expected, skippable nor
    carried; otherwise drop it. Keys the net has and the checkpoint lacks
    are left for ``load_state_dict`` to report."""
    sd = _stripped(state_dict)
    expected = set(expected)
    carried = sorted(k for k in sd if k not in expected and k.startswith(_CARRIED))
    if carried:
        log.info(f"checkpoint: {len(carried)} augment-sigma / action embedder keys the GEN3C "
                 f"forward does not read, dropped")
    leftover = set(sd) - expected - set(carried)
    if strict and leftover:
        raise _drift(leftover)
    return {k: _a(v) for k, v in sd.items() if k in expected}


def convert_dit_state_dict(state_dict: Mapping[str, Any], cfg: DiTConfig,
                           dtype: torch.dtype = torch.float32, strict: bool = False
                           ) -> Dict[str, Any]:
    """A reference DiT state dict -> gen3c_tpu's DiT parameter tree, leaves
    torch tensors in ``dtype``, linears transposed to (in, out). strict
    raises if a key is neither consumed nor skippable."""
    sd = _stripped(state_dict)
    consumed = set()

    def get(key):
        consumed.add(key)
        return sd[key]

    def w(key):
        return {"w": _t(get(key))}

    def attn(prefix):
        return {"q": w(f"{prefix}.to_q.0.weight"), "k": w(f"{prefix}.to_k.0.weight"),
                "v": w(f"{prefix}.to_v.0.weight"), "out": w(f"{prefix}.to_out.0.weight"),
                "q_norm": {"scale": _a(get(f"{prefix}.to_q.1.weight"))},
                "k_norm": {"scale": _a(get(f"{prefix}.to_k.1.weight"))}}

    def adaln(prefix):
        return {"w1": _t(get(f"{prefix}.1.weight")), "w2": _t(get(f"{prefix}.2.weight"))}

    blocks = []
    for i in range(cfg.num_blocks):
        base = f"blocks.block{i}.blocks"
        fa = attn(f"{base}.0.block.attn")
        fa["adaln"] = adaln(f"{base}.0.adaLN_modulation")
        ca = attn(f"{base}.1.block.attn")
        ca["adaln"] = adaln(f"{base}.1.adaLN_modulation")
        mlp = {"fc1": w(f"{base}.2.block.layer1.weight"), "fc2": w(f"{base}.2.block.layer2.weight"),
               "adaln": adaln(f"{base}.2.adaLN_modulation")}
        blocks.append({"fa": fa, "ca": ca, "mlp": mlp})
    params: Dict[str, Any] = {
        "x_embedder": w("x_embedder.proj.1.weight"),
        "t_embedder": {"linear_1": w("t_embedder.1.linear_1.weight"),
                       "linear_2": w("t_embedder.1.linear_2.weight")},
        "affline_norm": {"scale": _a(get("affline_norm.weight"))},
        "extra_pos_emb": {a: _a(get(f"extra_pos_embedder.pos_emb_{a}")) for a in "thw"},
        "blocks": blocks,
        "final": {"linear": w("final_layer.linear.weight"),
                  "adaln": adaln("final_layer.adaLN_modulation")},
    }
    if "augment_sigma_embedder.1.linear_1.weight" in sd:
        emb = {b: w(f"augment_sigma_embedder.1.{b}.weight") for b in ("linear_1", "linear_2")}
        for b in ("linear_1", "linear_2"):
            if f"augment_sigma_embedder.1.{b}.bias" in sd:  # the non-LoRA variant's biases
                emb[b]["b"] = _a(get(f"augment_sigma_embedder.1.{b}.bias"))
        params["augment_sigma_embedder"] = emb
    if "action_embedder_B_3D.fc1.weight" in sd:
        def mlp2(prefix):
            return {f: {"w": _t(get(f"{prefix}.{f}.weight")), "b": _a(get(f"{prefix}.{f}.bias"))}
                    for f in ("fc1", "fc2")}

        params["action_embedder_B_D"] = mlp2("action_embedder_B_D")
        params["action_embedder_B_3D"] = mlp2("action_embedder_B_3D")
    if strict and set(sd) - consumed:
        raise _drift(set(sd) - consumed)
    return _map(params, lambda x: x.to(dtype))


def convert_multiview_dit_state_dict(state_dict: Mapping[str, Any], cfg,
                                     dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """A reference MultiviewGeneralDIT state dict (the Sample-AV models) ->
    gen3c_tpu's multiview tree (gen3c_tpu/models/convert.py:296-330): the
    GeneralDIT mapping, with zero learnable extra position slots where the
    checkpoint has none (the multiview forward ignores them), plus
    ``view_embeddings`` (nn.Embedding, (V, vc)) and the optional
    ``repeat_frame_embedding`` (nn.Linear(1, vc): w (1, vc), b (vc,)).
    "net." is stripped; logvar and TE "_extra_state" keys are skipped."""
    sd = {}
    for k, v in state_dict.items():
        if "_extra_state" in k or k.startswith("logvar"):
            continue
        sd[k[len("net."):] if k.startswith("net.") else k] = v
    D = cfg.model_channels
    for name, n in (("t", cfg.len_t), ("h", cfg.len_h), ("w", cfg.len_w)):
        sd.setdefault(f"extra_pos_embedder.pos_emb_{name}", torch.zeros((n, D)))
    params = convert_dit_state_dict(sd, cfg, dtype)
    params["view_embeddings"] = _a(sd["view_embeddings.weight"]).to(dtype)
    if "repeat_frame_embedding.weight" in sd:
        params["repeat_frame_embedding"] = {
            "w": _t(sd["repeat_frame_embedding.weight"]).to(dtype),
            "b": _a(sd["repeat_frame_embedding.bias"]).to(dtype)}
    return params


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _ar_get(state_dict: Mapping[str, Any], dtype: torch.dtype):
    def get(name: str) -> torch.Tensor:
        v = state_dict[name]
        v = v.detach().float().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        return v.to(dtype).contiguous()
    return get


def convert_hf_llama(state_dict: Mapping[str, Any], cfg, dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, torch.Tensor]:
    """A Hugging Face LlamaForCausalLM state dict -> ARTransformer state
    dict, every tensor in ``dtype`` (default cfg.dtype; the norm scales too,
    which the module then holds in fp32 with those values), as
    convert.py:236-291. HF's q/k are in the rotate-half layout of
    ``_apply_rope``; a checkpoint without lm_head ties the output to the
    token table."""
    get = _ar_get(state_dict, dtype or cfg.dtype)
    names = {"self_attn.q_proj": "attention.wq", "self_attn.k_proj": "attention.wk",
             "self_attn.v_proj": "attention.wv", "self_attn.o_proj": "attention.wo",
             "mlp.gate_proj": "feed_forward.w1", "mlp.down_proj": "feed_forward.w2",
             "mlp.up_proj": "feed_forward.w3", "input_layernorm": "attention_norm",
             "post_attention_layernorm": "ffn_norm"}
    out = {"tok_embeddings.weight": get("model.embed_tokens.weight"),
           "norm.weight": get("model.norm.weight"),
           "output.weight": get("lm_head.weight" if "lm_head.weight" in state_dict
                                else "model.embed_tokens.weight")}
    for i in range(cfg.n_layers):
        for hf, ours in names.items():
            out[f"layers.{i}.{ours}.weight"] = get(f"model.layers.{i}.{hf}.weight")
    return out


def convert_cosmos_ar_state_dict(state_dict: Mapping[str, Any], cfg,
                                 dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """A reference Cosmos AR transformer state dict (llama names, per-head
    q_norm / k_norm, cross-attention when cfg.context_dim) -> ARTransformer
    state dict: the keys the config uses, in ``dtype`` (default cfg.dtype),
    as convert.py:437-490."""
    get = _ar_get(state_dict, dtype or cfg.dtype)
    keys = ["tok_embeddings.weight", "norm.weight", "output.weight"]
    for i in range(cfg.n_layers):
        pre = f"layers.{i}"
        keys += [f"{pre}.attention.{w}.weight" for w in ("wq", "wk", "wv", "wo")]
        keys += [f"{pre}.feed_forward.{w}.weight" for w in ("w1", "w2", "w3")]
        keys += [f"{pre}.attention_norm.weight", f"{pre}.ffn_norm.weight"]
        if cfg.use_qk_normalization:
            keys += [f"{pre}.attention.q_norm.weight", f"{pre}.attention.k_norm.weight"]
        if cfg.context_dim:
            keys.append(f"{pre}.cross_attention_norm.weight")
            keys += [f"{pre}.cross_attention.{w}.weight" for w in ("wq", "wk", "wv", "wo")]
    return {k: get(k) for k in keys}


def _split(v: torch.Tensor, tp: int, dim: int, rank: int) -> torch.Tensor:
    if v.shape[dim] % tp:
        raise ValueError(f"cannot split {tuple(v.shape)} into {tp} equal parts along {dim}")
    return v.chunk(tp, dim=dim)[rank]


def shard_ar_tp_state_dict(state_dict: Mapping[str, Any], tp: int, rank: int, n_heads: int,
                           n_kv_heads: int, dim: int, context_dim: Optional[int] = None
                           ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s Megatron tensor-parallel shard of a Cosmos AR state
    dict (convert.py:331-375): wq / wk / wv split head-major on the output
    dim, w1 / w3 / the token table / the output column-split, w2 / wo
    row-split, norms replicated. Keys keep an optional "model." prefix."""
    out = {}
    for full_key, v in state_dict.items():
        key = full_key[len("model."):] if full_key.startswith("model.") else full_key
        v = torch.as_tensor(v)
        if key.startswith("layers."):
            if ".attention.wq.weight" in key or "cross_attention.wq.weight" in key:
                v = _split(v.reshape(n_heads, -1, dim), tp, 0, rank).reshape(-1, dim)
            elif ".attention.wk.weight" in key or ".attention.wv.weight" in key:
                v = _split(v.reshape(n_kv_heads, -1, dim), tp, 0, rank).reshape(-1, dim)
            elif "cross_attention.wk.weight" in key or "cross_attention.wv.weight" in key:
                if context_dim is None:
                    raise ValueError("cross-attention shards need context_dim")
                v = _split(v.reshape(n_kv_heads, -1, context_dim), tp, 0, rank)
                v = v.reshape(-1, context_dim)
            elif "feed_forward.w1.weight" in key or "feed_forward.w3.weight" in key:
                v = _split(v, tp, 0, rank)
            elif ("feed_forward.w2.weight" in key or ".attention.wo.weight" in key
                  or "cross_attention.wo.weight" in key):
                v = _split(v, tp, 1, rank)
        elif key in ("tok_embeddings.weight", "output.weight"):
            v = _split(v, tp, 0, rank)
        out[full_key] = v.contiguous()
    return out


def merge_ar_tp_state_dicts(shards: list, n_heads: int, n_kv_heads: int, dim: int,
                            context_dim: Optional[int] = None, head_dim: Optional[int] = None
                            ) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_ar_tp_state_dict`` (convert.py:377-434):
    head-major concatenation for q / k / v, column or row concatenation for
    the rest, replicated tensors averaged after a closeness check against
    the mean (atol 5e-2, rtol 0.1; a mismatch raises). The mean is numpy's
    over the stacked shards: summed shard after shard, then divided."""
    tp = len(shards)
    head_dim = dim // n_heads if head_dim is None else head_dim
    n_local_heads, n_local_kv = n_heads // tp, n_kv_heads // tp
    merged = {}
    for full_key in shards[0]:
        key = full_key[len("model."):] if full_key.startswith("model.") else full_key
        vals = [torch.as_tensor(s[full_key]) for s in shards]
        if key in ("tok_embeddings.weight", "output.weight"):
            merged[full_key] = torch.cat(vals, dim=0)
        elif ".attention.wq.weight" in key or "cross_attention.wq.weight" in key:
            merged[full_key] = torch.cat([v.reshape(n_local_heads, head_dim, dim) for v in vals],
                                         dim=0).reshape(head_dim * n_heads, dim)
        elif ".attention.wk.weight" in key or ".attention.wv.weight" in key:
            merged[full_key] = torch.cat([v.reshape(n_local_kv, head_dim, dim) for v in vals],
                                         dim=0).reshape(head_dim * n_kv_heads, dim)
        elif "cross_attention.wk.weight" in key or "cross_attention.wv.weight" in key:
            if context_dim is None:
                raise ValueError("cross-attention shards need context_dim")
            merged[full_key] = torch.cat(
                [v.reshape(n_local_kv, head_dim, context_dim) for v in vals],
                dim=0).reshape(head_dim * n_kv_heads, context_dim)
        elif "feed_forward.w1.weight" in key or "feed_forward.w3.weight" in key:
            merged[full_key] = torch.cat(vals, dim=0)
        elif ("feed_forward.w2.weight" in key or ".attention.wo.weight" in key
              or "cross_attention.wo.weight" in key):
            merged[full_key] = torch.cat(vals, dim=1)
        else:
            avg = functools.reduce(torch.add, vals) / tp
            if not torch.allclose(vals[0], avg, atol=5e-2, rtol=0.1):
                raise ValueError(f"replicated tensor {full_key} differs across shards")
            if "norm" not in key and vals[0].ndim > 1:
                raise ValueError(f"unexpected replicated key {full_key}")
            merged[full_key] = avg
    return merged
