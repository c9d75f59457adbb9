"""Parameter bridges from gen3c_tpu's trees to the port's state_dicts.

``dit_state_from_jax`` is the inverse of gen3c_tpu/models/convert.py
``convert_dit_state_dict``: it names every leaf of the JAX DiT tree with
the reference checkpoint's torch name and transposes the linears back to
(out, in). A quantized linear ({"q" | "q8", "scale"}, from
gen3c_tpu/models/quantize.py) becomes the ``weight`` (int8 codes, (out,
in)) and ``scale`` ((out,)) of a ``models.quantize.QuantLinear``; the net
must have been given that structure (``quantize_dit_``) before loading. ``vae_state_from_jax`` is the identity, because the JAX VAE
params are already keyed by the reference names. ``multiview_state_from_jax``
and ``action_state_from_jax`` carry the multiview and action nets' trees
(``net_state_from_jax`` picks by the tree's keys). ``train_params_from_jax``
carries a training tree across, the logvar head and its {"net", "logvar"}
wrapper included; ``lora_state_from_jax`` the LoRA adapters;
``ar_state_from_jax`` the AR world model's transformer and
``dd_state_from_jax`` its diffusion decoder (the DV tokenizer takes
``vae_state_from_jax``). All take numpy-valued
trees (``jax.device_get`` output, or the numpy and bf16 torch leaves of
``utils.checkpoint.load_params_npz_tree``), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _a(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # a bf16 leaf of utils.checkpoint.load_params_npz_tree
        return x
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: torch cannot wrap it
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr)


def _t(x) -> torch.Tensor:
    return _a(x).T.contiguous()


def _linear(name: str, entry: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX linear entry {"w"} or {"q" | "q8", "scale"} -> state_dict items."""
    if "w" in entry:
        return {f"{name}.weight": _t(entry["w"])}
    codes = entry["q"] if "q" in entry else entry["q8"]
    return {f"{name}.weight": _t(codes), f"{name}.scale": _a(entry["scale"]).reshape(-1)}


def dit_state_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX DiT param tree (numpy leaves) -> GeneralDIT state_dict."""
    sd: Dict[str, torch.Tensor] = {
        **_linear("x_embedder.proj.1", tree["x_embedder"]),
        **_linear("t_embedder.1.linear_1", tree["t_embedder"]["linear_1"]),
        **_linear("t_embedder.1.linear_2", tree["t_embedder"]["linear_2"]),
        "affline_norm.weight": _a(tree["affline_norm"]["scale"]),
        "extra_pos_embedder.pos_emb_t": _a(tree["extra_pos_emb"]["t"]),
        "extra_pos_embedder.pos_emb_h": _a(tree["extra_pos_emb"]["h"]),
        "extra_pos_embedder.pos_emb_w": _a(tree["extra_pos_emb"]["w"]),
        **_linear("final_layer.linear", tree["final"]["linear"]),
        "final_layer.adaLN_modulation.1.weight": _t(tree["final"]["adaln"]["w1"]),
        "final_layer.adaLN_modulation.2.weight": _t(tree["final"]["adaln"]["w2"]),
    }
    for i, blk in enumerate(tree["blocks"]):
        base = f"blocks.block{i}.blocks"
        for j, sub in enumerate(("fa", "ca")):
            p = blk[sub]
            pre = f"{base}.{j}.block.attn"
            sd.update(_linear(f"{pre}.to_q.0", p["q"]))
            sd[f"{pre}.to_q.1.weight"] = _a(p["q_norm"]["scale"])
            sd.update(_linear(f"{pre}.to_k.0", p["k"]))
            sd[f"{pre}.to_k.1.weight"] = _a(p["k_norm"]["scale"])
            sd.update(_linear(f"{pre}.to_v.0", p["v"]))
            sd.update(_linear(f"{pre}.to_out.0", p["out"]))
            sd[f"{base}.{j}.adaLN_modulation.1.weight"] = _t(p["adaln"]["w1"])
            sd[f"{base}.{j}.adaLN_modulation.2.weight"] = _t(p["adaln"]["w2"])
        mlp = blk["mlp"]
        sd.update(_linear(f"{base}.2.block.layer1", mlp["fc1"]))
        sd.update(_linear(f"{base}.2.block.layer2", mlp["fc2"]))
        sd[f"{base}.2.adaLN_modulation.1.weight"] = _t(mlp["adaln"]["w1"])
        sd[f"{base}.2.adaLN_modulation.2.weight"] = _t(mlp["adaln"]["w2"])
    return sd


def multiview_state_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A gen3c_tpu multiview DiT tree (``init_multiview_dit_params`` or
    ``convert_multiview_dit_state_dict``) -> MultiviewGeneralDIT state_dict:
    ``dit_state_from_jax`` without the learnable extra position slots (the
    multiview forward ignores them; the port's net has none), plus
    ``view_embeddings.weight`` (V, vc) and the repeat-frame Linear(1, vc)."""
    sd = {k: v for k, v in dit_state_from_jax(tree).items()
          if not k.startswith("extra_pos_embedder.")}
    sd["view_embeddings.weight"] = _a(tree["view_embeddings"])
    if "repeat_frame_embedding" in tree:
        sd["repeat_frame_embedding.weight"] = _t(tree["repeat_frame_embedding"]["w"])
        sd["repeat_frame_embedding.bias"] = _a(tree["repeat_frame_embedding"]["b"])
    return sd


def action_state_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A gen3c_tpu action DiT tree (``init_action_dit_params``) -> ActionDiT
    state_dict: ``dit_state_from_jax`` plus both action MLPs, fc1 / fc2
    weights transposed to (out, in)."""
    sd = dit_state_from_jax(tree)
    for name in ("action_embedder_B_D", "action_embedder_B_3D"):
        for fc in ("fc1", "fc2"):
            sd[f"{name}.{fc}.weight"] = _t(tree[name][fc]["w"])
            sd[f"{name}.{fc}.bias"] = _a(tree[name][fc]["b"])
    return sd


def net_state_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Any gen3c_tpu DiT tree -> the state_dict of the port's net of its
    kind (multiview, action or the single-stream GeneralDIT)."""
    if "view_embeddings" in tree:
        return multiview_state_from_jax(tree)
    if "action_embedder_B_3D" in tree:
        return action_state_from_jax(tree)
    return dit_state_from_jax(tree)


def logvar_state_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX logvar head ({"freqs", "phases", "w"}, losses.py
    ``init_logvar_params``) -> training.losses.LogvarHead state_dict; the
    same names and shapes (w stays (C, 1))."""
    return {k: _a(tree[k]) for k in ("freqs", "phases", "w")}


def train_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The tree gen3c_tpu's train step trains -> the state_dict of the
    module the port's trains: a DiT tree as ``dit_state_from_jax``; the
    ``loss_add_logvar`` wrapper {"net", "logvar"} as
    training.train_step.NetWithLogvar (``net.*``, ``logvar.*``)."""
    if "net" not in tree:
        return net_state_from_jax(tree)
    return {**{f"net.{k}": v for k, v in net_state_from_jax(tree["net"]).items()},
            **{f"logvar.{k}": v for k, v in logvar_state_from_jax(tree["logvar"]).items()}}


def lora_state_from_jax(tree: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """gen3c_tpu LoRA adapters {path: {"a": (in, r), "b": (r, out)}} (numpy
    leaves) -> training.lora's adapters: the same paths and orientation."""
    return {path: {"a": _a(ab["a"]), "b": _a(ab["b"])} for path, ab in tree.items()}


def vae_state_from_jax(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX VAE params (flat, reference-named, numpy leaves) -> CausalVAE state_dict."""
    return {k: _a(v) for k, v in flat.items()}


def ar_state_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """gen3c_tpu AR tree (``init_ar_params`` / its converters, raw or
    ``quantize_ar_params``-quantized leaves) -> ARTransformer state_dict:
    linears transposed to (out, in) under the Cosmos AR names; a quantized
    token table's (1, dim) scale flattened (the network must have the
    quantized structure: ``quantize_ar_params(..., structure_only=True)``)."""
    def lin(name, w):
        return _linear(name, w if isinstance(w, Mapping) else {"w": w})

    table = tree["tok_embeddings"]
    if isinstance(table, Mapping):
        codes = table["q"] if "q" in table else table["q8"]
        sd = {"tok_embeddings.weight": _a(codes),
              "tok_embeddings.scale": _a(table["scale"]).reshape(-1)}
    else:
        sd = {"tok_embeddings.weight": _a(table)}
    sd["norm.weight"] = _a(tree["norm"]["scale"])
    sd.update(lin("output", tree["output"]))
    names = {"wq": "attention.wq", "wk": "attention.wk", "wv": "attention.wv",
             "wo": "attention.wo", "w1": "feed_forward.w1", "w2": "feed_forward.w2",
             "w3": "feed_forward.w3", "cwq": "cross_attention.wq", "cwk": "cross_attention.wk",
             "cwv": "cross_attention.wv", "cwo": "cross_attention.wo"}
    norms = {"attention_norm": "attention_norm", "ffn_norm": "ffn_norm",
             "q_norm": "attention.q_norm", "k_norm": "attention.k_norm",
             "cross_norm": "cross_attention_norm"}
    for i, lp in enumerate(tree["layers"]):
        for k, v in lp.items():
            if k in names:
                sd.update(lin(f"layers.{i}.{names[k]}", v))
            else:
                sd[f"layers.{i}.{norms[k]}.weight"] = _a(v["scale"])
    return sd


def dd_state_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """gen3c_tpu diffusion-decoder tree (``init_dd_params``: a DiT tree plus
    "token_embedder.weight" (vocab, dim)) -> DiffusionDecoderDiT state_dict."""
    sd = dit_state_from_jax({k: v for k, v in tree.items() if k != "token_embedder.weight"})
    sd["token_embedder.weight"] = _a(tree["token_embedder.weight"])
    return sd
