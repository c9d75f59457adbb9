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
``vae_state_from_jax``). The auxiliary models: ``siglip_state_from_jax``
and ``safety_head_state_from_jax`` (the video safety filter),
``retinaface_state_from_jax`` (the face blur) and
``pixtral_vision_state_from_jax`` (the upsampler's vision tower; its text
model and the LLM guards take ``ar_state_from_jax``). All take numpy-valued
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


def _lin_b(name: str, entry: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX {"w" (in, out), "b"} linear -> ``name.weight`` (out, in), ``name.bias``."""
    return {f"{name}.weight": _t(entry["w"]), f"{name}.bias": _a(entry["b"])}


def _ln(name: str, entry: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _a(entry["scale"]), f"{name}.bias": _a(entry["bias"])}


def siglip_state_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """gen3c_tpu SigLIP vision tree (``convert_hf_siglip_vision``) ->
    aux.siglip.SiglipVisionModel state_dict: the patch matmul back to the
    (D, 3, ps, ps) convolution weight, the pooling head's q / k / v packed
    into ``in_proj_weight`` / ``in_proj_bias``."""
    w = _t(tree["patch"]["w"])  # (D, 3 * ps * ps)
    ps = int(round((w.shape[1] // 3) ** 0.5))
    sd = {"embeddings.patch_embedding.weight": w.reshape(w.shape[0], 3, ps, ps).contiguous(),
          "embeddings.patch_embedding.bias": _a(tree["patch"]["b"]),
          "embeddings.position_embedding.weight": _a(tree["pos_emb"]),
          **_ln("post_layernorm", tree["post_ln"])}
    for i, lp in enumerate(tree["layers"]):
        pre = f"encoder.layers.{i}"
        sd.update({**_ln(f"{pre}.layer_norm1", lp["ln1"]), **_ln(f"{pre}.layer_norm2", lp["ln2"]),
                   **_lin_b(f"{pre}.mlp.fc1", lp["mlp"]["fc1"]),
                   **_lin_b(f"{pre}.mlp.fc2", lp["mlp"]["fc2"])})
        for p in ("q", "k", "v", "out"):
            sd.update(_lin_b(f"{pre}.self_attn.{p}_proj", lp["attn"][p]))
    head = tree["head"]
    attn = head["attn"]
    sd.update({"head.probe": _a(head["probe"]),
               "head.attention.in_proj_weight": torch.cat([_t(attn[p]["w"]) for p in "qkv"]),
               "head.attention.in_proj_bias": torch.cat([_a(attn[p]["b"]) for p in "qkv"]),
               **_lin_b("head.attention.out_proj", attn["out"]), **_ln("head.layernorm", head["ln"]),
               **_lin_b("head.mlp.fc1", head["mlp"]["fc1"]),
               **_lin_b("head.mlp.fc2", head["mlp"]["fc2"])})
    return sd


def _bn(name: str, entry: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _a(entry["scale"]), f"{name}.bias": _a(entry["bias"]),
            f"{name}.running_mean": _a(entry["mean"]), f"{name}.running_var": _a(entry["var"])}


def safety_head_state_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """gen3c_tpu safety classifier tree ({"fc1", "bn1", "fc2", "bn2", "fc3"})
    -> aux.siglip.SafetyClassifier state_dict (``layers.{0,1,3,4,6}``)."""
    sd = {**_lin_b("layers.0", tree["fc1"]), **_bn("layers.1", tree["bn1"]),
          **_lin_b("layers.3", tree["fc2"]), **_bn("layers.4", tree["bn2"]),
          **_lin_b("layers.6", tree["fc3"])}
    for idx in (1, 4):
        sd[f"layers.{idx}.num_batches_tracked"] = torch.tensor(0)
    return sd


def retinaface_state_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """gen3c_tpu RetinaFace tree (``init_retinaface_params`` /
    ``convert_retinaface``) -> aux.retinaface.RetinaFace state_dict, under
    Resnet50_Final.pth's names."""
    def conv(name, p):
        out = {f"{name}.weight": _a(p["w"])}
        if "b" in p:
            out[f"{name}.bias"] = _a(p["b"])
        return out

    def cbn(name, p):
        return {**conv(f"{name}.0", p["conv"]), **_bn(f"{name}.1", p["bn"])}

    body = tree["body"]
    sd = {**conv("body.conv1", body["conv1"]), **_bn("body.bn1", body["bn1"])}
    for li in ("layer1", "layer2", "layer3", "layer4"):
        for i, blk in enumerate(body[li]):
            pre = f"body.{li}.{i}"
            for c in ("1", "2", "3"):
                sd.update({**conv(f"{pre}.conv{c}", blk[f"conv{c}"]),
                           **_bn(f"{pre}.bn{c}", blk[f"bn{c}"])})
            if "downsample" in blk:
                sd.update(cbn(f"{pre}.downsample", blk["downsample"]))
    for k, p in tree["fpn"].items():
        sd.update(cbn(f"fpn.{k}", p))
    for i in range(3):
        for k, p in tree[f"ssh{i + 1}"].items():
            sd.update(cbn(f"ssh{i + 1}.{k}", p))
        sd.update(conv(f"ClassHead.{i}.conv1x1", tree["ClassHead"][i]))
        sd.update(conv(f"BboxHead.{i}.conv1x1", tree["BboxHead"][i]))
    return sd


def pixtral_vision_state_from_jax(tree: Mapping[str, Any], num_channels: int = 3
                                  ) -> Dict[str, torch.Tensor]:
    """gen3c_tpu Pixtral vision tree (``init_vision_params`` /
    ``convert_hf_pixtral_vision``) -> aux.vision_encoder.VisionEncoder
    state_dict: the (C * P * P, D) patch matmul back to the (D, C, P, P)
    convolution, the linears to (out, in), the projector's biases."""
    w = _t(tree["patch_conv"])  # (D, C * P * P)
    P = int(round((w.shape[1] // num_channels) ** 0.5))
    sd = {"patch_conv.weight": w.reshape(w.shape[0], num_channels, P, P).contiguous(),
          "ln_pre.weight": _a(tree["ln_pre"]["scale"])}
    names = {"q": "attention.q_proj", "k": "attention.k_proj", "v": "attention.v_proj",
             "o": "attention.o_proj", "gate": "feed_forward.gate_proj",
             "up": "feed_forward.up_proj", "down": "feed_forward.down_proj"}
    for i, lp in enumerate(tree["layers"]):
        pre = f"transformer.layers.{i}"
        sd[f"{pre}.attention_norm.weight"] = _a(lp["attention_norm"]["scale"])
        sd[f"{pre}.ffn_norm.weight"] = _a(lp["ffn_norm"]["scale"])
        for k, name in names.items():
            sd[f"{pre}.{name}.weight"] = _t(lp[k])
    for part in ("linear_1", "linear_2"):
        sd.update(_lin_b(f"multi_modal_projector.{part}", tree["projector"][part]))
    return sd
