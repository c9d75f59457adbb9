"""Parameter bridges from gen3c_tpu's trees to the port's state_dicts.

``dit_state_from_jax`` is the inverse of gen3c_tpu/models/convert.py
``convert_dit_state_dict``: it names every leaf of the JAX DiT tree with
the reference checkpoint's torch name and transposes the linears back to
(out, in). ``vae_state_from_jax`` is the identity, because the JAX VAE
params are already keyed by the reference names. Both take numpy-valued
trees (``jax.device_get`` output), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _a(x) -> torch.Tensor:
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: torch cannot wrap it
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr)


def _t(x) -> torch.Tensor:
    return _a(x).T.contiguous()


def dit_state_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX DiT param tree (numpy leaves) -> GeneralDIT state_dict."""
    sd: Dict[str, torch.Tensor] = {
        "x_embedder.proj.1.weight": _t(tree["x_embedder"]["w"]),
        "t_embedder.1.linear_1.weight": _t(tree["t_embedder"]["linear_1"]["w"]),
        "t_embedder.1.linear_2.weight": _t(tree["t_embedder"]["linear_2"]["w"]),
        "affline_norm.weight": _a(tree["affline_norm"]["scale"]),
        "extra_pos_embedder.pos_emb_t": _a(tree["extra_pos_emb"]["t"]),
        "extra_pos_embedder.pos_emb_h": _a(tree["extra_pos_emb"]["h"]),
        "extra_pos_embedder.pos_emb_w": _a(tree["extra_pos_emb"]["w"]),
        "final_layer.linear.weight": _t(tree["final"]["linear"]["w"]),
        "final_layer.adaLN_modulation.1.weight": _t(tree["final"]["adaln"]["w1"]),
        "final_layer.adaLN_modulation.2.weight": _t(tree["final"]["adaln"]["w2"]),
    }
    for i, blk in enumerate(tree["blocks"]):
        base = f"blocks.block{i}.blocks"
        for j, sub in enumerate(("fa", "ca")):
            p = blk[sub]
            pre = f"{base}.{j}.block.attn"
            sd[f"{pre}.to_q.0.weight"] = _t(p["q"]["w"])
            sd[f"{pre}.to_q.1.weight"] = _a(p["q_norm"]["scale"])
            sd[f"{pre}.to_k.0.weight"] = _t(p["k"]["w"])
            sd[f"{pre}.to_k.1.weight"] = _a(p["k_norm"]["scale"])
            sd[f"{pre}.to_v.0.weight"] = _t(p["v"]["w"])
            sd[f"{pre}.to_out.0.weight"] = _t(p["out"]["w"])
            sd[f"{base}.{j}.adaLN_modulation.1.weight"] = _t(p["adaln"]["w1"])
            sd[f"{base}.{j}.adaLN_modulation.2.weight"] = _t(p["adaln"]["w2"])
        mlp = blk["mlp"]
        sd[f"{base}.2.block.layer1.weight"] = _t(mlp["fc1"]["w"])
        sd[f"{base}.2.block.layer2.weight"] = _t(mlp["fc2"]["w"])
        sd[f"{base}.2.adaLN_modulation.1.weight"] = _t(mlp["adaln"]["w1"])
        sd[f"{base}.2.adaLN_modulation.2.weight"] = _t(mlp["adaln"]["w2"])
    return sd


def vae_state_from_jax(flat: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX VAE params (flat, reference-named, numpy leaves) -> CausalVAE state_dict."""
    return {k: _a(v) for k, v in flat.items()}
