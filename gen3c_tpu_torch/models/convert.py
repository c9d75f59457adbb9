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
"""

from __future__ import annotations

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
