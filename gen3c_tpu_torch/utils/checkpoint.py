"""Checkpoint loading for GEN3C-Cosmos weights (port of gen3c_tpu/utils/checkpoint.py).

The reference distributes:
  * the 7B DiT as a torch pickle ``model.pt`` (EMA keys name-mangled with
    '-'), whose keys are the port's own parameter names once unwrapped
    (``models.convert.normalize_reference_checkpoint``);
  * the CV8x8x8 tokenizer as TorchScript ``encoder.jit`` / ``decoder.jit``
    archives plus ``mean_std.pt``.

The npz layer reads and writes the JAX package's native checkpoints
(``gen3c_tpu/dit.npz``, ``dit_{int8,w8a8}.npz``, ``vae.npz``): one array a
leaf, named by its path in the JAX parameter tree ("['blocks']/[0]/['fa']/
['q']/['w']"), every bf16 leaf stored as a uint16 view under a "::bf16"
suffix. The bf16 leaves are rebuilt with torch alone (no ml_dtypes), so a
"::bf16" entry comes back as a bf16 torch tensor and every other entry as
a numpy array.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from gen3c_tpu_torch.utils import log

Array = Union[np.ndarray, torch.Tensor]
_BF16_TAG = "::bf16"


def load_torch_dit_checkpoint(path: str, use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """The reference ``model.pt`` as a flat state dict: the {"model", "ema"}
    wrapper unwrapped to "model", with ``use_ema`` the de-mangled EMA
    weights laid over it (``normalize_reference_checkpoint``). The file is
    read with ``weights_only=True`` first and as a full pickle if that
    fails (post-trained checkpoints need it). Keys and dtypes are as stored:
    ``models.convert.dit_state_for_net`` accounts for them."""
    from gen3c_tpu_torch.models.convert import normalize_reference_checkpoint

    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # noqa: BLE001 - post-trained checkpoints need the full pickle
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict):
        sd = normalize_reference_checkpoint(sd, use_ema=use_ema)
    return sd


def load_torchscript_tokenizer(
        vae_dir: str) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
    """(flat fp32 tokenizer weights, latent_mean, latent_std) from the
    TorchScript archives of a ``Cosmos-Tokenize1-*`` directory and its
    ``mean_std.pt`` (None where absent). TorchScript keeps the eager
    network's parameter names; ``vae_state_dict`` drops the wavelet and
    index buffers that have no parameter."""
    params: Dict[str, torch.Tensor] = {}
    for part in ("encoder", "decoder"):
        jit_path = os.path.join(vae_dir, f"{part}.jit")
        if not os.path.exists(jit_path):
            continue
        mod = torch.jit.load(jit_path, map_location="cpu")
        params.update({k: v for k, v in mod.state_dict().items() if isinstance(v, torch.Tensor)})
    flat = vae_state_dict({k: v.float() for k, v in params.items()})
    mean = std = None
    ms_path = os.path.join(vae_dir, "mean_std.pt")
    if os.path.exists(ms_path):
        latent_mean, latent_std = torch.load(ms_path, map_location="cpu", weights_only=True)
        mean, std = latent_mean.float(), latent_std.float()
    return flat, mean, std


def vae_state_dict(state_dict: Dict[str, Array]) -> Dict[str, torch.Tensor]:
    """A reference tokenizer state dict -> fp32 CausalVAE state dict: the
    same names, without the wavelet, arange and patch-size buffers
    (gen3c_tpu/models/vae.py ``convert_vae_state_dict``)."""
    return {k: torch.as_tensor(v).float() for k, v in state_dict.items()
            if not ("wavelets" in k or "_arange" in k or "patch_size_buffer" in k)}


# ------------------------- native npz round-trip -------------------------


def _key_name(key: Union[str, int]) -> str:
    """A tree key as jax.tree_util spells it in a path: "['name']" or "[i]"."""
    return f"[{key}]" if isinstance(key, int) else f"[{key!r}]"


def flatten_params(tree: Any, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs of a nested dict / list tree in jax.tree_util's
    order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_params(tree[k], prefix + (_key_name(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_params(v, prefix + (_key_name(i),))
    else:
        yield "/".join(prefix), tree


def save_params_npz(path: str, params: Any) -> None:
    """A nested dict / list tree of tensors or arrays -> the npz that
    gen3c_tpu's ``save_params_npz`` writes for the same tree: path-encoded
    names, each bf16 leaf as its uint16 bits under "::bf16"."""
    flat = {}
    for name, leaf in flatten_params(params):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                flat[name + _BF16_TAG] = leaf.view(torch.int16).numpy().view(np.uint16)
                continue
            leaf = leaf.numpy()
        flat[name] = np.asarray(leaf)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    log.info(f"Saved {len(flat)} arrays to {path}")


def _restore_npz_entry(name: str, arr: np.ndarray) -> Tuple[str, Array]:
    """Undo the "::bf16" tagging -> (clean name, array): a tagged entry
    becomes a bf16 tensor with the stored bits, any other stays numpy."""
    if name.endswith(_BF16_TAG):
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return name[:-len(_BF16_TAG)], bits.view(torch.bfloat16)
    return name, arr


def load_flat_npz(path: str) -> Dict[str, Array]:
    """{name: array} of an npz with the bf16 tagging undone: the flat view
    under ``load_params_npz_tree`` / ``load_params_npz`` and the flat-dict
    loaders (the VAE's ``vae.npz``)."""
    data = np.load(path)
    return dict(_restore_npz_entry(raw, data[raw]) for raw in data.files)


def _parse_key(seg: str) -> Union[str, int]:
    if seg.startswith("['"):
        return seg[2:-2]
    if seg.startswith("["):
        return int(seg[1:-1])
    return seg


def load_params_npz_tree(path: str) -> Any:
    """The nested dict / list tree of a ``save_params_npz`` file, rebuilt
    from its path-encoded names without a template, every leaf in its saved
    dtype (int8 codes and fp32 scales for a quantized tree)."""
    def slot(node, k):
        if isinstance(k, int):
            while len(node) <= k:
                node.append(None)

    out: Any = None
    for name, leaf in load_flat_npz(path).items():
        keys = [_parse_key(s) for s in name.split("/")]
        if out is None:
            out = [] if isinstance(keys[0], int) else {}
        node = out
        for k, nxt in zip(keys[:-1], keys[1:]):
            slot(node, k)
            if isinstance(k, int):
                if node[k] is None:
                    node[k] = [] if isinstance(nxt, int) else {}
            elif k not in node:
                node[k] = [] if isinstance(nxt, int) else {}
            node = node[k]
        slot(node, keys[-1])
        node[keys[-1]] = leaf
    return out


def load_params_npz(path: str, like: Any, dtype: Optional[torch.dtype] = None) -> Any:
    """An npz saved by ``save_params_npz`` in the structure of ``like`` (a
    nested dict / list tree of tensors): each leaf a tensor in ``dtype`` or
    in the dtype of the leaf of ``like`` it replaces. A name ``like`` has
    and the file lacks raises KeyError."""
    by_name = load_flat_npz(path)

    def fill(tree, prefix):
        if isinstance(tree, dict):
            return {k: fill(v, prefix + (_key_name(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v, prefix + (_key_name(i),)) for i, v in enumerate(tree))
        return torch.as_tensor(by_name["/".join(prefix)]).to(dtype or tree.dtype)

    return fill(like, ())
