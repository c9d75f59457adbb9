"""Fine-grained LoRA layer control (port of gen3c_tpu/training/peft_control.py).

A config selects blocks (a regex over the block indices and "final_layer"),
sub-blocks (FA self-attention, CA cross-attention, MLP, FL final layer) and
their layers (to_q, to_v, ..., each with an optional ":rank:scale"), and
``parse_layer_control`` turns it into a plan {path: (rank, scale)} that
``training.lora.init_lora_params(plan=...)`` consumes. The plan's keys are
the JAX package's parameter paths (``blocks/3/fa/q/w``), so that plans of
the two packages compare equal; ``PORT_NAMES`` maps each to the port's
parameter name.

Config grammar (the reference's LayerControlConfigParser keys):
  {
    "enabled": True,
    "customization_type": "LoRA",
    "rank": 8, "scale": 1.0,              # global defaults
    "edits": [
      {"blocks": r"\\b(0|1|25|26)\\b",    # regex over block ids
       "block_edit": ["FA[to_q, to_v]", "CA[to_q, to_v:16:0.5]"],
       "rank": 8, "scale": 1.0},          # per-edit overrides
      {"blocks": "final_layer",
       "block_edit": ["FL[l1]"]},
    ],
  }
"""

from __future__ import annotations

import json
import re
from typing import Dict, Tuple, Union

# the reference's sub-block/layer vocabulary -> gen3c_tpu's DiT paths (the
# plan's keys) and the port's parameter names (PORT_NAMES)
_SUBBLOCK_LAYERS = {
    "FA": {"to_q": "fa/q/w", "to_k": "fa/k/w", "to_v": "fa/v/w", "to_out": "fa/out/w",
           "ada1": "fa/adaln/w1", "ada2": "fa/adaln/w2"},
    "CA": {"to_q": "ca/q/w", "to_k": "ca/k/w", "to_v": "ca/v/w", "to_out": "ca/out/w",
           "ada1": "ca/adaln/w1", "ada2": "ca/adaln/w2"},
    "MLP": {"l1": "mlp/fc1/w", "l2": "mlp/fc2/w", "ada1": "mlp/adaln/w1",
            "ada2": "mlp/adaln/w2"},
}
_FINAL_LAYERS = {
    "FL": {"l1": "final/linear/w", "ada1": "final/adaln/w1", "ada2": "final/adaln/w2"},
}
FINAL_LAYER_NAME = "final_layer"

# the port's parameter name of each path above, for block i
_BLOCK_NAMES = {
    **{f"{sub}/{layer}/w": f"blocks.{j}.block.attn.to_{layer}.0.weight"
       for j, sub in enumerate(("fa", "ca")) for layer in ("q", "k", "v", "out")},
    **{f"{sub}/adaln/w{n}": f"blocks.{j}.adaLN_modulation.{n}.weight"
       for j, sub in enumerate(("fa", "ca", "mlp")) for n in (1, 2)},
    "mlp/fc1/w": "blocks.2.block.layer1.weight",
    "mlp/fc2/w": "blocks.2.block.layer2.weight",
}
_FINAL_NAMES = {
    "final/linear/w": "final_layer.linear.weight",
    "final/adaln/w1": "final_layer.adaLN_modulation.1.weight",
    "final/adaln/w2": "final_layer.adaLN_modulation.2.weight",
}
_BLOCK_PATH = re.compile(r"^blocks/(\d+)/(.+)$")
_SUBBLOCK_RE = re.compile(r"^(?P<subblock>.+?)\[(?P<parameters>[^\]]+)\]$")
_LAYER_RE = re.compile(r"^(?P<layer>.+?)(?::(?P<rank>\d+))?(?::(?P<scale>[\d.]+))?$")


def port_name(path: str) -> str:
    """The port's GeneralDIT parameter name of a plan path
    (``blocks/3/fa/q/w`` -> ``blocks.block3.blocks.0.block.attn.to_q.0.weight``)."""
    if path in _FINAL_NAMES:
        return _FINAL_NAMES[path]
    m = _BLOCK_PATH.match(path)
    if m is None or m.group(2) not in _BLOCK_NAMES:
        raise KeyError(f"{path!r} is not a layer-control path")
    return f"blocks.block{m.group(1)}.{_BLOCK_NAMES[m.group(2)]}"


def vocabulary_paths(num_blocks: int):
    """Every path the vocabulary can name in a DiT of ``num_blocks``
    blocks: each block's FA, CA and MLP layers, then the final layer's."""
    for i in range(num_blocks):
        for sub in ("FA", "CA", "MLP"):
            for path in _SUBBLOCK_LAYERS[sub].values():
                yield f"blocks/{i}/{path}"
    yield from _FINAL_LAYERS["FL"].values()


def parse_layer_control(config: Union[str, dict], num_blocks: int = 28
                        ) -> Dict[str, Tuple[int, float]]:
    """A layer-control config (dict or JSON) -> {path: (rank, scale)}.

    Empty when disabled. Raises ValueError on an unknown sub-block or
    layer, a malformed entry or an edit that selects no block."""
    if isinstance(config, str):
        config = json.loads(config)
    if not config:
        return {}
    if str(config.get("enabled", "False")).lower() not in ("true", "1", "yes"):
        return {}
    ctype = config.get("customization_type", "")
    if not ctype:
        raise ValueError("Must specify a top-level customization_type.")
    if str(ctype) not in ("LoRA", "CustomizationType.LORA"):
        raise ValueError(f"unsupported customization_type {ctype!r}")
    default_rank = config.get("rank")
    default_scale = config.get("scale")
    block_ids = [str(i) for i in range(num_blocks)] + [FINAL_LAYER_NAME]
    vocabularies = {**_SUBBLOCK_LAYERS, **_FINAL_LAYERS}

    plan: Dict[str, Tuple[int, float]] = {}
    for edit in config.get("edits", []):
        blocks_pat = re.compile(str(edit["blocks"]))
        edit_rank = edit.get("rank", default_rank)
        edit_scale = edit.get("scale", default_scale)
        selected = [b for b in block_ids if blocks_pat.search(b)]
        if not selected:
            raise ValueError(f"edit selects no blocks: {edit['blocks']!r}")
        for spec in edit.get("block_edit", []):
            m = _SUBBLOCK_RE.match(spec.strip())
            if not m:
                raise ValueError(f"malformed block_edit entry {spec!r}")
            sub = m.group("subblock").strip()
            vocab = vocabularies.get(sub)
            if vocab is None:
                raise ValueError(f"unknown subblock {sub!r}")
            for layer_spec in m.group("parameters").split(","):
                lm = _LAYER_RE.match(layer_spec.strip())
                layer = lm.group("layer")
                if layer not in vocab:
                    raise ValueError(f"unknown layer {layer!r} for subblock {sub!r}")
                rank = int(lm.group("rank") or edit_rank or 8)
                scale = float(lm.group("scale") or edit_scale or 1.0)
                for b in selected:
                    if sub in _FINAL_LAYERS:
                        if b == FINAL_LAYER_NAME:
                            plan[vocab[layer]] = (rank, scale)
                    elif b != FINAL_LAYER_NAME:
                        plan[f"blocks/{b}/{vocab[layer]}"] = (rank, scale)
    return plan
