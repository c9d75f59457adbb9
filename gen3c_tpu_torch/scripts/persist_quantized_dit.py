"""Persist the converted and int8-quantized GEN3C DiT as a native checkpoint.

Port of scripts/persist_quantized_dit.py: the native bf16
``<checkpoint_dir>/gen3c_tpu/dit.npz`` (or, without one, the reference's
``GEN3C-Cosmos-7B/model.pt``, converted) is quantized once, offline, and
saved as ``<checkpoint_dir>/gen3c_tpu/dit_{w8a8,int8}.npz``: the file the
JAX script writes, key for key and bit for bit
(``models.quantize.quantize_dit_tree``). ``pipelines.factory.
build_gen3c_model(quantize=...)`` then loads it as it is: half the bytes
of the bf16 checkpoint, no conversion, no quantization pass at start-up.

Run: python -m gen3c_tpu_torch.scripts.persist_quantized_dit
     --checkpoint_dir checkpoints [--mode w8a8|int8] [--preset gen3c_7b]
     [--num_blocks N] [--device cuda]
``--num_blocks`` checks a cut checkpoint's depth (the preset's by default).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

import torch

from gen3c_tpu_torch.utils import log


def load_dit_tree(checkpoint_dir: str, dit_cfg):
    """The DiT of checkpoint_dir as the JAX package's parameter tree with
    bf16 leaves: gen3c_tpu/dit.npz as stored, else GEN3C-Cosmos-7B/model.pt
    converted (``models.convert.convert_dit_state_dict``, strict)."""
    from gen3c_tpu_torch.models.convert import convert_dit_state_dict
    from gen3c_tpu_torch.utils import checkpoint as ckpt

    native = os.path.join(checkpoint_dir, "gen3c_tpu", "dit.npz")
    torch_ckpt = os.path.join(checkpoint_dir, "GEN3C-Cosmos-7B", "model.pt")
    if os.path.exists(native):
        # bf16, the dtype the serving build quantizes from
        tree = _as_bf16(ckpt.load_params_npz_tree(native))
        log.info(f"Loaded native checkpoint {native} (as bf16)")
        return tree
    if os.path.exists(torch_ckpt):
        sd = {k: v.float() for k, v in ckpt.load_torch_dit_checkpoint(torch_ckpt).items()
              if isinstance(v, torch.Tensor)}
        log.info(f"Converted torch checkpoint {torch_ckpt}")
        return convert_dit_state_dict(sd, dit_cfg, dtype=torch.bfloat16, strict=True)
    raise SystemExit(f"no checkpoint found under {checkpoint_dir} (looked for {native} and "
                     f"{torch_ckpt})")


def _as_bf16(tree):
    if isinstance(tree, dict):
        return {k: _as_bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_bf16(v) for v in tree]
    return torch.as_tensor(tree).to(torch.bfloat16)


def main(argv: Optional[List[str]] = None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--mode", choices=["w8a8", "int8"], default="w8a8")
    ap.add_argument("--preset", default="gen3c_7b")
    ap.add_argument("--num_blocks", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="where each weight is quantized")
    args = ap.parse_args(argv)

    from gen3c_tpu_torch.models.quantize import quantize_dit_tree
    from gen3c_tpu_torch.pipelines.factory import PRESETS, resolve_device
    from gen3c_tpu_torch.utils import checkpoint as ckpt

    dit_cfg = PRESETS[args.preset].dit
    if args.num_blocks is not None:
        dit_cfg = dataclasses.replace(dit_cfg, num_blocks=args.num_blocks)
    tree = load_dit_tree(args.checkpoint_dir, dit_cfg)
    if len(tree["blocks"]) != dit_cfg.num_blocks:
        raise SystemExit(f"the checkpoint has {len(tree['blocks'])} blocks, {args.preset} "
                         f"{dit_cfg.num_blocks} (pass --num_blocks for a cut one)")
    log.info(f"Quantizing ({args.mode}) on {args.device}...")
    qtree = quantize_dit_tree(tree, act_quant=args.mode == "w8a8",
                              device=resolve_device(args.device))
    out = os.path.join(args.checkpoint_dir, "gen3c_tpu", f"dit_{args.mode}.npz")
    ckpt.save_params_npz(out, qtree)
    log.info(f"Persisted quantized DiT to {out}")
    return out


if __name__ == "__main__":
    main()
