"""Convert the reference's torch GEN3C checkpoints to native npz files.

Port of scripts/convert_checkpoints.py. Under ``--checkpoint_dir`` it
writes, into ``gen3c_tpu/``, what the JAX script writes, key for key:

  GEN3C-Cosmos-7B/model.pt          -> dit.npz (bf16, the JAX parameter
                                       tree: ``models.convert.
                                       convert_dit_state_dict``, strict)
  Cosmos-Predict1-7B-{Text,Video}2World-Sample-AV-Multiview/model.pt
                                    -> cosmos_{t2w,v2w}_mv_7b.npz (fp32,
                                       ``convert_multiview_dit_state_dict``)
  Cosmos-Tokenize1-CV8x8x8-720p/{encoder,decoder}.jit (+ mean_std.pt)
                                    -> vae.npz (+ vae_mean_std.npz), fp32
                                       under the reference's names

A source that is absent is skipped with a warning. ``pipelines.factory.
build_gen3c_model`` reads dit.npz and vae.npz. The tensors are converted
on ``--device`` (default cuda) and written from the host; the tokenizer's
are copied as they are read.

Run: python -m gen3c_tpu_torch.scripts.convert_checkpoints
     --checkpoint_dir checkpoints [--preset gen3c_7b] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from gen3c_tpu_torch.utils import log

MULTIVIEW = (("Cosmos-Predict1-7B-Text2World-Sample-AV-Multiview", "cosmos_t2w_mv_7b"),
             ("Cosmos-Predict1-7B-Video2World-Sample-AV-Multiview", "cosmos_v2w_mv_7b"))


def _on(sd: dict, device) -> dict:
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in sd.items()}


def main(argv: Optional[List[str]] = None) -> List[str]:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--preset", default="gen3c_7b")
    p.add_argument("--dit", action="store_true", default=True)
    p.add_argument("--vae", action="store_true", default=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from gen3c_tpu_torch.models.convert import (
        convert_dit_state_dict,
        convert_multiview_dit_state_dict,
        normalize_reference_checkpoint,
    )
    from gen3c_tpu_torch.pipelines.factory import PRESETS, resolve_device
    from gen3c_tpu_torch.pipelines.text2world_multiview import MV_PRESETS
    from gen3c_tpu_torch.utils import checkpoint as ckpt

    device = resolve_device(args.device)
    preset = PRESETS[args.preset]
    out_dir = os.path.join(args.checkpoint_dir, "gen3c_tpu")
    os.makedirs(out_dir, exist_ok=True)
    written = []

    torch_dit = os.path.join(args.checkpoint_dir, "GEN3C-Cosmos-7B", "model.pt")
    if args.dit and os.path.exists(torch_dit):
        log.info(f"converting {torch_dit} ...")
        sd = {k: v for k, v in ckpt.load_torch_dit_checkpoint(torch_dit).items()
              if isinstance(v, torch.Tensor)}
        params = convert_dit_state_dict(_on(sd, device), preset.dit, dtype=torch.bfloat16,
                                        strict=True)
        written.append(os.path.join(out_dir, "dit.npz"))
        ckpt.save_params_npz(written[-1], params)
    elif args.dit:
        log.warning(f"{torch_dit} not found; skipping DiT")

    for name, preset_name in MULTIVIEW:
        torch_mv = os.path.join(args.checkpoint_dir, name, "model.pt")
        if os.path.exists(torch_mv):
            log.info(f"converting {torch_mv} ...")
            sd = normalize_reference_checkpoint(
                torch.load(torch_mv, map_location="cpu", weights_only=True))
            mv = convert_multiview_dit_state_dict(_on(sd, device), MV_PRESETS[preset_name].dit)
            written.append(os.path.join(out_dir, f"{preset_name}.npz"))
            ckpt.save_params_npz(written[-1], mv)

    vae_dir = os.path.join(args.checkpoint_dir, "Cosmos-Tokenize1-CV8x8x8-720p")
    if args.vae and os.path.isdir(vae_dir):
        log.info(f"converting {vae_dir} ...")
        params, mean, std = ckpt.load_torchscript_tokenizer(vae_dir)
        written.append(os.path.join(out_dir, "vae.npz"))
        np.savez(written[-1], **{k: v.numpy() for k, v in params.items()})
        if mean is not None:
            written.append(os.path.join(out_dir, "vae_mean_std.npz"))
            np.savez(written[-1], mean=mean.numpy(), std=std.numpy())
    elif args.vae:
        log.warning(f"{vae_dir} not found; skipping VAE")
    return written


if __name__ == "__main__":
    main()
