"""Synthesize a random-weight native DiT checkpoint for timing and pipeline runs.

Port of scripts/make_random_checkpoint.py. Real GEN3C-Cosmos-7B weights
are not in the repository; start-up and end-to-end timing still need
checkpoints with the real tree and byte footprint. This writes

  <dir>/gen3c_tpu/dit.npz         the bf16 DiT, the preset's exact tree
  <dir>/gen3c_tpu/dit_w8a8.npz    its int8 form (--quantize w8a8|int8)

in the JAX package's layout (``utils.checkpoint.save_params_npz``): the
names, shapes and dtypes of gen3c_tpu's ``init_dit_params`` tree. The
values are N(0, 0.02) in fp32, rounded to bf16, drawn leaf after leaf in
the tree's order from one ``torch.Generator(device).manual_seed(seed)``
on ``--device``: the same seed and device give the same file, but not the
bits of ``jax.random`` (structurally exact, numerically meaningless).

Run: python -m gen3c_tpu_torch.scripts.make_random_checkpoint
     --checkpoint_dir /tmp/ckpt [--preset gen3c_7b] [--quantize w8a8|int8]
     [--skip_bf16] [--seed 0] [--num_blocks N] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, List, Optional

import torch

from gen3c_tpu_torch.utils import log


def dit_tree_template(dit_cfg) -> Any:
    """The DiT parameter tree in the JAX package's layout (linears (in,
    out)) for ``dit_cfg``, as meta tensors: the port's GeneralDIT's state
    through ``models.convert.convert_dit_state_dict``."""
    from gen3c_tpu_torch.models.convert import convert_dit_state_dict
    from gen3c_tpu_torch.models.dit import GeneralDIT

    with torch.device("meta"):
        net = GeneralDIT(dit_cfg)
    return convert_dit_state_dict(net.state_dict(), dit_cfg, dtype=torch.bfloat16, strict=True)


def random_dit_tree(dit_cfg, seed: int = 0, device="cpu") -> Any:
    """``dit_tree_template`` filled with N(0, 0.02) bf16 (CPU tensors),
    leaf after leaf in ``save_params_npz``'s order (dict keys sorted) from
    one generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [fill(v) for v in tree]
        a = torch.randn(tuple(tree.shape), generator=gen, device=device, dtype=torch.float32)
        return a.mul_(0.02).to(torch.bfloat16).cpu()

    return fill(dit_tree_template(dit_cfg))


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--preset", default="gen3c_7b")
    ap.add_argument("--quantize", choices=["", "w8a8", "int8"], default="")
    ap.add_argument("--skip_bf16", action="store_true",
                    help="only write the quantized variant (saves ~15 GB of disk at the 7B)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num_blocks", type=int, default=None,
                    help="cut the preset's depth (its widths stay)")
    ap.add_argument("--device", default="cuda", help="where the draws and the quantization run")
    args = ap.parse_args(argv)

    from gen3c_tpu_torch.models.quantize import quantize_dit_tree
    from gen3c_tpu_torch.pipelines.factory import PRESETS, resolve_device
    from gen3c_tpu_torch.utils import checkpoint as ckpt

    device = resolve_device(args.device)
    dit_cfg = PRESETS[args.preset].dit
    if args.num_blocks is not None:
        dit_cfg = dataclasses.replace(dit_cfg, num_blocks=args.num_blocks)
    params = random_dit_tree(dit_cfg, args.seed, device)
    n_params = sum(leaf.numel() for _, leaf in ckpt.flatten_params(params))
    log.info(f"synthesized {n_params / 1e9:.2f}B random bf16 params")
    out_dir = os.path.join(args.checkpoint_dir, "gen3c_tpu")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    if not args.skip_bf16:
        out = os.path.join(out_dir, "dit.npz")
        ckpt.save_params_npz(out, params)
        written.append(out)
        log.info(f"wrote {out} ({os.path.getsize(out) / 1e9:.2f} GB)")
    if args.quantize:
        qparams = quantize_dit_tree(params, act_quant=args.quantize == "w8a8", device=device)
        out = os.path.join(out_dir, f"dit_{args.quantize}.npz")
        ckpt.save_params_npz(out, qparams)
        written.append(out)
        log.info(f"wrote {out} ({os.path.getsize(out) / 1e9:.2f} GB)")
    return written


if __name__ == "__main__":
    main()
