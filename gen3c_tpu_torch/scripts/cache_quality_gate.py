"""Quality and cost table of the three step-caching policies.

Port of scripts/cache_quality_gate.py over ``diffusion.quality.
cache_policy_table``: the denoise loop runs uncached and under each
caching policy (fixed interval, adaptive threshold, span caching) on the
same inputs, and each row gives the final latent's PSNR against the
uncached one and the network refreshes over steps (the relative
wall-clock). With real weights (``--checkpoint_dir``) the PSNRs are the
production quality deltas; with a seeded init, whose zero-initialized
AdaLN gates and final linear are drawn first (``GeneralDIT.
randomize_degenerate_inits``, seed 99), the table still shows how much
each policy perturbs the trajectory.

Run: python -m gen3c_tpu_torch.scripts.cache_quality_gate [--preset gen3c_tiny]
     [--num_steps 35] [--checkpoint_dir checkpoints] [--seed 0] [--device cuda]
The table goes to stderr, its rows as one JSON list to stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import torch


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="gen3c_tiny")
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--num_steps", type=int, default=35)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from gen3c_tpu_torch.diffusion.quality import cache_policy_table
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model

    model, preset = build_gen3c_model(args.preset, device=args.device,
                                      checkpoint_dir=args.checkpoint_dir, seed=args.seed)
    net = model.net
    if args.checkpoint_dir is None:
        with torch.no_grad():
            net.randomize_degenerate_inits(
                torch.Generator(device=next(net.parameters()).device).manual_seed(99))
    rows = cache_policy_table(net, preset.state_shape, args.num_steps, args.seed)
    for row in rows:
        print(f"  {row['policy']:<28} PSNR {row['psnr_vs_uncached']:>7} dB"
              f"   cost {row['relative_cost']}", file=sys.stderr)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
