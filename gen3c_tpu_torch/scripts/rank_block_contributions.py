"""Rank the DiT's blocks by contribution to pick a span-caching span.

Port of scripts/rank_block_contributions.py. Blocks contribute unevenly
to the denoising trajectory (CorGi, arXiv:2512.24195), so the blocks worth
caching (skipped, their residual replayed) are the low-contribution ones.
Per block, the relative residual

    r_i = mean |block_i(x) - x| / mean |x|

is averaged over ``--num_sigmas`` noise levels of the EDM schedule, through
GeneralDIT's ``return_block_residuals`` hook (the real forward), and the
contiguous span of ``--span_width`` blocks with the smallest sum is the
recommended ``--step_cache_block_span LO HI``. With real weights
(``--checkpoint_dir``) the ranking is the model's; a random init has its
zero-initialized gates drawn first and only shows the method.

Run: python -m gen3c_tpu_torch.scripts.rank_block_contributions
     [--preset gen3c_7b] [--span_width 14] [--checkpoint_dir checkpoints]
     [--device cuda]
The per-block table goes to stderr, one JSON line {"span", "per_block"} to
stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from gen3c_tpu_torch.diffusion.scheduler import EDMEulerSchedule
from gen3c_tpu_torch.models.dit import GeneralDIT


@torch.no_grad()
def block_contributions(net: GeneralDIT, state_shape: Tuple[int, int, int, int],
                        num_sigmas: int = 4, seed: int = 0, verbose: bool = False
                        ) -> np.ndarray:
    """Each block's relative residual, averaged over ``num_sigmas`` noise
    levels: one B = 1 forward per level on numpy-seeded noise at that level
    (``RandomState(seed)``, drawn in the JAX script's order), zero text
    embeddings of 8 tokens. (num_blocks,) float64."""
    cfg = net.cfg
    dev = next(net.parameters()).device
    _, Tl, Hl, Wl = state_shape
    rng = np.random.RandomState(seed)
    sched = EDMEulerSchedule()
    sigmas = np.asarray(sched.sigmas(num_sigmas + 1))[:-1]
    ctx = torch.zeros((1, 8, cfg.crossattn_emb_channels), dtype=torch.float32, device=dev)
    total = np.zeros((cfg.num_blocks,), np.float64)
    for sigma in sigmas:
        x = (rng.randn(1, cfg.in_channels, Tl, Hl, Wl) * float(sigma)).astype(np.float32)
        x = torch.from_numpy(x).to(dev) * float(sched.c_in(float(sigma)))
        t = torch.full((1,), float(np.log(sigma) / 4.0), dtype=torch.float32, device=dev)
        _, rels = net(x, t, ctx, fps=24.0, return_block_residuals=True)
        rels = rels.double().cpu().numpy()
        total += rels
        if verbose:
            print(f"sigma={float(sigma):9.3f}: " + " ".join(f"{v:.3f}" for v in rels),
                  file=sys.stderr)
    return total / len(sigmas)


def best_span(per_block: np.ndarray, width: int) -> Tuple[int, int, float]:
    """(lo, hi, sum): the first contiguous span of ``width`` blocks with the
    smallest total contribution."""
    best_lo, best_sum = 0, float("inf")
    for lo in range(0, len(per_block) - width + 1):
        s = float(per_block[lo:lo + width].sum())
        if s < best_sum:
            best_lo, best_sum = lo, s
    return best_lo, best_lo + width, best_sum


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="gen3c_tiny")
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--span_width", type=int, default=None, help="default: half the blocks")
    ap.add_argument("--num_sigmas", type=int, default=4,
                    help="noise levels sampled across the EDM schedule")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda = cuda:$LOCAL_RANK, cuda:N or cpu)")
    args = ap.parse_args(argv)
    from gen3c_tpu_torch.pipelines.factory import build_gen3c_model

    model, preset = build_gen3c_model(args.preset, device=args.device, seed=args.seed,
                                      checkpoint_dir=args.checkpoint_dir)
    net = model.net
    if args.checkpoint_dir is None:
        net.randomize_degenerate_inits(torch.Generator(device=model.device).manual_seed(9))
    width = args.span_width or net.cfg.num_blocks // 2
    per_block = block_contributions(net, preset.state_shape, args.num_sigmas, args.seed,
                                    verbose=True)
    print("\nper-block mean relative residual:", file=sys.stderr)
    for i, v in enumerate(per_block):
        print(f"  block {i:2d}: {v:.4f}", file=sys.stderr)
    lo, hi, total = best_span(per_block, width)
    print(f"\nrecommended --step_cache_block_span {lo} {hi} (width {width}, total "
          f"contribution {total:.4f})", file=sys.stderr)
    result = {"span": [lo, hi], "per_block": [round(float(v), 5) for v in per_block]}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
