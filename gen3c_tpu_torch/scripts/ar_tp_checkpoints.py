"""Shard and merge Cosmos AR tensor-parallel torch checkpoints.

Port of scripts/ar_tp_checkpoints.py, over ``models.convert``'s
``shard_ar_tp_state_dict`` and ``merge_ar_tp_state_dicts``. The reference
keeps TP shards beside the base file as ``<name>_model_mp_{rank}.pt``;
this tool uses the same names, so shards go both ways. Every tensor is
read as fp32 (a {"model": ...} wrapper unwrapped) and written as fp32.

  # split a merged checkpoint into 4 TP shards
  python -m gen3c_tpu_torch.scripts.ar_tp_checkpoints shard -c model.pt -t 4 \\
      --n_heads 32 --n_kv_heads 8 --dim 4096

  # merge 4 shards (model_model_mp_{0..3}.pt) back into one
  python -m gen3c_tpu_torch.scripts.ar_tp_checkpoints merge -c model.pt -o merged.pt \\
      -t 4 --n_heads 32 --n_kv_heads 8 --dim 4096

``--device`` is where the tensors are cut and joined (default cuda).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from gen3c_tpu_torch.models.convert import merge_ar_tp_state_dicts, shard_ar_tp_state_dict


def _load(path: str, device) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location=device, weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return {k: v.float() if isinstance(v, torch.Tensor) else v for k, v in sd.items()}


def _save(sd: Dict[str, torch.Tensor], path: str) -> None:
    torch.save({k: v.contiguous().cpu() for k, v in sd.items()}, path)


def main(argv: Optional[List[str]] = None) -> List[str]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=["shard", "merge"])
    p.add_argument("--checkpoint_path", "-c", required=True,
                   help=".pt path; shards live at *_model_mp_{rank}.pt")
    p.add_argument("--output_path", "-o", default=None)
    p.add_argument("--tensor_parallel_size", "-t", type=int, required=True)
    p.add_argument("--n_heads", type=int, required=True)
    p.add_argument("--n_kv_heads", type=int, required=True)
    p.add_argument("--dim", type=int, required=True)
    p.add_argument("--context_dim", type=int, default=None)
    p.add_argument("--head_dim", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from gen3c_tpu_torch.pipelines.factory import resolve_device

    device = resolve_device(args.device)
    base = args.checkpoint_path
    if not base.endswith(".pt"):
        raise SystemExit("checkpoint path must end with .pt")
    tp = args.tensor_parallel_size
    shard_paths = [base.replace(".pt", f"_model_mp_{r}.pt") for r in range(tp)]
    written = []
    if args.mode == "shard":
        sd = _load(base, device)
        for r, path in enumerate(shard_paths):
            _save(shard_ar_tp_state_dict(sd, tp, r, args.n_heads, args.n_kv_heads, args.dim,
                                         args.context_dim), path)
            print(f"wrote {path}")
            written.append(path)
    else:
        shards = [_load(path, device) for path in shard_paths]
        merged = merge_ar_tp_state_dicts(shards, args.n_heads, args.n_kv_heads, args.dim,
                                         args.context_dim, args.head_dim)
        out = args.output_path or base.replace(".pt", "_merged.pt")
        _save(merged, out)
        print(f"wrote {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
