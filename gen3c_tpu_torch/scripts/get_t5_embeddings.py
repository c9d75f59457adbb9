"""Precompute T5 text embeddings for training and offline inference.

Port of scripts/get_t5_embeddings.py: each line of a JSONL file,
{"prompt": ..., "name": <clip name>}, is encoded by the T5-11B encoder
and saved as ``<output_dir>/<name>.t5.npy`` (the encoder's (512, 1024)
fp32 output, zero past the prompt's tokens), the layout that
``training.datasets`` reads beside each clip. A line without "name" is
named by its line number (``000003``).

The encoder is ``models.t5.CosmosT5TextEncoder`` (transformers' T5, as
the JAX script's), loaded from ``--model``: a local directory or a name in
the local Hugging Face cache (no download), on ``--device``.

Run: python -m gen3c_tpu_torch.scripts.get_t5_embeddings --prompts p.jsonl
     --output_dir dataset/ [--model google-t5/t5-11b] [--max_length 512]
     [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

from gen3c_tpu_torch.utils import log


def write_embeddings(encoder, prompts_path: str, output_dir: str,
                     max_length: int = 512) -> List[str]:
    """Encode each prompt of a JSONL file with ``encoder`` (an object with
    ``encode_prompts(prompt, max_length) -> (emb (1, L, D), mask)``) and
    save ``<name>.t5.npy`` under output_dir; the paths written."""
    os.makedirs(output_dir, exist_ok=True)
    written = []
    with open(prompts_path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            emb, _ = encoder.encode_prompts(d["prompt"], max_length=max_length)
            name = d.get("name", f"{i:06d}")
            out = os.path.join(output_dir, f"{name}.t5.npy")
            np.save(out, np.asarray(emb[0]))
            log.info(f"{name}: {tuple(emb.shape)} -> {out}")
            written.append(out)
    return written


def main(argv: Optional[List[str]] = None) -> List[str]:
    p = argparse.ArgumentParser()
    p.add_argument("--prompts", required=True, help='JSONL: {"prompt": ..., "name": <clip name>}')
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model", default="google-t5/t5-11b")
    p.add_argument("--max_length", type=int, default=512)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from gen3c_tpu_torch.models.t5 import CosmosT5TextEncoder
    from gen3c_tpu_torch.pipelines.factory import resolve_device

    enc = CosmosT5TextEncoder(args.model, device=resolve_device(args.device))
    return write_embeddings(enc, args.prompts, args.output_dir, args.max_length)


if __name__ == "__main__":
    main()
