"""One chunk of the single-image CLI at GEN3C-7B on one card, timed.

    PYTHONPATH=<checkout> python gen3c_tpu_torch/scripts/time_fast_chunk.py TAG [CLI flags]

runs ``gen3c_single_image``'s entry point (``demo`` on the CLI's own parser)
on the gen3c_tpu_torch found first on the path with ``--model_preset
gen3c_7b --perf_preset fast --num_steps 35`` (flags given after TAG are
added), random weights from ``--seed`` (no checkpoints) and a seeded
704x1280 image, and prints one JSON line of what the CLI records
(``demo``'s ``record``): the model build seconds (random init and
quantization), each denoise step's kind (CFG or condition-only, refreshed
or cached) and seconds, the encode and decode seconds, the chunk's render
and generate seconds, the chunk wall-clock (from the cache render to uint8
frames, ``run_chunked_generation``), the whole entry point's seconds, the
run's peak GiB and the generation's kernel launches. PERF.md §7's cell (2),
the fast chunk at 35 steps. The image and the video go to a temporary
directory, removed at the end.

Run it for the old and the new checkout in one call to compare them.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import numpy as np

FLAGS = ["--model_preset", "gen3c_7b", "--perf_preset", "fast", "--num_steps", "35",
         "--checkpoint_dir", "none", "--trajectory", "left", "--seed", "0"]


def _seed_image(h: int, w: int, seed: int) -> np.ndarray:
    """A numpy-seeded smooth image, (h, w, 3) uint8 (the smoke's)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(-1, 1, (3, h // 32 + 1, w // 32 + 1)).astype(np.float32)
    img = np.repeat(np.repeat(coarse, 32, axis=1), 32, axis=2)[:, :h, :w]
    img = np.clip(img + 0.1 * rng.standard_normal((3, h, w)).astype(np.float32), -1, 1)
    return ((img.transpose(1, 2, 0) + 1) * 127.5).round().astype(np.uint8)


def run(tag: str, extra: list) -> dict:
    import torch
    from PIL import Image

    import gen3c_tpu_torch
    from gen3c_tpu_torch.pipelines import gen3c_single_image as cli

    out_dir = tempfile.mkdtemp(prefix="fast_chunk_")
    got: dict = {}
    try:
        path = os.path.join(out_dir, "seed.png")
        Image.fromarray(_seed_image(704, 1280, 0)).save(path)
        argv = FLAGS + ["--input_image_path", path, "--video_save_folder", out_dir] + extra
        cli.demo(cli.create_parser().parse_args(argv), record=got)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    t = got["pipeline"]  # the last chunk's (121 frames at the 7B are one chunk)
    steps = [{"s": s["seconds"], "cfg": s["cfg"], "refresh": s["refresh"]}
             for s in t["denoise_steps"]]
    rec = {"tag": tag, "package": os.path.dirname(gen3c_tpu_torch.__file__),
           "build_s": got["build"], "chunk_s": got["chunked_generation"],
           "render_s": got["render"], "generate_s": got["generate"], "steps": steps,
           "encode_condition_s": t["encode_condition"], "encode_warps_s": t["encode_warps"],
           "decode_s": t["decode"], "entry_point_s": got["entry_point"],
           "peak_gib": got["peak_gib"], "launches": got["launches"]}
    for kind, cfg, refresh in (("cfg_refresh", True, True), ("cond_refresh", False, True)):
        times = [s["s"] for s in steps if s["cfg"] == cfg and s["refresh"] == refresh]
        rec[f"{kind}_s"] = {"n": len(times), "min": min(times, default=None),
                            "max": max(times, default=None)}
    rec["cached_steps"] = sum(not s["refresh"] for s in steps)
    rec["denoise_s"] = sum(s["s"] for s in steps)
    rec["device"] = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    run(argv[0], argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
