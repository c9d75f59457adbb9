"""The single-image main path at GEN3C-7B on one card, uncut and timed.

    PYTHONPATH=<checkout> python gen3c_tpu_torch/scripts/time_main_path.py TAG [--vae-tf32] [CLI flags]

runs ``gen3c_single_image``'s entry point (``demo`` on the CLI's own parser)
with ``--model_preset gen3c_7b --num_steps 35`` and any flags given after
TAG (``--perf_preset fast``, ``--num_video_frames 241`` for the two-chunk AR
run, ...), random weights from ``--seed`` (no checkpoints), a seeded
704x1280 image, and its depth from MoGe ViT-L: the script writes a seeded
ViT-L checkpoint to its temporary directory and points
$GEN3C_MOGE_CHECKPOINT at it, so that the CLI's ``--depth_source auto``
takes MoGe for the seed frame and between the chunks. (Its head's mask and
depth channels are biased on, so every pixel is valid; with untrained
weights the recovered focal is not a camera's, which changes the scene's
geometry, not the work.) It prints one JSON line of what the CLI records,
chunk by chunk: render, depth (MoGe on the last frame), update
(``update_cache``: the depth alignment), the prompt, seed and warp
encodes, every denoise step with its kind (CFG or condition-only,
refreshed or cached) and seconds, decode, peak GiB and the kernel launches
by id; then the seed frame's depth, the build, the save, the whole entry
point and the run's peak. The image, checkpoint and video go to the
temporary directory, removed at the end. On a card the kernels are built
first, apart from the timed run.

``--vae-tf32`` first encodes and decodes a seeded 121-frame 704x1280 video
with the 7B VAE (random weights from the seed) with cuDNN's TF32 on and
then off, and prints the PSNR between the two decodes, the latents'
largest difference and both times.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

FLAGS = ["--model_preset", "gen3c_7b", "--num_steps", "35", "--checkpoint_dir", "none",
         "--trajectory", "left", "--seed", "0", "--depth_source", "auto"]


def _seed_image(h: int, w: int, seed: int) -> np.ndarray:
    """A numpy-seeded smooth image, (h, w, 3) uint8 (the smoke's)."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(-1, 1, (3, h // 32 + 1, w // 32 + 1)).astype(np.float32)
    img = np.repeat(np.repeat(coarse, 32, axis=1), 32, axis=2)[:, :h, :w]
    img = np.clip(img + 0.1 * rng.standard_normal((3, h, w)).astype(np.float32), -1, 1)
    return ((img.transpose(1, 2, 0) + 1) * 127.5).round().astype(np.uint8)


def seeded_moge_params(cfg, seed: int, device: str) -> dict:
    """Seeded MoGe weights (torch names) whose head marks every pixel valid
    at a positive depth: mask logit +4, z +2."""
    import torch

    from gen3c_tpu_torch.aux import moge

    params = moge.init_moge_params(torch.Generator(device=device).manual_seed(seed), cfg,
                                   device=device)
    params["head.out.bias"] = torch.tensor([0.0, 0.0, 2.0, 4.0], device=device)
    return params


def _chunks(got: dict) -> list:
    """The CLI's per-chunk lists as one record a chunk."""
    out = []
    for c, pipe in enumerate(got["pipeline"]):
        steps = [{"s": s["seconds"], "cfg": s["cfg"], "refresh": s["refresh"]}
                 for s in pipe["denoise_steps"]]
        rec = {"chunk": c, "render_s": got["render"][c],
               "depth_s": got["depth"][c - 1] if c else None,
               "update_s": got["update"][c - 1] if c else None,
               "generate_s": got["generate"][c], "encode_prompt_s": pipe["encode_prompt"],
               "encode_condition_s": pipe["encode_condition"],
               "encode_warps_s": pipe["encode_warps"], "steps": steps,
               "denoise_s": sum(s["s"] for s in steps), "decode_s": pipe["decode"],
               "peak_gib": got["chunk_peak_gib"][c], "launches": got["chunk_launches"][c]}
        for kind, cfg, refresh in (("cfg_refresh", True, True), ("cond_refresh", False, True)):
            times = [s["s"] for s in steps if s["cfg"] == cfg and s["refresh"] == refresh]
            rec[f"{kind}_s"] = {"n": len(times), "min": min(times, default=None),
                                "max": max(times, default=None)}
        rec["cached_steps"] = sum(not s["refresh"] for s in steps)
        out.append(rec)
    return out


def run(tag: str, extra: list) -> dict:
    import torch
    from PIL import Image

    import gen3c_tpu_torch
    from gen3c_tpu_torch.aux import moge
    from gen3c_tpu_torch.pipelines import gen3c_single_image as cli

    args = cli.create_parser().parse_args(FLAGS + ["--input_image_path", "-"] + extra)
    cfg = moge.MOGE_TINY if args.model_preset == "gen3c_tiny" else moge.MOGE_VITL
    kernel_build_s = None
    if torch.device(args.device).type == "cuda":  # build the kernels before the timed run
        from gen3c_tpu_torch.kernels import cuda as kcuda

        t0 = time.perf_counter()
        kcuda.library()
        kernel_build_s = time.perf_counter() - t0
    out_dir = tempfile.mkdtemp(prefix="main_path_")
    saved_env = os.environ.get("GEN3C_MOGE_CHECKPOINT")
    got: dict = {}
    try:
        from gen3c_tpu_torch.pipelines.factory import PRESETS

        preset = PRESETS[args.model_preset]
        path = os.path.join(out_dir, "seed.png")
        Image.fromarray(_seed_image(preset.height, preset.width, 0)).save(path)
        ckpt = os.path.join(out_dir, "moge.pt")
        t0 = time.perf_counter()
        torch.save(seeded_moge_params(cfg, args.seed, "cpu"), ckpt)
        moge_write_s = time.perf_counter() - t0
        os.environ["GEN3C_MOGE_CHECKPOINT"] = ckpt
        argv = FLAGS + ["--input_image_path", path, "--video_save_folder", out_dir] + extra
        if cfg is moge.MOGE_TINY:  # a CPU rehearsal: the tiny MoGe behind auto
            saved_cfg, moge.MOGE_VITL = moge.MOGE_VITL, moge.MOGE_TINY
        try:
            cli.demo(cli.create_parser().parse_args(argv), record=got)
        finally:
            if cfg is moge.MOGE_TINY:
                moge.MOGE_VITL = saved_cfg
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        if saved_env is None:
            os.environ.pop("GEN3C_MOGE_CHECKPOINT", None)
        else:
            os.environ["GEN3C_MOGE_CHECKPOINT"] = saved_env
    chunks = _chunks(got)
    rec = {"tag": tag, "package": os.path.dirname(gen3c_tpu_torch.__file__),
           "flags": extra, "frames": got["frames"], "kernel_build_s": kernel_build_s,
           "moge_checkpoint_write_s": moge_write_s,
           "build_s": got["build"], "seed_depth_s": got["seed_depth"],
           "chunked_generation_s": got["chunked_generation"], "save_s": got["save"],
           "entry_point_s": got["entry_point"], "peak_gib": got["peak_gib"],
           "launches": got["launches"], "chunks": chunks,
           "denoise_s": sum(c["denoise_s"] for c in chunks),
           "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"}
    print(json.dumps(rec), flush=True)
    return rec


def _psnr(a, b) -> float:
    """PSNR of two videos in [-1, 1] (peak-to-peak 2)."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(4.0 / mse)


def vae_tf32(seed: int = 0) -> dict:
    """The 7B VAE's encode and decode of a seeded 121-frame 704x1280 video
    with cuDNN's TF32 on, then off: PSNR of the decodes (off as the
    reference), the latents' largest difference and each run's seconds."""
    import torch

    from gen3c_tpu_torch.models.vae import CausalVAE, VideoTokenizer
    from gen3c_tpu_torch.pipelines.factory import PRESETS

    preset = PRESETS["gen3c_7b"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device("meta"):
        vae = CausalVAE(preset.vae)
    vae = vae.to_empty(device=dev).init_random(gen).eval()
    tok = VideoTokenizer(vae, pixel_chunk_duration=preset.chunk_size,
                         spatial_resolution=(preset.height, preset.width))
    img = torch.from_numpy(_seed_image(preset.height, preset.width, seed)).to(dev)
    img = img.permute(2, 0, 1).float() / 127.5 - 1
    # the seed image panning 4 pixels a frame
    video = torch.stack([torch.roll(img, 4 * t, dims=2) for t in range(preset.chunk_size)], 1)[None]
    out = {}
    saved = torch.backends.cudnn.allow_tf32
    try:
        for on in (True, False):
            torch.backends.cudnn.allow_tf32 = on
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            latent = tok.encode(video)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            decoded = tok.decode(latent)
            torch.cuda.synchronize()
            out[on] = (latent, decoded, t1 - t0, time.perf_counter() - t1)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    (lat_on, dec_on, enc_on_s, dec_on_s), (lat_off, dec_off, enc_off_s, dec_off_s) = out[True], out[False]
    rec = {"vae_tf32": {
        "shape": list(video.shape), "psnr_decode_db": _psnr(dec_on, dec_off),
        "psnr_decode_vs_input_tf32_on_db": _psnr(dec_on, video),
        "psnr_decode_vs_input_tf32_off_db": _psnr(dec_off, video),
        "latent_max_abs_diff": float((lat_on - lat_off).abs().max()),
        "latent_mean_abs": float(lat_off.abs().mean()),
        "encode_s": {"tf32_on": enc_on_s, "tf32_off": enc_off_s},
        "decode_s": {"tf32_on": dec_on_s, "tf32_off": dec_off_s}}}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    tag, extra = argv[0], argv[1:]
    if "--vae-tf32" in extra:
        extra.remove("--vae-tf32")
        vae_tf32()
    run(tag, extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
