"""Standalone video tokenizer CLI: encode, decode or round-trip a video.

Port of gen3c_tpu/pipelines/tokenizer_cli.py (the reference's tokenizer
video_cli): encode a video to latents (.npz with the crop region), decode
latents back to a video, or run the round trip and report its PSNR. The
video is padded as the reference pads it (``pad_video_bcthw``) and the
padding cropped off after. Weights come from
``<checkpoint_dir>/Cosmos-Tokenize1-CV8x8x8-720p`` when that directory is
there (``utils.checkpoint.load_torchscript_tokenizer``), else from a seeded
random init.

Usage:
  python -m gen3c_tpu_torch.pipelines.tokenizer_cli --mode roundtrip \
      --input video.mp4 --output recon.mp4 [--vae_preset tiny] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from gen3c_tpu_torch.models.vae import CV8x8x8, CausalVAE, VAEConfig, VideoTokenizer
from gen3c_tpu_torch.pipelines.factory import resolve_device
from gen3c_tpu_torch.utils import io as io_utils
from gen3c_tpu_torch.utils import log
from gen3c_tpu_torch.utils.timing import synchronize

VAE_PRESETS = {
    "cv8x8x8": CV8x8x8,
    "tiny": VAEConfig(channels=16, channels_mult=(2, 4, 4), num_res_blocks=1,
                      attn_resolutions=(), resolution=256, patch_size=4, latent_channels=16,
                      z_channels=16),
}


def build_tokenizer(args, device: torch.device) -> VideoTokenizer:
    """The ``--vae_preset`` tokenizer on ``device``, ``--chunk_duration``
    frames a chunk: the TorchScript tokenizer's weights when
    <checkpoint_dir>/Cosmos-Tokenize1-CV8x8x8-720p exists (its latent
    statistics unused, as in the JAX CLI), else a seeded random init."""
    cfg = VAE_PRESETS[args.vae_preset]
    vae = CausalVAE(cfg, device=device)
    state = None
    if args.checkpoint_dir:
        from gen3c_tpu_torch.utils import checkpoint as ckpt

        vae_dir = os.path.join(args.checkpoint_dir, "Cosmos-Tokenize1-CV8x8x8-720p")
        if os.path.isdir(vae_dir):
            state, _, _ = ckpt.load_torchscript_tokenizer(vae_dir)
            log.info(f"loaded tokenizer weights from {vae_dir}")
    if state is None:
        log.warning("no tokenizer checkpoint; RANDOM weights")
        vae.init_random(torch.Generator(device=device).manual_seed(0))
    else:
        vae.load_state_dict(state)
    return VideoTokenizer(vae.eval(), pixel_chunk_duration=args.chunk_duration)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(peak ** 2 / max(mse, 1e-12)))


def pad_video_bcthw(video: np.ndarray, temporal_align: int, spatial_align: int = 16,
                    temporal_rule: str = "causal"):
    """Pad a (B, C, T, H, W) video so that the tokenizer takes it: zeros
    around H and W up to multiples of spatial_align; edge frames around T
    until (T - 1) % temporal_align == 0 (rule "causal", the network's own
    need) or T % temporal_align == 0 (rule "multiple", the chunked
    wrapper's). Returns (padded, crop_region), crop_region = (f1, y1, x1,
    f2, y2, x2) of the original inside the padded video."""
    T, H, W = video.shape[-3:]
    hp = (-H) % spatial_align
    wp = (-W) % spatial_align
    if temporal_rule == "causal":
        fp = (temporal_align - (T - 1) % temporal_align) % temporal_align
    else:
        fp = (-T) % temporal_align
    crop = (fp >> 1, hp >> 1, wp >> 1, T + (fp >> 1), H + (hp >> 1), W + (wp >> 1))
    video = np.pad(video, ((0, 0), (0, 0), (0, 0), (hp >> 1, hp - (hp >> 1)),
                           (wp >> 1, wp - (wp >> 1))), mode="constant")
    video = np.pad(video, ((0, 0), (0, 0), (fp >> 1, fp - (fp >> 1)), (0, 0), (0, 0)),
                   mode="edge")
    return video, crop


def main(argv=None, record: Optional[dict] = None) -> None:
    """Run the CLI. ``record`` receives the seconds of the encode and the
    decode on the device ("encode_s", "decode_s"), the output frames
    ("frames", uint8 (T, H, W, 3)) and, for a round trip, "psnr"."""
    p = argparse.ArgumentParser(description="Cosmos video tokenizer (PyTorch/CUDA)")
    p.add_argument("--mode", choices=["encode", "decode", "roundtrip"], default="roundtrip")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--vae_preset", choices=sorted(VAE_PRESETS), default="cv8x8x8")
    p.add_argument("--chunk_duration", type=int, default=121)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda = cuda:$LOCAL_RANK, cuda:N or cpu)")
    args = p.parse_args(argv)
    record = {} if record is None else record
    device = resolve_device(args.device)
    tc = VAE_PRESETS[args.vae_preset].temporal_compression

    crop = None
    if args.mode in ("encode", "roundtrip"):
        video, fps = io_utils.read_video_bcthw(args.input)
        if video.shape[2] < args.chunk_duration:
            # shorter than one chunk: the whole clip, causally padded, in
            # one piece (the reference CLI's video_lib.py:138-143)
            video, crop = pad_video_bcthw(video, tc)
            args.chunk_duration = video.shape[2]
        else:
            video, crop = pad_video_bcthw(video, args.chunk_duration, temporal_rule="multiple")
        tok = build_tokenizer(args, device)
        x = torch.from_numpy(np.ascontiguousarray(video)).to(device)
        synchronize(device)
        t0 = time.perf_counter()
        latent = tok.encode(x)
        synchronize(device)
        record["encode_s"] = time.perf_counter() - t0
        del x
        if args.mode == "encode":
            np.savez(args.output, latent=latent.cpu().numpy(), fps=fps,
                     crop_region=np.asarray(crop))
            log.info(f"saved latent {tuple(latent.shape)} to {args.output}")
            return
    else:
        data = np.load(args.input)
        latent = torch.from_numpy(data["latent"]).to(device)
        fps = float(data.get("fps", args.fps))
        crop = tuple(data["crop_region"]) if "crop_region" in data else None
        lc = latent.shape[2]
        if args.chunk_duration > (lc - 1) * tc + 1:
            args.chunk_duration = (lc - 1) * tc + 1  # a single-piece decode
        tok = build_tokenizer(args, device)

    synchronize(device)
    t0 = time.perf_counter()
    recon = tok.decode(latent)
    synchronize(device)
    record["decode_s"] = time.perf_counter() - t0
    recon = recon[0].float().cpu().numpy()
    if crop is not None:
        f1, y1, x1, f2, y2, x2 = crop
        recon = recon[:, f1:f2, y1:y2, x1:x2]
        if args.mode == "roundtrip":
            video = video[:, :, f1:f2, y1:y2, x1:x2]
    frames = ((recon.transpose(1, 2, 3, 0) + 1) / 2 * 255).clip(0, 255).astype(np.uint8)
    record["frames"] = frames
    out_path = io_utils.save_video(frames, int(fps), args.output)
    log.info(f"saved reconstruction to {out_path}")

    if args.mode == "roundtrip":
        orig = ((video[0].transpose(1, 2, 3, 0) + 1) / 2 * 255).clip(0, 255).astype(np.uint8)
        # the causal patcher replicates the first frame: frames 1: are scored
        score = psnr(orig[1:], frames[1:])
        record["psnr"] = score
        log.info(f"roundtrip PSNR (frames 1:): {score:.2f} dB")
        print(f"PSNR: {score:.2f}")


if __name__ == "__main__":
    main()
