"""Autoregressive world-model inference (the Cosmos AR stack), PyTorch/CUDA CLI.

Port of gen3c_tpu/pipelines/autoregressive.py: a video prompt is
FSQ-tokenized by the DV tokenizer, the token prefix (the first half of the
latent frames, t-major) conditions the llama-style transformer
(``models/ar_transformer.py``), which generates the remaining tokens of the
preset's latent grid; they are clipped to the vocabulary and refined by the
latent diffusion decoder (``pipelines/diffusion_decoder.py``), or decoded by
the DV tokenizer with ``--disable_diffusion_decoder`` or when the 7B
decoder's checkpoint is absent.

Presets: ``ar_tiny`` (fp32, 64x64, 9-frame chunks, a (4, 8, 8) grid) and
``ar_4b`` (the 4B at bf16: dim 4096, 16 layers, 32 query / 8 KV heads of
128, 12,800 positions; 640x1024, 33 frames, a (5, 40, 64) grid). A
deliberate departure: ``ar_4b`` tokenizes with DV8x16x16. gen3c_tpu pairs
it with ``DiscreteVAEConfig()``, the continuous VAE's 16 channels at 8x,
which ``fsq_quantize``'s 6 levels cannot take; DV8x16x16 gives the grid
``latent_shape`` expects.

Weights: ``--checkpoint_dir`` with
``Cosmos-1.0-Autoregressive-4B/model.pt`` (a Cosmos AR state dict, through
``convert_cosmos_ar_state_dict``) and ``gen3c_tpu/dv.npz`` (the DV
tokenizer, reference names); otherwise a seeded random init with a warning.

Usage:
  python -m gen3c_tpu_torch.pipelines.autoregressive --input_video in.mp4 \
      [--model_preset ar_tiny --device cpu] [--disable_diffusion_decoder]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from gen3c_tpu_torch.models.ar_transformer import ARConfig, ARTransformer, generate
from gen3c_tpu_torch.models.convert import convert_cosmos_ar_state_dict
from gen3c_tpu_torch.models.fsq import DV8x16x16, DiscreteVAEConfig, DiscreteVideoFSQTokenizer
from gen3c_tpu_torch.models.vae import CausalVAE
from gen3c_tpu_torch.pipelines.factory import resolve_device
from gen3c_tpu_torch.utils import checkpoint as ckpt
from gen3c_tpu_torch.utils import io as io_utils
from gen3c_tpu_torch.utils import log
from gen3c_tpu_torch.utils.timing import Laps

DV_TINY = DiscreteVAEConfig(
    channels=16,
    channels_mult=(2, 4, 4),
    num_res_blocks=1,
    attn_resolutions=(),
    resolution=256,
    patch_size=4,
    latent_channels=6,
    z_channels=6,
    spatial_compression=8,
    temporal_compression=8,
)

# ar_tiny's latent grid: 64x64 video, 9-frame chunks -> (2 + 2 generated, 8, 8)
AR_TINY_VIDEO = ARConfig(
    dim=128,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    vocab_size=64000,
    ffn_hidden_size=256,
    max_seq_len=4 * 8 * 8,
    rope_dim="3D",
    latent_shape=(4, 8, 8),
    dtype=torch.float32,
)

# the Cosmos 4B (dim 4096 x 16 layers)
AR_4B_VIDEO = ARConfig(
    dim=4096,
    n_layers=16,
    n_heads=32,
    n_kv_heads=8,
    vocab_size=64000,
    ffn_hidden_size=14336,
    max_seq_len=12800,
    rope_dim="3D",
    latent_shape=(5, 40, 64),
    use_qk_normalization=True,
)


@dataclasses.dataclass(frozen=True)
class ARPreset:
    name: str
    ar: ARConfig
    dv: DiscreteVAEConfig
    height: int
    width: int
    chunk: int  # pixel frames of the prompt


AR_PRESETS = {p.name: p for p in (
    ARPreset("ar_tiny", AR_TINY_VIDEO, DV_TINY, 64, 64, 9),
    ARPreset("ar_4b", AR_4B_VIDEO, DV8x16x16, 640, 1024, 33),
)}

AR_CHECKPOINT = "Cosmos-1.0-Autoregressive-4B/model.pt"
DV_CHECKPOINT = "gen3c_tpu/dv.npz"


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Cosmos AR world model (PyTorch/CUDA)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda = cuda:$LOCAL_RANK, cuda:N or cpu)")
    p.add_argument("--input_video", type=str, required=True)
    p.add_argument("--model_preset", choices=sorted(AR_PRESETS), default="ar_4b")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--num_input_frames", type=int, default=None,
                   help="pixel frames used as the token prefix")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_p", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--disable_diffusion_decoder", action="store_true",
                   help="decode tokens with the DV tokenizer directly instead of the latent "
                        "diffusion decoder")
    p.add_argument("--diffusion_decoder_steps", type=int, default=15,
                   help="the decoder's denoise steps")
    p.add_argument("--quantize_kv", action="store_true",
                   help="int8 KV cache (half the cache's bytes)")
    p.add_argument("--video_save_name", type=str, default="output")
    p.add_argument("--video_save_folder", type=str, default="outputs/")
    p.add_argument("--fps", type=int, default=24)
    return p


def build_ar_model(preset: ARPreset, device, seed: int = 0,
                   checkpoint_dir: Optional[str] = None) -> ARTransformer:
    """The transformer on ``device``: <checkpoint_dir>/AR_CHECKPOINT through
    ``convert_cosmos_ar_state_dict`` when it is there, else a random init
    from ``seed``."""
    with torch.device("meta"):
        model = ARTransformer(preset.ar)
    model = model.to_empty(device=device)
    path = os.path.join(checkpoint_dir or "", AR_CHECKPOINT)
    if checkpoint_dir and os.path.exists(path):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("model", sd)
        model.load_state_dict(convert_cosmos_ar_state_dict(
            {k[len("net."):] if k.startswith("net.") else k: v for k, v in sd.items()},
            preset.ar))
        log.info(f"Loaded AR weights from {path}")
        return model
    log.warning(f"AR model weights not found ({path}); RANDOM init ({preset.name}, seed {seed})")
    return model.init_random(torch.Generator(device=device).manual_seed(seed))


def build_dv_tokenizer(preset: ARPreset, device, seed: int = 0,
                       checkpoint_dir: Optional[str] = None) -> DiscreteVideoFSQTokenizer:
    """The DV tokenizer on ``device``: <checkpoint_dir>/DV_CHECKPOINT when
    it is there, else a random init from ``seed + 1``."""
    with torch.device("meta"):
        vae = CausalVAE(preset.dv)
    vae = vae.to_empty(device=device)
    path = os.path.join(checkpoint_dir or "", DV_CHECKPOINT)
    if checkpoint_dir and os.path.exists(path):
        vae.load_state_dict(ckpt.vae_state_dict(ckpt.load_flat_npz(path)))
        log.info(f"Loaded DV tokenizer weights from {path}")
    else:
        log.warning("DV tokenizer weights not found; RANDOM init")
        vae.init_random(torch.Generator(device=device).manual_seed(seed + 1))
    return DiscreteVideoFSQTokenizer(vae.eval(), pixel_chunk_duration=preset.chunk)


@torch.no_grad()
def generate_world_tokens(model: ARTransformer, tokenizer: DiscreteVideoFSQTokenizer,
                          video: torch.Tensor, temperature: float = 1.0, top_p: float = 0.8,
                          quantize_kv: bool = False, gumbel=None, seed: int = 0,
                          max_new_tokens: Optional[int] = None, record: Optional[dict] = None,
                          on_step=None) -> torch.Tensor:
    """Tokenize a (1, 3, chunk, H, W) prompt, prefill its first half of
    latent frames (at least one) and generate the rest of the preset's
    grid: the clipped tokens as (1, T, H', W'). max_new_tokens cuts the
    generation (the rest of the grid is then the prompt's token 0; a cut
    run on the full-width model). record gets "encode_s", "prefill_s" and
    "decode_s" (``Laps``: one-item lists) when given; on_step(i) is called
    once the i-th new token is sampled."""
    laps = Laps(model.device, record)
    _, indices = tokenizer.encode(video)
    laps.lap("encode_s")
    _, Tl, Hl, Wl = indices.shape
    total_t = model.cfg.latent_shape[0]
    n_prefix_t = max(1, Tl // 2)
    prefix = indices[:, :n_prefix_t].reshape(1, -1)
    n_new = (total_t - n_prefix_t) * Hl * Wl
    cut = n_new if max_new_tokens is None else min(n_new, max_new_tokens)
    log.info(f"AR generation: prefix {prefix.shape[1]} tokens, generating {cut} of {n_new}")
    tokens = generate(model, prefix, cut, temperature=temperature, top_p=top_p,
                      quantize_kv=quantize_kv, gumbel=gumbel, seed=seed,
                      on_step=lambda i: _step(i, laps, on_step))
    laps.lap("decode_s")
    if cut < n_new:
        tokens = torch.cat([tokens, tokens.new_zeros((1, n_new - cut))], dim=1)
    vocab = tokenizer.cfg.vocab_size
    return tokens.clamp(0, vocab - 1).reshape(1, total_t, Hl, Wl)


def _step(i: int, laps: Laps, on_step) -> None:
    if i == 0:
        laps.lap("prefill_s")
    if on_step is not None:
        on_step(i)


def demo(args, built: Optional[tuple] = None, record: Optional[dict] = None,
         gumbel=None) -> str:
    """Run the CLI; returns the saved video's path. ``built`` = (model,
    tokenizer, decoder or None) to reuse (the decoder then is used unless
    --disable_diffusion_decoder); ``record`` receives the frames ("video",
    uint8 (T, H, W, 3)) and the tokens ("tokens"); ``gumbel`` the sampling
    noise (default: a generator seeded with --seed)."""
    preset = AR_PRESETS[args.model_preset]
    device = resolve_device(args.device)
    if built is not None:
        model, tokenizer, dd = built
    else:
        model = build_ar_model(preset, device, args.seed, args.checkpoint_dir)
        tokenizer = build_dv_tokenizer(preset, device, args.seed, args.checkpoint_dir)
        dd = None
        if not args.disable_diffusion_decoder:
            from gen3c_tpu_torch.pipelines.diffusion_decoder import build_dd_pipeline

            try:
                dd = build_dd_pipeline(args.model_preset, device, args.seed + 9,
                                       args.checkpoint_dir)
            except FileNotFoundError as e:
                log.warning(f"diffusion decoder unavailable ({e}); "
                            "falling back to the DV tokenizer decode")
    if args.disable_diffusion_decoder:
        dd = None

    video, _ = io_utils.read_video_bcthw(args.input_video, preset.height, preset.width)
    if video.shape[2] < preset.chunk:
        raise ValueError(f"need >= {preset.chunk} frames, got {video.shape[2]}")
    video = torch.from_numpy(np.ascontiguousarray(video[:, :, :preset.chunk])).to(device)
    log.info("Tokenizing input video...")
    grid = generate_world_tokens(model, tokenizer, video, args.temperature, args.top_p,
                                 args.quantize_kv, gumbel, args.seed)
    if dd is not None:
        log.info("Refining generated tokens with the diffusion decoder...")
        dd.sampling.num_steps = args.diffusion_decoder_steps
        t_pixels = grid.shape[1] // tokenizer.latent_chunk_duration * preset.chunk
        out = dd.refine(grid, seed=args.seed)[:, :, :t_pixels]
    else:
        log.info("Decoding generated tokens...")
        out = tokenizer.decode(grid)
    frames = out[0].permute(1, 2, 3, 0).float().cpu().numpy()
    frames = ((frames + 1) / 2 * 255).clip(0, 255).astype(np.uint8)
    if record is not None:
        record["video"] = frames
        record["tokens"] = grid.cpu().numpy()
    path = os.path.join(args.video_save_folder, f"{args.video_save_name}.mp4")
    path = io_utils.save_video(frames, args.fps, path)
    log.info(f"Saved video to {path}")
    return path


def main(argv=None) -> str:
    return demo(create_parser().parse_args(argv))


if __name__ == "__main__":
    main()
