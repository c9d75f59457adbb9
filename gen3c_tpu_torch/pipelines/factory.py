"""Model presets and construction (port of gen3c_tpu/pipelines/factory.py).

"gen3c_7b" is GEN3C-Cosmos-7B at full width (28 blocks x 4096 channels,
32 heads x 128, bf16 DiT, fp32 CV8x8x8 VAE); "gen3c_tiny" is the same
topology at test size in fp32. No checkpoint loading yet: weights are a
seeded random init drawn on the target device. ``apply_perf_preset``
expands ``--perf_preset fast`` (W8A8, band attention, step caching,
guidance interval) as the JAX package does; ``add_perf_flags``,
``check_ported`` and ``build_from_args`` serve the CLIs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import torch

from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT
from gen3c_tpu_torch.models.gen3c import Gen3CModel
from gen3c_tpu_torch.models.quantize import quantize_dit_
from gen3c_tpu_torch.models.vae import CV8x8x8, CausalVAE, VAEConfig, VideoTokenizer
from gen3c_tpu_torch.utils import log


@dataclasses.dataclass(frozen=True)
class Gen3CPreset:
    name: str
    dit: DiTConfig
    vae: VAEConfig
    height: int
    width: int
    chunk_size: int  # pixel frames per diffusion call
    frame_buffer_max: int = 2

    @property
    def state_shape(self) -> Tuple[int, int, int, int]:
        lat_t = (self.chunk_size - 1) // self.vae.temporal_compression + 1
        return (
            self.vae.latent_channels,
            lat_t,
            self.height // self.vae.spatial_compression,
            self.width // self.vae.spatial_compression,
        )


GEN3C_7B_PRESET = Gen3CPreset(
    name="gen3c_7b",
    dit=DiTConfig(in_channels=16 + 16 * 4 + 1, rope_t_extrapolation_ratio=2.0),
    vae=CV8x8x8,
    height=704,
    width=1280,
    chunk_size=121,
)

GEN3C_TINY_PRESET = Gen3CPreset(
    name="gen3c_tiny",
    dit=DiTConfig(
        in_channels=16 + 16 * 4 + 1,
        model_channels=96,
        num_blocks=2,
        num_heads=4,
        adaln_lora_dim=8,
        crossattn_emb_channels=1024,
        rope_t_extrapolation_ratio=2.0,
        dtype=torch.float32,
    ),
    vae=VAEConfig(
        channels=16,
        channels_mult=(2, 4, 4),
        num_res_blocks=1,
        attn_resolutions=(),
        resolution=256,
        patch_size=4,
        latent_channels=16,
        z_channels=16,
    ),
    height=96,
    width=160,
    chunk_size=9,
)

PRESETS = {p.name: p for p in (GEN3C_7B_PRESET, GEN3C_TINY_PRESET)}

# checkpoint files the JAX factory would load; the port cannot yet
_CHECKPOINT_FILES = (
    os.path.join("GEN3C-Cosmos-7B", "model.pt"),
    os.path.join("gen3c_tpu", "dit.npz"),
    os.path.join("gen3c_tpu", "vae.npz"),
    "Cosmos-Tokenize1-CV8x8x8-720p",
)


def build_gen3c_model(
    preset: Union[str, Gen3CPreset] = "gen3c_7b",
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    checkpoint_dir: Optional[str] = None,
    quantize: Union[bool, str] = False,
    attn_temporal_window: Optional[int] = None,
) -> Tuple[Gen3CModel, Gen3CPreset]:
    """Build a Gen3CModel with seeded random weights on ``device``.

    dtype overrides the preset's DiT dtype (bf16 for 7B, fp32 for tiny);
    the VAE stays fp32. quantize: False, "int8" (weight-only) or "w8a8"
    (int8 weights and activations); the DiT is quantized after the build,
    layer by layer on the device, as the JAX factory does (:333-341).
    attn_temporal_window sets the DiT's band self-attention (K3). A
    checkpoint_dir that holds real weights raises: loading them is not
    ported yet, and silently ignoring them would change what the run
    means.
    """
    if quantize not in (False, "int8", "w8a8"):
        raise ValueError(f"quantize must be False, 'int8' or 'w8a8', got {quantize!r}")
    if isinstance(preset, str):
        preset = PRESETS[preset]
    if checkpoint_dir:
        found = [f for f in _CHECKPOINT_FILES if os.path.exists(os.path.join(checkpoint_dir, f))]
        if found:
            raise NotImplementedError(
                f"checkpoint loading is not ported yet (found {found} in {checkpoint_dir})"
            )
    if dtype is not None:
        preset = dataclasses.replace(preset, dit=dataclasses.replace(preset.dit, dtype=dtype))
    if attn_temporal_window is not None:
        preset = dataclasses.replace(preset, dit=dataclasses.replace(
            preset.dit, attn_temporal_window=attn_temporal_window))
    device = torch.device(device)
    log.warning(f"No checkpoint loading in this port; RANDOM init ({preset.name}, seed {seed}).")

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        net = GeneralDIT(preset.dit)
        vae = CausalVAE(preset.vae)
    net = net.to_empty(device=device).init_random(gen)
    vae = vae.to_empty(device=device).init_random(gen)
    if quantize:
        log.info(f"quantizing DiT weights to int8 ({quantize})")
        quantize_dit_(net, act_quant=quantize == "w8a8")
    net.eval()
    vae.eval()
    tokenizer = VideoTokenizer(vae, pixel_chunk_duration=preset.chunk_size,
                               spatial_resolution=(preset.height, preset.width))
    model = Gen3CModel(
        net=net,
        tokenizer=tokenizer,
        frame_buffer_max=preset.frame_buffer_max,
        chunk_size=preset.chunk_size,
        state_shape=preset.state_shape,
    )
    return model, preset


def apply_perf_preset(args) -> None:
    """Expand --perf_preset into individual knobs, only where the user left
    the default, so explicit flags win (gen3c_tpu/pipelines/factory.py
    ``apply_perf_preset``). "fast" = W8A8 + temporal-band window 2 +
    step-cache interval 2 + guidance interval sigma 1.75..81; "exact"
    (default) changes nothing."""
    if getattr(args, "perf_preset", "exact") != "fast":
        return
    if not (getattr(args, "quantize_w8a8", False) or getattr(args, "quantize_int8", False)):
        args.quantize_w8a8 = True
    if getattr(args, "attn_temporal_window", None) is None:
        args.attn_temporal_window = 2
    if getattr(args, "step_cache_interval", 1) <= 1 and not getattr(
            args, "step_cache_threshold", 0.0):
        args.step_cache_interval = 2
    if getattr(args, "guidance_interval", None) is None:
        args.guidance_interval = [1.75, 81.0]


def add_perf_flags(p) -> None:
    """The speed flags the dynamic and multiview CLIs share with
    gen3c_tpu's ``add_perf_flags`` (same names and defaults), and
    ``--device``."""
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--perf_preset", choices=["exact", "fast"], default="exact",
                   help="'fast' = W8A8 + band window 2 + step-cache interval 2 + "
                        "guidance interval 1.75..81; explicit flags win")
    p.add_argument("--quantize_int8", action="store_true",
                   help="int8 weight-only DiT (dequantized bf16 matmuls)")
    p.add_argument("--quantize_w8a8", action="store_true",
                   help="int8 DiT weights and per-token int8 activations (kernels K7q + K7)")
    p.add_argument("--offload_diffusion_transformer", action="store_true", help="not ported yet")
    p.add_argument("--offload_tokenizer", action="store_true", help="not ported yet")
    p.add_argument("--step_cache_interval", type=int, default=1,
                   help="> 1: run the DiT every Nth step after a 2-step warmup and "
                        "before a 2-step tail, reusing its output between")
    p.add_argument("--attn_temporal_window", type=int, default=None,
                   help="band self-attention (kernel K3): each latent frame attends "
                        "to frames within +/- N plus the seed frame")
    p.add_argument("--guidance_interval", type=float, nargs=2, default=None,
                   metavar=("SIGMA_LO", "SIGMA_HI"),
                   help="run CFG only on steps whose sigma lies in [LO, HI]")
    p.add_argument("--cfg_rescale", type=float, default=0.0,
                   help="phi in [0, 1]: blend in the CFG output rescaled to the cond "
                        "branch's std; 0 = plain CFG")
    p.add_argument("--cp_attn", type=str, default=None,
                   choices=["allgather", "ring", "ulysses"], help="not ported yet")
    p.add_argument("--parallel", type=str, default="cp", help="multi-device: not ported yet")
    p.add_argument("--num_devices", "--num_gpus", type=int, default=1, dest="num_devices",
                   help="> 1 not ported yet")


def check_ported(args) -> None:
    """Raise NotImplementedError naming the first set flag of a CLI whose
    feature this port does not have (flags a CLI lacks count as unset)."""
    unported = {
        "--step_cache_block_span": getattr(args, "step_cache_block_span", None) is not None,
        "--step_cache_span_dtype": getattr(args, "step_cache_span_dtype", "bf16") != "bf16",
        "--solver": getattr(args, "solver", "euler") != "euler",
        "--num_devices": getattr(args, "num_devices", 1) > 1,
        "--parallel": getattr(args, "parallel", "cp") != "cp",
        "--cp_attn": getattr(args, "cp_attn", None) is not None,
        "--enable_prompt_encoder": not getattr(args, "disable_prompt_encoder", True),
        "--offload_diffusion_transformer": getattr(args, "offload_diffusion_transformer", False),
        "--offload_tokenizer": getattr(args, "offload_tokenizer", False),
    }
    for flag, used in unported.items():
        if used:
            raise NotImplementedError(f"{flag} is not ported to gen3c_tpu_torch yet")


def build_from_args(args) -> Tuple[Gen3CModel, Gen3CPreset]:
    """``apply_perf_preset``, ``check_ported``, then ``build_gen3c_model`` on
    ``args.device`` with the quantization and band the flags ask for."""
    apply_perf_preset(args)
    check_ported(args)
    quantize = "w8a8" if args.quantize_w8a8 else ("int8" if args.quantize_int8 else False)
    return build_gen3c_model(args.model_preset, device=args.device, seed=args.seed,
                             checkpoint_dir=args.checkpoint_dir, quantize=quantize,
                             attn_temporal_window=args.attn_temporal_window)


def validate_num_frames(num_video_frames: int, chunk_size: int) -> None:
    """A run chains chunks of chunk_size frames with one frame of overlap."""
    n = num_video_frames
    if n < chunk_size or (n - 1) % (chunk_size - 1):
        raise ValueError(
            f"num_video_frames must be {chunk_size} + k*{chunk_size - 1} (got {n})")
