"""Model presets and construction (port of gen3c_tpu/pipelines/factory.py).

"gen3c_7b" is GEN3C-Cosmos-7B at full width (28 blocks x 4096 channels,
32 heads x 128, bf16 DiT, fp32 CV8x8x8 VAE); "gen3c_tiny" is the same
topology at test size in fp32. ``build_gen3c_model`` loads the weights
the JAX factory loads, in its order (``checkpoint_dir`` layout below), and
draws a seeded random init on the target device, with a warning, for a
part it finds no checkpoint of. ``apply_perf_preset``
expands ``--perf_preset fast`` (W8A8, band attention, step caching,
guidance interval) as the JAX package does; ``add_perf_flags`` and
``build_from_args`` serve the CLIs.

Over several devices (``num_devices`` > 1, one process per rank as
``torchrun`` starts them) the model carries the process groups of its
``parallel`` strategy: "cp" (context parallel over every rank), "tp"
(the DiT's linears sharded Megatron-style over every rank), "cpNtpM"
(both, on N·M ranks; "cpNtpMsp" adds sequence parallelism), "cfg2" (the
CFG pair split over 2 ranks) or "cfg2[cpN][tpM]" (with cp and tp, on
2·N·M ranks), with ``cp_attn`` choosing the self-attention strategy
(gen3c_tpu/pipelines/factory.py:138-157, 374-453).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional, Tuple, Union

import torch

from gen3c_tpu_torch.bridge import dit_state_from_jax
from gen3c_tpu_torch.models.convert import dit_state_for_net
from gen3c_tpu_torch.models.dit import DiTConfig, GeneralDIT
from gen3c_tpu_torch.models.gen3c import Gen3CModel
from gen3c_tpu_torch.models.quantize import quantize_dit_
from gen3c_tpu_torch.models.vae import CV8x8x8, CausalVAE, VAEConfig, VideoTokenizer
from gen3c_tpu_torch.parallel import mesh
from gen3c_tpu_torch.parallel.sharding import shard_params
from gen3c_tpu_torch.utils import checkpoint as ckpt
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


def parse_parallel(parallel: str) -> Tuple[int, Optional[int], Optional[int], bool]:
    """(cfg, cp, tp, sp) of a strategy name, None for the axis that takes
    every rank: "cp" -> (1, None, 1, False), "tp" -> (1, 1, None, False),
    "cpNtpM[sp]" -> (1, N, M, sp), "cfg2[cpN][tpM]" -> (2, N or 1, M or 1,
    False). An unknown name raises ValueError
    (gen3c_tpu/pipelines/factory.py:374-453)."""
    cp_tp = re.fullmatch(r"cp(\d+)tp(\d+)(sp)?", parallel)
    cfg = re.fullmatch(r"cfg2(?:cp(\d+))?(?:tp(\d+))?", parallel)
    if parallel not in ("cp", "tp") and not cp_tp and not cfg:
        raise ValueError(f"unknown parallel strategy {parallel!r}")
    if cfg:
        return 2, int(cfg.group(1) or 1), int(cfg.group(2) or 1), False
    if cp_tp:
        return 1, int(cp_tp.group(1)), int(cp_tp.group(2)), cp_tp.group(3) == "sp"
    return (1, 1, None, False) if parallel == "tp" else (1, None, 1, False)


def resolve_layout(parallel: str, num_devices: int, quantize: Union[bool, str] = False
                   ) -> Tuple[int, int, int, bool]:
    """(cfg, cp, tp, sp) of a strategy over ``num_devices`` ranks, validated
    as gen3c_tpu's factory validates it (:374-453, its messages): an
    unknown name, a layout that needs another number of devices, "sp"
    without a tp axis, "cpNtpM" with quantize; and "cfg2[cpN]tpM" with
    quantize, where gen3c_tpu's shard_map would sum the ranks' whole
    quantized outputs over tp (a departure: refused here)."""
    cfg, cp, tp, sp = parse_parallel(parallel)
    cp = num_devices // cfg if cp is None else cp
    tp = num_devices if tp is None else tp
    if sp and tp < 2:
        raise ValueError("the 'sp' suffix (Megatron sequence parallelism) needs tp>=2")
    if cfg * cp * tp != num_devices:
        raise ValueError(f"parallel={parallel!r} needs {cfg * cp * tp} devices, got "
                         f"num_devices={num_devices}")
    if quantize and cfg == 1 and parallel not in ("cp", "tp"):
        raise ValueError("cpNtpM serving is the bf16 multi-chip path; combine with "
                         "quantize=False")
    if quantize and tp > 1 and cfg == 2:
        raise ValueError(
            f"parallel={parallel!r} with quantize: the quantized linears stay whole on "
            f"every rank (as gen3c_tpu's specs keep them), and gen3c_tpu's cfg2...tpM "
            f"shard_map sums their whole outputs over tp, a wrong result; use "
            f"quantize=False, or 'cfg2[cpN]' or 'tp'")
    return cfg, cp, tp, sp


def parallelize(model: Gen3CModel, parallel: str, num_devices: int,
                quantize: Union[bool, str] = False, backend: Optional[str] = None) -> mesh.Groups:
    """Lay ``model`` out over this job's ranks by a strategy
    (``resolve_layout``): the groups of its (cfg, cp, tp) mesh
    (``parallel.mesh.make_groups`` with ``backend``), its sequence
    parallelism and, over a tp axis, this rank's shards of the DiT
    (``parallel.sharding.shard_params``; a quantized sub-block stays
    whole). A net already cut for this tp size stays as it is, so a model
    may be laid out again by another strategy with the same tp. Every rank
    calls this with the same arguments; returns the groups."""
    cfg, cp, tp, sp = resolve_layout(parallel, num_devices, quantize)
    groups = mesh.make_groups(cfg=cfg, cp=cp, tp=tp, backend=backend)
    shard_params(model.net, groups)
    model.groups = groups
    model.sequence_parallel = sp
    log.info(f"parallel denoising over {num_devices} ranks: cfg={cfg} x cp={cp} x tp={tp}"
             + (" + sequence parallelism" if sp else "")
             + (f" ({model.net.cfg.cp_attn_impl} self-attention)" if cp > 1 else ""))
    return groups


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device a rank runs on: a bare "cuda" is cuda:$LOCAL_RANK (the
    card torchrun gives this process), made current; anything else as
    given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", mesh.local_rank())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def build_gen3c_model(
    preset: Union[str, Gen3CPreset] = "gen3c_7b",
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    checkpoint_dir: Optional[str] = None,
    quantize: Union[bool, str] = False,
    attn_temporal_window: Optional[int] = None,
    num_devices: int = 1,
    parallel: str = "cp",
    cp_attn: Optional[str] = None,
    dist_backend: Optional[str] = None,
    cache_block_span: Optional[Tuple[int, int]] = None,
    cache_span_dtype: str = "bf16",
) -> Tuple[Gen3CModel, Gen3CPreset]:
    """Build a Gen3CModel on ``device`` (a bare "cuda": cuda:$LOCAL_RANK),
    loading weights from ``checkpoint_dir`` as the JAX factory does
    (gen3c_tpu/pipelines/factory.py:179-267), first found first:

      DiT  <dir>/gen3c_tpu/dit_{int8,w8a8}.npz  pre-quantized, when quantizing
           <dir>/gen3c_tpu/dit.npz              native (JAX parameter tree)
           <dir>/GEN3C-Cosmos-7B/model.pt       the reference's torch pickle
      VAE  <dir>/gen3c_tpu/vae.npz              native (reference names)
           <dir>/Cosmos-Tokenize1-CV8x8x8-720p/{encoder,decoder}.jit + mean_std.pt

    A part with none of its files gets a seeded random init (``seed``),
    with a warning. Loading is strict: a key that is neither a parameter
    nor accounted for (``models.convert``) raises, and so does a missing
    one.

    dtype overrides the preset's DiT dtype (bf16 for 7B, fp32 for tiny);
    the VAE stays fp32. quantize: False, "int8" (weight-only) or "w8a8"
    (int8 weights and activations); the DiT is quantized after the build,
    layer by layer on the device, as the JAX factory does (:333-341),
    unless it was loaded pre-quantized. attn_temporal_window sets the
    DiT's band self-attention (K3).

    num_devices > 1: this process is one rank of a job of that many
    (``torchrun``'s environment; ``parallel.mesh.maybe_distributed_init``
    joins it with dist_backend, default NCCL on CUDA and gloo on the CPU;
    gloo also serves ranks that share one card). Every rank builds the same
    weights from the same seed, and ``parallelize`` lays the model out by
    the ``parallel`` strategy (the name is validated even at one device,
    the rest by ``resolve_layout`` as gen3c_tpu validates it over several,
    before the job is joined). With a tp axis each rank keeps its shard of
    the DiT: "tp" with quantize keeps the quantized linears whole on every
    rank, as JAX's specs do; "cpNtpM" refuses quantize as gen3c_tpu does,
    and so does "cfg2[cpN]tpM", where gen3c_tpu's shard_map would sum the
    ranks' whole outputs (a departure).
    cp_attn ("allgather", the default, "ring" or "ulysses") is the
    self-attention under context parallelism; a band over several devices
    needs "ulysses" or "ring".

    cache_block_span=(lo, hi), 0 <= lo <= hi <= num_blocks: the DiT blocks
    whose residual delta span caching carries (with step_cache_interval >
    1, the skipped steps run the other blocks), in cache_span_dtype ("bf16":
    the token dtype, or "int8").
    """
    if quantize not in (False, "int8", "w8a8"):
        raise ValueError(f"quantize must be False, 'int8' or 'w8a8', got {quantize!r}")
    parse_parallel(parallel)
    if cp_attn is not None and cp_attn not in ("allgather", "ring", "ulysses"):
        raise ValueError(f"unknown cp_attn {cp_attn!r}; expected 'allgather', 'ring' or "
                         f"'ulysses'")
    if isinstance(preset, str):
        preset = PRESETS[preset]
    if cache_block_span is not None:
        lo, hi = cache_block_span
        n = preset.dit.num_blocks
        if not 0 <= lo <= hi <= n:
            raise ValueError(f"cache_block_span {cache_block_span} out of range for {n} blocks")
        preset = dataclasses.replace(preset, dit=dataclasses.replace(
            preset.dit, cache_block_span=(lo, hi), cache_span_dtype=cache_span_dtype))
    if dtype is not None:
        preset = dataclasses.replace(preset, dit=dataclasses.replace(preset.dit, dtype=dtype))
    if cp_attn is not None:
        preset = dataclasses.replace(preset, dit=dataclasses.replace(
            preset.dit, cp_attn_impl=cp_attn))
    if attn_temporal_window is not None:
        if num_devices > 1 and preset.dit.cp_attn_impl not in ("ulysses", "ring"):
            raise ValueError(
                "attn_temporal_window over multiple devices requires cp_attn='ulysses' or "
                "'ring' (the allgather splash mask is program-static and lacks per-rank q "
                "offsets)")
        preset = dataclasses.replace(preset, dit=dataclasses.replace(
            preset.dit, attn_temporal_window=attn_temporal_window))
    device = resolve_device(device)
    if num_devices > 1:
        resolve_layout(parallel, num_devices, quantize)  # before the job is joined
        mesh.maybe_distributed_init(dist_backend, device)
        world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
        if world != num_devices:
            raise ValueError(f"num_devices={num_devices} but this job has {world} process(es): "
                             f"launch one per device (torchrun --nproc_per_node "
                             f"{num_devices})")
    gen = torch.Generator(device=device).manual_seed(seed)
    net, prequantized = _acquire_dit(preset, checkpoint_dir, quantize, device, gen, seed)
    vae, latent_mean, latent_std = _acquire_vae(preset, checkpoint_dir, device, gen)
    if quantize and not prequantized:
        log.info(f"quantizing DiT weights to int8 ({quantize})")
        quantize_dit_(net, act_quant=quantize == "w8a8")
    net.eval()
    vae.eval()
    tokenizer = VideoTokenizer(vae, pixel_chunk_duration=preset.chunk_size,
                               latent_mean=latent_mean, latent_std=latent_std,
                               spatial_resolution=(preset.height, preset.width))
    model = Gen3CModel(
        net=net,
        tokenizer=tokenizer,
        frame_buffer_max=preset.frame_buffer_max,
        chunk_size=preset.chunk_size,
        state_shape=preset.state_shape,
    )
    if num_devices > 1:
        parallelize(model, parallel, num_devices, quantize, dist_backend)
    return model, preset


def _acquire_dit(preset: Gen3CPreset, checkpoint_dir: Optional[str], quantize, device, gen,
                 seed: int) -> Tuple[GeneralDIT, bool]:
    """The DiT on ``device`` from the first checkpoint found, else a random
    init from ``gen``; and whether it came pre-quantized."""
    with torch.device("meta"):
        net = GeneralDIT(preset.dit)
    if checkpoint_dir:
        native_q = os.path.join(checkpoint_dir, "gen3c_tpu", f"dit_{quantize}.npz")
        if quantize and os.path.exists(native_q):
            quantize_dit_(net, act_quant=quantize == "w8a8", structure_only=True)
            net = net.to_empty(device=device)
            net.load_state_dict(dit_state_from_jax(ckpt.load_params_npz_tree(native_q)))
            log.info(f"Loaded pre-quantized DiT from {native_q}")
            return net, True
        native = os.path.join(checkpoint_dir, "gen3c_tpu", "dit.npz")
        torch_dit = os.path.join(checkpoint_dir, "GEN3C-Cosmos-7B", "model.pt")
        if os.path.exists(native):
            state = dit_state_from_jax(ckpt.load_params_npz_tree(native))
            log.info(f"Loaded DiT weights from {native}")
        elif os.path.exists(torch_dit):
            state = dit_state_for_net(ckpt.load_torch_dit_checkpoint(torch_dit),
                                      net.state_dict().keys())
            log.info(f"Converted DiT weights from {torch_dit}")
        else:
            state = None
        if state is not None:
            net = net.to_empty(device=device)
            net.load_state_dict(state)
            return net, False
    log.warning(f"No DiT checkpoint found; RANDOM init ({preset.name}, seed {seed}). "
                "Generated videos will be noise-quality.")
    return net.to_empty(device=device).init_random(gen), False


def _acquire_vae(preset: Gen3CPreset, checkpoint_dir: Optional[str], device, gen):
    """(the VAE on ``device``, latent mean, latent std) from the first
    checkpoint found, else a random init from ``gen`` and no statistics."""
    with torch.device("meta"):
        vae = CausalVAE(preset.vae)
    vae = vae.to_empty(device=device)
    state = mean = std = None
    if checkpoint_dir:
        native = os.path.join(checkpoint_dir, "gen3c_tpu", "vae.npz")
        vae_dir = os.path.join(checkpoint_dir, "Cosmos-Tokenize1-CV8x8x8-720p")
        if os.path.exists(native):
            state = ckpt.vae_state_dict(ckpt.load_flat_npz(native))
            log.info(f"Loaded VAE weights from {native}")
        elif os.path.isdir(vae_dir):
            state, mean, std = ckpt.load_torchscript_tokenizer(vae_dir)
            log.info(f"Converted VAE weights from {vae_dir}")
    if state is None:
        log.warning("No VAE checkpoint found; RANDOM init.")
        return vae.init_random(gen), None, None
    vae.load_state_dict(state)
    lat_t = (preset.chunk_size - 1) // preset.vae.temporal_compression + 1
    c = preset.vae.latent_channels
    mean, std = (None if x is None else x.reshape(1, c, -1, 1, 1)[:, :, :lat_t]
                 for x in (mean, std))
    return vae, mean, std


def build_tokenizer(preset: Gen3CPreset, device: Union[str, torch.device] = "cuda",
                    seed: int = 0, checkpoint_dir: Optional[str] = None) -> VideoTokenizer:
    """Only the video tokenizer of a preset, on ``device`` (gen3c_tpu's
    ``build_tokenizer``, for pipelines with a DiT of their own): the VAE
    from ``checkpoint_dir`` as ``build_gen3c_model`` finds it, else a
    random init from ``seed``; its chunk is ``preset.chunk_size`` frames."""
    device = resolve_device(device)
    vae, mean, std = _acquire_vae(preset, checkpoint_dir, device,
                                  torch.Generator(device=device).manual_seed(seed))
    vae.eval()
    return VideoTokenizer(vae, pixel_chunk_duration=preset.chunk_size, latent_mean=mean,
                          latent_std=std, spatial_resolution=(preset.height, preset.width))


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
                   help="torch device to run on (cuda = cuda:$LOCAL_RANK, cuda:N or cpu)")
    p.add_argument("--perf_preset", choices=["exact", "fast"], default="exact",
                   help="'fast' = W8A8 + band window 2 + step-cache interval 2 + "
                        "guidance interval 1.75..81; explicit flags win")
    p.add_argument("--quantize_int8", action="store_true",
                   help="int8 weight-only DiT (dequantized bf16 matmuls)")
    p.add_argument("--quantize_w8a8", action="store_true",
                   help="int8 DiT weights and per-token int8 activations (kernels K7q + K7)")
    p.add_argument("--offload_diffusion_transformer", action="store_true",
                   help="accepted and ignored: the DiT stays on the device")
    p.add_argument("--offload_tokenizer", action="store_true",
                   help="accepted and ignored: the VAE stays on the device")
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
    add_parallel_flags(p)


def add_parallel_flags(p) -> None:
    """gen3c_tpu's multi-device flags: --num_devices/--num_gpus, --parallel
    and --cp_attn."""
    p.add_argument("--cp_attn", type=str, default=None,
                   choices=["allgather", "ring", "ulysses"],
                   help="self-attention under context parallelism (default allgather)")
    p.add_argument("--parallel", type=str, default="cp",
                   help="multi-device strategy: cp, tp, cpNtpM[sp] or cfg2[cpN][tpM]")
    p.add_argument("--num_devices", "--num_gpus", type=int, default=1, dest="num_devices",
                   help="> 1: one process per device, launched by torchrun --nproc_per_node N")


def build_from_args(args) -> Tuple[Gen3CModel, Gen3CPreset]:
    """``apply_perf_preset``, then ``build_gen3c_model`` on ``args.device``
    with the quantization, band, span cache and parallel strategy the flags
    ask for; ``args.device`` becomes the device the rank runs on. The
    offload flags are accepted and change nothing (offload is not ported:
    the 7B fits one card, with a span carry beside it)."""
    apply_perf_preset(args)
    for flag, what in (("offload_diffusion_transformer", "the DiT"),
                       ("offload_tokenizer", "the VAE")):
        if getattr(args, flag, False):
            log.info(f"--{flag}: ignored, {what} stays on the device (offload is not ported)")
    quantize = "w8a8" if args.quantize_w8a8 else ("int8" if args.quantize_int8 else False)
    model, preset = build_gen3c_model(args.model_preset, device=args.device, seed=args.seed,
                                      checkpoint_dir=args.checkpoint_dir, quantize=quantize,
                                      attn_temporal_window=args.attn_temporal_window,
                                      num_devices=args.num_devices, parallel=args.parallel,
                                      cp_attn=args.cp_attn,
                                      cache_block_span=getattr(args, "step_cache_block_span", None),
                                      cache_span_dtype=getattr(args, "step_cache_span_dtype",
                                                               "bf16"))
    args.device = str(model.device)
    return model, preset


def add_prompt_encoder_flags(p) -> None:
    """gen3c_tpu's prompt-encoder flags: --t5_backend and
    --enable_prompt_encoder / --disable_prompt_encoder (the default)."""
    p.add_argument("--t5_backend", type=str, default="jax", choices=["jax", "torch"],
                   help="the prompt encoder's T5 stack: jax = this package's encoder on "
                        "--device, torch = transformers' T5EncoderModel")
    p.add_argument("--disable_prompt_encoder", action="store_true", default=True)
    p.add_argument("--enable_prompt_encoder", dest="disable_prompt_encoder",
                   action="store_false",
                   help="encode the prompts with T5-11B from <checkpoint_dir>/google-t5/t5-11b "
                        "or the local Hugging Face cache (needs transformers); default: zeros")


def build_text_encoder(args, device: Union[str, torch.device]):
    """The prompt encoder ``--enable_prompt_encoder`` asks for, on
    ``device``: ``models.t5.make_t5_encoder(--t5_backend)``, its weights
    from <checkpoint_dir>/google-t5/t5-11b or the local Hugging Face cache
    (missing files or ``transformers`` raise, naming what is missing); or
    None, zero embeddings, without the flag (the CLIs' default)."""
    if getattr(args, "disable_prompt_encoder", True):
        return None
    from gen3c_tpu_torch.models.t5 import make_t5_encoder

    return make_t5_encoder(getattr(args, "t5_backend", "jax"), args.checkpoint_dir, device=device)


def validate_num_frames(num_video_frames: int, chunk_size: int) -> None:
    """A run chains chunks of chunk_size frames with one frame of overlap."""
    n = num_video_frames
    if n < chunk_size or (n - 1) % (chunk_size - 1):
        raise ValueError(
            f"num_video_frames must be {chunk_size} + k*{chunk_size - 1} (got {n})")
