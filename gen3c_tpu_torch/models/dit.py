"""GeneralDIT: the Cosmos 7B video diffusion transformer in PyTorch.

Port of gen3c_tpu/models/dit.py ``dit_forward`` (no tensor or sequence
parallelism), differentiable for training (attention's
backward is kernel K4), with optional per-block remat. Under context
parallelism (``forward(cp=axis)``, one process per rank) the tokens are
this rank's contiguous latent-T shard: the position tables are built for
the whole sequence and sliced, and self-attention runs one of the JAX
package's three strategies (``DiTConfig.cp_attn_impl``): "ulysses" (an
all-to-all to H/cp heads of the whole sequence, kernel K1cp, then back),
"ring" (KV shards passed around the ring, each folded in by K1ring and
merged by K1merge) or "allgather" (K/V gathered, kernel K1ag).
The module tree carries the reference checkpoint's parameter names, the
left-hand side of gen3c_tpu/models/convert.py ``convert_dit_state_dict``,
so a reference ``model.pt`` loads with ``load_state_dict``:

  x_embedder.proj.1.weight, t_embedder.1.linear_{1,2}.weight,
  affline_norm.weight, extra_pos_embedder.pos_emb_{t,h,w},
  blocks.block{i}.blocks.{0: self-attn, 1: cross-attn, 2: MLP}.*,
  final_layer.{linear,adaLN_modulation.{1,2}}.weight

Numerics follow the JAX package: tokens (B, L, D) with L = T*H*W in the
model dtype; timestep embedding, AdaLN-LoRA modulation, norms statistics
and RoPE in fp32; erf-GELU MLP. Self-attention runs through kernel K1, or
K3 with ``attn_temporal_window`` set (each latent frame attends to the
frames within the window plus the first ``attn_prefix_frames``), and
cross-attention through K2 (``gen3c_tpu_torch.kernels.attention``).

After ``models.quantize.quantize_dit_`` the large linears are QuantLinear
and resolve as dit.py ``_w`` / ``_linear`` do: q/k/v/out/fc1/fc2 run their
own forward (the W8A8 kernels K7q + K7, or a dequantized matmul), the
patch embedding dequantizes in the model dtype and the timestep MLP in
fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.models.quantize import linear_weight
from gen3c_tpu_torch.parallel import collectives
from gen3c_tpu_torch.parallel.mesh import Axis


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """GeneralDIT hyper-parameters; defaults are the 7B FADITV2 net."""

    max_img_h: int = 240
    max_img_w: int = 240
    max_frames: int = 128
    in_channels: int = 16
    out_channels: int = 16
    patch_spatial: int = 2
    patch_temporal: int = 1
    model_channels: int = 4096
    num_blocks: int = 28
    num_heads: int = 32
    mlp_ratio: float = 4.0
    crossattn_emb_channels: int = 1024
    adaln_lora_dim: int = 256
    rope_h_extrapolation_ratio: float = 1.0
    rope_w_extrapolation_ratio: float = 1.0
    rope_t_extrapolation_ratio: float = 1.0
    concat_padding_mask: bool = True
    base_fps: int = 24
    dtype: torch.dtype = torch.bfloat16
    # temporal-band self-attention (K3): None = full attention (K1)
    attn_temporal_window: Optional[int] = None
    attn_prefix_frames: int = 1
    # self-attention under context parallelism: allgather, ring or ulysses
    cp_attn_impl: str = "allgather"
    # Delta-DiT span caching (arXiv:2406.01125): blocks [lo, hi) are the
    # span whose residual delta the sampler carries; its skipped steps run
    # the other blocks and re-apply the delta. None: no span
    cache_block_span: Optional[Tuple[int, int]] = None
    # the carry: "bf16" (or "fp32") keeps the delta in the token dtype,
    # "int8" per-token symmetric codes with fp32 scales
    cache_span_dtype: str = "bf16"

    @property
    def head_dim(self) -> int:
        return self.model_channels // self.num_heads

    @property
    def patch_in_dim(self) -> int:
        c = self.in_channels + (1 if self.concat_padding_mask else 0)
        return c * self.patch_spatial * self.patch_spatial * self.patch_temporal

    @property
    def len_h(self) -> int:
        return self.max_img_h // self.patch_spatial

    @property
    def len_w(self) -> int:
        return self.max_img_w // self.patch_spatial

    @property
    def len_t(self) -> int:
        return self.max_frames // self.patch_temporal


# ------------------------------ functional pieces ------------------------------


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 statistics and a learnable scale."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (out * weight.float()).to(x.dtype)


def _layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine parameters, fp32 statistics."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


def _l2_rms_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / (eps + ||x|| / sqrt(D)) on the last dim, in fp32."""
    xf = x.float()
    norm = eps + torch.linalg.vector_norm(xf, dim=-1, keepdim=True) / math.sqrt(x.shape[-1])
    return (xf / norm).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """erf-GELU as jax.nn.gelu(approximate=False) computes it: 0.5 * x *
    erfc(-x * sqrt(0.5)) with every product rounded in x's dtype and
    sqrt(0.5) itself rounded to it (0.70703 in bf16). F.gelu's single fp32
    evaluation would be off by a bias of ~2e-4 per bf16 element. In place
    on one temporary, which rounds the same: (-x) * c == x * (-c), and
    scaling by 0.5 is exact, so the order of the last two products does
    not matter."""
    neg_sqrt_half = -float(torch.tensor(math.sqrt(0.5), dtype=x.dtype))
    return (x * neg_sqrt_half).erfc_().mul_(x).mul_(0.5)


def timestep_sincos(timesteps: torch.Tensor, num_channels: int) -> torch.Tensor:
    """[cos | sin] sincos features, fp32."""
    half = num_channels // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=timesteps.device) / half
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def rope_3d_table(cfg: DiTConfig, T: int, H: int, W: int, fps: Optional[float] = None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape (T*H*W, head_dim), fp32: head_dim split t/h/w as
    rest/(d//6*2)/(d//6*2), NTK-extrapolated thetas, [t|h|w|t|h|w] layout.
    Built in float64 numpy, exactly as the JAX package builds it."""
    d = cfg.head_dim
    dim_h = d // 6 * 2
    dim_w = dim_h
    dim_t = d - 2 * dim_h
    h_ntk = cfg.rope_h_extrapolation_ratio ** (dim_h / (dim_h - 2))
    w_ntk = cfg.rope_w_extrapolation_ratio ** (dim_w / (dim_w - 2))
    t_ntk = cfg.rope_t_extrapolation_ratio ** (dim_t / (dim_t - 2))
    h_range = np.arange(0, dim_h, 2)[: dim_h // 2].astype(np.float64) / dim_h
    t_range = np.arange(0, dim_t, 2)[: dim_t // 2].astype(np.float64) / dim_t
    h_freqs = 1.0 / (10000.0 * h_ntk) ** h_range
    w_freqs = 1.0 / (10000.0 * w_ntk) ** h_range
    t_freqs = 1.0 / (10000.0 * t_ntk) ** t_range
    t_scale = np.arange(T, dtype=np.float64)
    if fps is not None:
        t_scale = t_scale / fps * cfg.base_fps
    half_t = np.outer(t_scale, t_freqs)
    half_h = np.outer(np.arange(H, dtype=np.float64), h_freqs)
    half_w = np.outer(np.arange(W, dtype=np.float64), w_freqs)
    ang = np.concatenate([
        np.broadcast_to(half_t[:, None, None, :], (T, H, W, half_t.shape[1])),
        np.broadcast_to(half_h[None, :, None, :], (T, H, W, half_h.shape[1])),
        np.broadcast_to(half_w[None, None, :, :], (T, H, W, half_w.shape[1])),
    ], axis=-1)
    ang = np.concatenate([ang, ang], axis=-1).reshape(T * H * W, d)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """GPT-NeoX rotate-half RoPE in fp32. x: (B, L, heads, d); cos/sin: (L, d)."""
    d = x.shape[-1]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    out = x.float() * cos[None, :, None, :] + rot.float() * sin[None, :, None, :]
    return out.to(x.dtype)


def _adaln_modulation(mod: nn.Sequential, emb: torch.Tensor, lora: torch.Tensor,
                      n_chunks: int):
    """SiLU -> Linear(D, lora) -> Linear(lora, nD) + shared LoRA term, fp32."""
    h = F.silu(emb.float())
    h = F.linear(h, mod[1].weight.float())
    h = F.linear(h, mod[2].weight.float())
    h = h + lora[:, : h.shape[-1]].float()
    return torch.chunk(h, n_chunks, dim=-1)


# ------------------------- context-parallel self-attention -------------------------

# ring steps this process folded (K1ring) and skipped under the band
ring_steps = {"folded": 0, "skipped": 0}


def ring_step_needed(q_rank: int, kv_rank: int, frames: int, band) -> bool:
    """Whether a query shard and a KV shard of ``frames`` latent frames each
    hold a (query frame, key frame) pair inside the band or its prefix
    (dit.py:633-641, decided on the host: each rank knows both origins)."""
    _, window, prefix = band
    qf0, kf0 = q_rank * frames, kv_rank * frames
    return ((kf0 <= qf0 + frames - 1 + window and qf0 <= kf0 + frames - 1 + window)
            or kf0 < prefix)


def _ulysses_attention(q, k, v, cp: Axis, band=None):
    """dit.py ``_ulysses_attention`` (:653-678): an all-to-all turns the
    (B, L/cp, H, D) sequence shards into (B, L, H/cp, D) head shards, K1
    (K3 under the band, whose positions are global: each rank holds the
    whole sequence) runs on them as K1cp, a second all-to-all restores
    the sequence shards. Needs H % cp == 0."""
    qg, kg, vg = (collectives.seq_to_heads(t, cp) for t in (q, k, v))
    out = kernels.attention(qg, kg, vg, kernel_id="K1cp", band=band)
    return collectives.heads_to_seq(out, cp)


def _ring_attention(q, k, v, cp: Axis, band=None):
    """dit.py ``_ring_attention`` (:529-650): rank r keeps its query shard
    and passes the KV shards around the ring (after s shifts it holds rank
    r - s's). Each step folds the shard it holds into the queries (K1ring:
    the forward with lse at the shards' global positions) and merges the
    result into a running fp32 output and lse (K1merge); the last merge
    writes q's dtype. Under the band a step whose two shards share no
    visible frame pair is skipped (its shift still runs). The shift after
    the last step, whose result dit.py never reads, is left out."""
    n, r = cp.size, cp.rank
    B, L, H, D = q.shape
    frames = None
    if band is not None:
        if L % band[0]:
            raise ValueError(f"ring attention under the band: the shard of {L} tokens must be "
                             f"whole frames of {band[0]}")
        frames = L // band[0]
    acc = torch.zeros((B, L, H, D), dtype=torch.float32, device=q.device)
    acc_lse = torch.full((B, H, L), -math.inf, dtype=torch.float32, device=q.device)
    out = None
    for step in range(n):
        kv_rank = (r - step) % n
        last = step == n - 1
        if band is None or ring_step_needed(r, kv_rank, frames, band):
            o, lse = kernels.ring_fold(q, k, v, band, r * L, kv_rank * L)
            out = kernels.ring_merge(acc, acc_lse, o, lse, q.dtype if last else None)
            ring_steps["folded"] += 1
        else:
            ring_steps["skipped"] += 1
            if last:
                out = kernels.ring_merge(acc, acc_lse, final_dtype=q.dtype)
        if not last:
            k, v = collectives.ring_shift([k, v], cp)
    return out


def _allgather_attention(q, k, v, cp: Axis):
    """dit.py's all-gather strategy (:763-766): K and V gathered over the
    axis, then K1 with Lq = L/cp queries over all L keys (K1ag)."""
    k, v = (collectives.all_gather(t, 1, cp) for t in (k, v))
    return kernels.attention(q, k, v, kernel_id="K1ag")


def cp_self_attention(q, k, v, cp: Axis, impl: str, band=None):
    """Self-attention of this rank's sequence shard under context
    parallelism, by strategy (dit.py:737-766)."""
    if band is not None and impl not in ("ulysses", "ring"):
        raise ValueError(
            "attn_temporal_window under context parallelism requires cp_attn_impl='ulysses' "
            "(local full-sequence attention) or 'ring' (dynamic per-rank band masks); the "
            "allgather strategy's splash mask is program-static under SPMD and cannot encode "
            "per-rank q offsets")
    if impl == "ring":
        return _ring_attention(q, k, v, cp, band)
    if impl == "ulysses":
        return _ulysses_attention(q, k, v, cp, band)
    if impl != "allgather":
        raise ValueError(f"unknown cp_attn_impl {impl!r}; expected 'allgather', 'ring' or "
                         f"'ulysses'")
    return _allgather_attention(q, k, v, cp)


# ------------------------------ span carry ------------------------------

# a span delta: (B, L, D) in the token dtype, or (int8 codes, fp32 scales (B, L, 1))
SpanDelta = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def quantize_span_delta(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 of a span delta (dit.py:1082-1090): scale
    = absmax / 127 as XLA compiles it, a multiply by the fp32 reciprocal;
    codes = round(d / max(scale, 1e-8)) clipped to +-127. An elementwise
    pass that XLA runs outside any kernel, plain PyTorch here too."""
    df = d.float()
    scales = df.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0)
    codes = torch.round(df / scales.clamp_min(1e-8)).clamp_(-127, 127).to(torch.int8)
    return codes, scales


def dequantize_span_delta(delta: SpanDelta) -> torch.Tensor:
    """The carried delta as values: codes * scales in fp32 for the int8
    carry, the tensor itself otherwise."""
    if isinstance(delta, tuple):
        codes, scales = delta
        return codes.float() * scales
    return delta


# ------------------------------ modules ------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        return _rms_norm(x, self.weight)


def _linear(din: int, dout: int, device, dtype) -> nn.Linear:
    return nn.Linear(din, dout, bias=False, device=device, dtype=dtype)


class Attention(nn.Module):
    """q/k/v/out projections with per-head RMSNorm on q and k."""

    def __init__(self, dim: int, ctx_dim: int, num_heads: int, device=None, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.to_q = nn.Sequential(_linear(dim, dim, device, dtype), RMSNorm(hd, device, dtype))
        self.to_k = nn.Sequential(_linear(ctx_dim, dim, device, dtype), RMSNorm(hd, device, dtype))
        self.to_v = nn.Sequential(_linear(ctx_dim, dim, device, dtype))
        self.to_out = nn.Sequential(_linear(dim, dim, device, dtype))

    def forward(self, x, context=None, rope=None, band=None, cp=None, cp_impl="allgather"):
        """cp: the context-parallel axis (self-attention of a sequence
        shard, by strategy cp_impl; see ``cp_self_attention``)."""
        B, L, D = x.shape
        ctx = x if context is None else context
        hd = D // self.num_heads
        q = self.to_q[1](self.to_q[0](x).view(B, L, -1, hd))
        k = self.to_k[1](self.to_k[0](ctx).view(B, ctx.shape[1], -1, hd))
        v = self.to_v[0](ctx).view(B, ctx.shape[1], -1, hd)
        if context is None:
            q = apply_rope(q, *rope)
            k = apply_rope(k, *rope)
        if context is None and cp is not None:
            out = cp_self_attention(q, k, v, cp, cp_impl, band)
        else:
            out = kernels.attention(q, k, v, kernel_id="K1" if context is None else "K2",
                                    band=band)
        return self.to_out[0](out.reshape(B, L, D))


class VideoAttn(nn.Module):
    def __init__(self, dim, ctx_dim, num_heads, device=None, dtype=None):
        super().__init__()
        self.attn = Attention(dim, ctx_dim, num_heads, device, dtype)

    def forward(self, x, context=None, rope=None, band=None, cp=None, cp_impl="allgather",
                n_views: int = 1):
        """n_views > 1 (cross-attention of the multiview net): the views fold
        into the batch, tokens (B, V*Lv, D) -> (B*V, Lv, D) and context (B,
        V*M, D_ctx) -> (B*V, M, D_ctx), views of the same memory, so each
        view attends to its own prompt (dit_multiview.py:198-206)."""
        if n_views > 1:
            B, L, D = x.shape
            ctx = context.reshape(B * n_views, context.shape[1] // n_views, context.shape[2])
            out = self.attn(x.reshape(B * n_views, L // n_views, D), ctx)
            return out.reshape(B, L, D)
        return self.attn(x, context, rope, band, cp, cp_impl)


class GPT2FeedForward(nn.Module):
    """Linear -> erf-GELU -> Linear, no biases."""

    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        self.layer1 = _linear(dim, hidden, device, dtype)
        self.layer2 = _linear(hidden, dim, device, dtype)

    def forward(self, x):
        return self.layer2(_gelu(self.layer1(x)))


class DITBuildingBlock(nn.Module):
    """One sub-block with its AdaLN: x + gate * f(LN(x) * (1 + scale) + shift)."""

    def __init__(self, block: nn.Module, dim: int, lora_dim: int, device=None, dtype=None):
        super().__init__()
        self.block = block
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), _linear(dim, lora_dim, device, dtype), _linear(lora_dim, 3 * dim, device, dtype)
        )

    def forward(self, x, emb, lora, **block_kwargs):
        shift, scale, gate = _adaln_modulation(self.adaLN_modulation, emb, lora, 3)
        modded = (_layer_norm(x).float() * (1 + scale[:, None, :]) + shift[:, None, :]).to(x.dtype)
        return x + gate[:, None, :].to(x.dtype) * self.block(modded, **block_kwargs)


class GeneralDITTransformerBlock(nn.Module):
    """Self-attention -> cross-attention -> MLP."""

    def __init__(self, cfg: DiTConfig, device=None, dtype=None):
        super().__init__()
        D, L = cfg.model_channels, cfg.adaln_lora_dim
        self.blocks = nn.ModuleList([
            DITBuildingBlock(VideoAttn(D, D, cfg.num_heads, device, dtype), D, L, device, dtype),
            DITBuildingBlock(VideoAttn(D, cfg.crossattn_emb_channels, cfg.num_heads, device, dtype),
                             D, L, device, dtype),
            DITBuildingBlock(GPT2FeedForward(D, int(D * cfg.mlp_ratio), device, dtype),
                             D, L, device, dtype),
        ])

    def forward(self, x, emb, lora, extra, ctx, rope, band=None, cp=None, cp_impl="allgather",
                n_views: int = 1):
        x = x + extra
        x = self.blocks[0](x, emb, lora, rope=rope, band=band, cp=cp, cp_impl=cp_impl)
        x = self.blocks[1](x, emb, lora, context=ctx, n_views=n_views)
        return self.blocks[2](x, emb, lora)


class _PatchEmbed(nn.Module):
    def __init__(self, din, dout, device=None, dtype=None):
        super().__init__()
        # index 0 is the reference's Rearrange (no parameters)
        self.proj = nn.Sequential(nn.Identity(), _linear(din, dout, device, dtype))


class _TimestepEmbedding(nn.Module):
    def __init__(self, dim, device=None, dtype=None):
        super().__init__()
        self.linear_1 = _linear(dim, dim, device, dtype)
        self.linear_2 = _linear(dim, 3 * dim, device, dtype)


class _LearnablePosEmbAxis(nn.Module):
    def __init__(self, cfg: DiTConfig, device=None, dtype=None):
        super().__init__()
        D = cfg.model_channels
        self.pos_emb_t = nn.Parameter(torch.zeros(cfg.len_t, D, device=device, dtype=dtype))
        self.pos_emb_h = nn.Parameter(torch.zeros(cfg.len_h, D, device=device, dtype=dtype))
        self.pos_emb_w = nn.Parameter(torch.zeros(cfg.len_w, D, device=device, dtype=dtype))

    def forward(self, T: int, H: int, W: int) -> torch.Tensor:
        """Cropped per-axis embeddings, summed in the parameter dtype and
        RMS-normalised: (T, H, W, D)."""
        emb = (self.pos_emb_t[:T, None, None, :] + self.pos_emb_h[None, :H, None, :]
               + self.pos_emb_w[None, None, :W, :])
        return _l2_rms_normalize(emb)


class _FinalLayer(nn.Module):
    def __init__(self, cfg: DiTConfig, device=None, dtype=None):
        super().__init__()
        D, L = cfg.model_channels, cfg.adaln_lora_dim
        out = cfg.patch_spatial ** 2 * cfg.patch_temporal * cfg.out_channels
        self.linear = _linear(D, out, device, dtype)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), _linear(D, L, device, dtype), _linear(L, 2 * D, device, dtype)
        )


class GeneralDIT(nn.Module):
    """The denoiser: (B, C, T, H, W) latent + timesteps + text -> (B, 16, T, H, W)."""

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        D = cfg.model_channels
        self.x_embedder = _PatchEmbed(cfg.patch_in_dim, D, device, dt)
        self.t_embedder = nn.Sequential(nn.Identity(), _TimestepEmbedding(D, device, dt))
        self.affline_norm = RMSNorm(D, device, dt)
        self.extra_pos_embedder = _LearnablePosEmbAxis(cfg, device, dt)
        self.blocks = nn.ModuleDict({
            f"block{i}": GeneralDITTransformerBlock(cfg, device, dt) for i in range(cfg.num_blocks)
        })
        self.final_layer = _FinalLayer(cfg, device, dt)
        self.requires_grad_(False)
        self._rope_cache = {}

    def patchify(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor],
                 extra_channels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, C, T, H, W) -> (B, T', H', W', D) tokens; patch channel order
        (c, t_patch, h_patch, w_patch). The channels are [x | padding mask |
        extra_channels]: the multiview net's view condition goes last."""
        cfg = self.cfg
        B, _, T, H, W = x.shape
        parts = [x]
        if cfg.concat_padding_mask:
            if padding_mask is None:
                padding_mask = torch.zeros((B, H, W), dtype=x.dtype, device=x.device)
            parts.append(padding_mask[:, None, None].to(x.dtype).expand(B, 1, T, H, W))
        if extra_channels is not None:
            parts.append(extra_channels)
        x = torch.cat(parts, dim=1) if len(parts) > 1 else x
        C = x.shape[1]
        ps, pt = cfg.patch_spatial, cfg.patch_temporal
        x = x.reshape(B, C, T // pt, pt, H // ps, ps, W // ps, ps)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(B, T // pt, H // ps, W // ps, C * pt * ps * ps)
        return F.linear(x, linear_weight(self.x_embedder.proj[1], x.dtype))

    def unpatchify(self, x: torch.Tensor, T: int, H: int, W: int) -> torch.Tensor:
        """(B, T', H', W', p*p*t*C) -> (B, C, T, H, W), channel layout (p1, p2, t, C)."""
        cfg = self.cfg
        B = x.shape[0]
        ps, pt, C = cfg.patch_spatial, cfg.patch_temporal, cfg.out_channels
        x = x.reshape(B, T // pt, H // ps, W // ps, ps, ps, pt, C)
        return x.permute(0, 7, 1, 6, 2, 4, 3, 5).reshape(B, C, T, H, W)

    def rope(self, T: int, H: int, W: int, fps: Optional[float], device,
             rank: int = 0, size: int = 1):
        """The RoPE table of a (T * size, H, W) grid, cut to the tokens of
        latent frames [rank T, (rank + 1) T) (t-major tokens: a T-chunk is
        an L-chunk), cached per shape, fps, device and rank."""
        key = (T, H, W, fps, str(device), rank, size)
        if key not in self._rope_cache:
            L = T * H * W
            cos, sin = rope_3d_table(self.cfg, T * size, H, W, fps=fps, device=device)
            self._rope_cache = {key: (cos[rank * L:(rank + 1) * L], sin[rank * L:(rank + 1) * L])}
        return self._rope_cache[key]

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, crossattn_emb: torch.Tensor,
                fps: Optional[float] = None,
                padding_mask: Optional[torch.Tensor] = None,
                remat: bool = False, cp: Optional[Axis] = None,
                span_delta: Optional[SpanDelta] = None, return_span_delta: bool = False,
                return_block_residuals: bool = False, action: Optional[torch.Tensor] = None,
                cp_attn_impl: Optional[str] = None):
        """remat=True recomputes each block's activations in the backward
        instead of keeping them (``torch.utils.checkpoint``, non-reentrant:
        dit.py's ``jax.checkpoint(block_step)``, :1040-1045). Serving calls
        this under ``torch.no_grad()`` (the sampler, the pipeline), and a
        fresh net's parameters do not require grad; the trainer turns
        them on.

        cp: the context-parallel axis (size > 1). x is then this rank's
        contiguous latent-T shard; the RoPE table and the extra position
        embedding are built for the T * cp frames and sliced to it
        (dit.py:929-946), and self-attention runs ``cfg.cp_attn_impl``, or
        ``cp_attn_impl`` when given (the training step's "ulysses"). With a
        gradient tracked, the strategy's collectives carry it back
        (``parallel.collectives``): K1cp's forward with lse and K4 run on
        each rank's H/cp heads of the whole sequence.

        Span caching (``cfg.cache_block_span`` = (lo, hi), dit.py:1048-1118):
        return_span_delta=True also returns what the span's blocks added to
        the tokens (tokens after block hi - 1 less the tokens entering block
        lo; zeros for an empty span), in the token dtype or, with
        ``cache_span_dtype`` "int8", as (int8 codes, fp32 per-token
        scales); span_delta given instead adds that delta at block lo and
        skips blocks [lo, hi). return_block_residuals=True returns (out,
        (num_blocks,) fp32) with each block's mean |output - input| over
        mean |input|, which ranks the blocks for a span (under cp, this
        rank's shard's).

        action: (B, 7) or (B, T_act, 7) robot actions, for an ``ActionDiT``
        (models/dit_action.py; dit.py:864-985): the first frame's action
        runs through ``action_embedder_B_3D`` (fc1, tanh-form GELU, fc2,
        fp32) and adds to the AdaLN-LoRA vector. ``action_embedder_B_D`` is
        carried and never applied, as in gen3c_tpu and the reference, whose
        B_D add lands on a local rebound after the affine embedding was
        taken (general_dit_action.py:421-431)."""
        cfg = self.cfg
        dtype = cfg.dtype
        B, C, T, H, W = x.shape
        tokens = self.patchify(x.to(dtype), padding_mask)
        _, Tp, Hp, Wp, D = tokens.shape
        L = Tp * Hp * Wp
        tokens = tokens.reshape(B, L, D)
        rank, size = (0, 1) if cp is None else (cp.rank, cp.size)
        rope = self.rope(Tp, Hp, Wp, fps, x.device, rank, size)
        extra = self.extra_pos_embedder(Tp * size, Hp, Wp)[rank * Tp:(rank + 1) * Tp]
        extra = extra.to(dtype).reshape(1, L, D)
        band = (None if cfg.attn_temporal_window is None
                else (Hp * Wp, cfg.attn_temporal_window, cfg.attn_prefix_frames))

        emb, lora = self.time_embedding(timesteps, action)
        ctx = crossattn_emb.to(dtype)
        impl = cfg.cp_attn_impl if cp_attn_impl is None else cp_attn_impl
        span = cfg.cache_block_span
        if (span_delta is not None or return_span_delta) and span is None:
            raise ValueError("span_delta/return_span_delta need cfg.cache_block_span")
        lo, hi = span if span is not None else (-1, -1)
        tokens_at_lo = new_delta = None
        residuals = []
        for bi, blk in enumerate(self.blocks.values()):
            if bi == lo:
                if span_delta is not None:  # a skipped step: the cached delta
                    tokens = tokens + dequantize_span_delta(span_delta).to(tokens.dtype)
                elif return_span_delta:
                    tokens_at_lo = tokens
            if span_delta is not None and lo <= bi < hi:
                continue
            before = tokens if return_block_residuals else None
            if remat and torch.is_grad_enabled():
                tokens = checkpoint(blk, tokens, emb, lora, extra, ctx, rope, band, cp, impl,
                                    use_reentrant=False)
            else:
                tokens = blk(tokens, emb, lora, extra, ctx, rope, band, cp, impl)
            if return_block_residuals:
                bf = before.float()
                residuals.append((tokens.float() - bf).abs().mean() / (bf.abs().mean() + 1e-8))
            if return_span_delta and lo < hi and bi == hi - 1:
                new_delta = self._span_carry(tokens - tokens_at_lo)
        if return_span_delta and lo == hi:  # an empty span adds nothing
            new_delta = self._span_carry(torch.zeros_like(tokens))

        out = self.unpatchify(self.final(tokens, emb, lora).reshape(B, Tp, Hp, Wp, -1), T, H, W)
        if return_block_residuals:
            return out, torch.stack(residuals)
        if return_span_delta:
            return out, new_delta
        return out

    def time_embedding(self, timesteps: torch.Tensor, action: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(emb, lora), fp32: the affine embedding RMSNorm(sincos) and the
        2-layer MLP's AdaLN-LoRA vector, plus the action term if given."""
        sincos = timestep_sincos(timesteps.reshape(-1), self.cfg.model_channels)
        temb = self.t_embedder[1]
        h = F.silu(F.linear(sincos, linear_weight(temb.linear_1, torch.float32)))
        lora = F.linear(h, linear_weight(temb.linear_2, torch.float32))
        if action is not None:
            mlp = getattr(self, "action_embedder_B_3D", None)
            if mlp is None:
                raise ValueError("action conditioning needs an ActionDiT (models/dit_action.py)")
            a = (action[:, 0] if action.ndim == 3 else action).float()
            h = F.gelu(F.linear(a, mlp.fc1.weight.float(), mlp.fc1.bias.float()),
                       approximate="tanh")
            lora = lora + F.linear(h, mlp.fc2.weight.float(), mlp.fc2.bias.float())
        return _rms_norm(sincos, self.affline_norm.weight), lora

    def final(self, tokens: torch.Tensor, emb: torch.Tensor, lora: torch.Tensor) -> torch.Tensor:
        """The final layer: AdaLN-modulated LayerNorm and the linear to
        patch channels, (B, L, p*p*t*C) in the model dtype."""
        dtype = self.cfg.dtype
        fshift, fscale = _adaln_modulation(self.final_layer.adaLN_modulation, emb, lora, 2)
        tokens = (_layer_norm(tokens).float() * (1 + fscale[:, None, :])
                  + fshift[:, None, :]).to(dtype)
        return F.linear(tokens, linear_weight(self.final_layer.linear, dtype))

    def _span_carry(self, d: torch.Tensor) -> SpanDelta:
        """The span delta as the sampler carries it (``cache_span_dtype``)."""
        return quantize_span_delta(d) if self.cfg.cache_span_dtype == "int8" else d

    @torch.no_grad()
    def randomize_degenerate_inits(self, generator: torch.Generator) -> "GeneralDIT":
        """Draw the blocks' zero-initialized AdaLN output layers and the
        final linear from 0.1 * N(0, 1) (dit.py ``randomize_degenerate_inits``):
        with them zero every block is the identity and the output constant,
        which leaves nothing for a caching policy or a block ranking to see."""
        for name, p in self.named_parameters():
            if (name.startswith("blocks.") and name.endswith("adaLN_modulation.2.weight")) \
                    or name == "final_layer.linear.weight":
                p.copy_(0.1 * torch.randn(p.shape, generator=generator, device=p.device))
        return self

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "GeneralDIT":
        """Xavier-uniform linears, zero AdaLN output layers and final linear,
        trunc-normal(0.02) timestep MLP and position embeddings, unit norms:
        the JAX package's random init, drawn from ``generator``."""
        for name, p in self.named_parameters():
            if name.endswith("adaLN_modulation.2.weight") or name == "final_layer.linear.weight":
                p.zero_()
            elif name.startswith(("t_embedder", "extra_pos_embedder")):
                tn = torch.empty(p.shape, dtype=torch.float32, device=p.device)
                p.copy_(nn.init.trunc_normal_(tn, std=0.02, a=-0.04, b=0.04, generator=generator))
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                p.uniform_(-bound, bound, generator=generator)
        return self
