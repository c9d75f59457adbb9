"""GeneralDIT: the Cosmos 7B video diffusion transformer in PyTorch.

Port of gen3c_tpu/models/dit.py ``dit_forward`` for one device (no
context/tensor/sequence parallelism, no span cache, no band attention).
The module tree carries the reference checkpoint's parameter names, the
left-hand side of gen3c_tpu/models/convert.py ``convert_dit_state_dict``,
so a reference ``model.pt`` loads with ``load_state_dict``:

  x_embedder.proj.1.weight, t_embedder.1.linear_{1,2}.weight,
  affline_norm.weight, extra_pos_embedder.pos_emb_{t,h,w},
  blocks.block{i}.blocks.{0: self-attn, 1: cross-attn, 2: MLP}.*,
  final_layer.{linear,adaLN_modulation.{1,2}}.weight

Numerics follow the JAX package: tokens (B, L, D) with L = T*H*W in the
model dtype; timestep embedding, AdaLN-LoRA modulation, norms statistics
and RoPE in fp32; erf-GELU MLP. Self-attention runs through kernel K1 and
cross-attention through K2 (``gen3c_tpu_torch.kernels.attention``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gen3c_tpu_torch import kernels


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

    def forward(self, x, context=None, rope=None):
        B, L, D = x.shape
        ctx = x if context is None else context
        hd = D // self.num_heads
        q = self.to_q[1](self.to_q[0](x).view(B, L, -1, hd))
        k = self.to_k[1](self.to_k[0](ctx).view(B, ctx.shape[1], -1, hd))
        v = self.to_v[0](ctx).view(B, ctx.shape[1], -1, hd)
        if context is None:
            q = apply_rope(q, *rope)
            k = apply_rope(k, *rope)
        out = kernels.attention(q, k, v, kernel_id="K1" if context is None else "K2")
        return self.to_out[0](out.reshape(B, L, D))


class VideoAttn(nn.Module):
    def __init__(self, dim, ctx_dim, num_heads, device=None, dtype=None):
        super().__init__()
        self.attn = Attention(dim, ctx_dim, num_heads, device, dtype)

    def forward(self, x, context=None, rope=None):
        return self.attn(x, context, rope)


class GPT2FeedForward(nn.Module):
    """Linear -> erf-GELU -> Linear, no biases."""

    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        self.layer1 = _linear(dim, hidden, device, dtype)
        self.layer2 = _linear(hidden, dim, device, dtype)

    def forward(self, x, context=None, rope=None):
        return self.layer2(F.gelu(self.layer1(x), approximate="none"))


class DITBuildingBlock(nn.Module):
    """One sub-block with its AdaLN: x + gate * f(LN(x) * (1 + scale) + shift)."""

    def __init__(self, block: nn.Module, dim: int, lora_dim: int, device=None, dtype=None):
        super().__init__()
        self.block = block
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), _linear(dim, lora_dim, device, dtype), _linear(lora_dim, 3 * dim, device, dtype)
        )

    def forward(self, x, emb, lora, context=None, rope=None):
        shift, scale, gate = _adaln_modulation(self.adaLN_modulation, emb, lora, 3)
        modded = (_layer_norm(x).float() * (1 + scale[:, None, :]) + shift[:, None, :]).to(x.dtype)
        return x + gate[:, None, :].to(x.dtype) * self.block(modded, context, rope)


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

    def forward(self, x, emb, lora, extra, ctx, rope):
        x = x + extra
        x = self.blocks[0](x, emb, lora, rope=rope)
        x = self.blocks[1](x, emb, lora, context=ctx)
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

    def patchify(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, C, T, H, W) -> (B, T', H', W', D) tokens; patch channel order
        (c, t_patch, h_patch, w_patch)."""
        cfg = self.cfg
        B, C, T, H, W = x.shape
        ps, pt = cfg.patch_spatial, cfg.patch_temporal
        if cfg.concat_padding_mask:
            if padding_mask is None:
                padding_mask = torch.zeros((B, H, W), dtype=x.dtype, device=x.device)
            pm = padding_mask[:, None, None].to(x.dtype).expand(B, 1, T, H, W)
            x = torch.cat([x, pm], dim=1)
            C += 1
        x = x.reshape(B, C, T // pt, pt, H // ps, ps, W // ps, ps)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(B, T // pt, H // ps, W // ps, C * pt * ps * ps)
        return self.x_embedder.proj[1](x)

    def unpatchify(self, x: torch.Tensor, T: int, H: int, W: int) -> torch.Tensor:
        """(B, T', H', W', p*p*t*C) -> (B, C, T, H, W), channel layout (p1, p2, t, C)."""
        cfg = self.cfg
        B = x.shape[0]
        ps, pt, C = cfg.patch_spatial, cfg.patch_temporal, cfg.out_channels
        x = x.reshape(B, T // pt, H // ps, W // ps, ps, ps, pt, C)
        return x.permute(0, 7, 1, 6, 2, 4, 3, 5).reshape(B, C, T, H, W)

    def rope(self, T: int, H: int, W: int, fps: Optional[float], device):
        key = (T, H, W, fps, str(device))
        if key not in self._rope_cache:
            self._rope_cache = {key: rope_3d_table(self.cfg, T, H, W, fps=fps, device=device)}
        return self._rope_cache[key]

    @torch.no_grad()
    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, crossattn_emb: torch.Tensor,
                fps: Optional[float] = None,
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        dtype = cfg.dtype
        B, C, T, H, W = x.shape
        tokens = self.patchify(x.to(dtype), padding_mask)
        _, Tp, Hp, Wp, D = tokens.shape
        L = Tp * Hp * Wp
        tokens = tokens.reshape(B, L, D)
        rope = self.rope(Tp, Hp, Wp, fps, x.device)
        extra = self.extra_pos_embedder(Tp, Hp, Wp).to(dtype).reshape(1, L, D)

        # affine emb = RMSNorm(sincos); lora = the 2-layer MLP output
        sincos = timestep_sincos(timesteps.reshape(-1), D)
        temb = self.t_embedder[1]
        h = F.silu(F.linear(sincos, temb.linear_1.weight.float()))
        lora = F.linear(h, temb.linear_2.weight.float())
        emb = _rms_norm(sincos, self.affline_norm.weight)

        ctx = crossattn_emb.to(dtype)
        for blk in self.blocks.values():
            tokens = blk(tokens, emb, lora, extra, ctx, rope)

        fshift, fscale = _adaln_modulation(self.final_layer.adaLN_modulation, emb, lora, 2)
        tokens = (_layer_norm(tokens).float() * (1 + fscale[:, None, :])
                  + fshift[:, None, :]).to(dtype)
        tokens = self.final_layer.linear(tokens)
        return self.unpatchify(tokens.reshape(B, Tp, Hp, Wp, -1), T, H, W)

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
