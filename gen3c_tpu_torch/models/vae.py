"""Causal 3D-conv video VAE tokenizer (Cosmos CV8x8x8) in PyTorch.

Port of gen3c_tpu/models/vae.py. The parameters live in an ``nn.Module``
tree whose ``state_dict`` keys are the reference tokenizer's names (e.g.
``encoder.down.0.block.1.conv1.0.conv3d.weight``), the same flat names the
JAX package uses, so ``bridge.vae_state_from_jax`` is the identity. The
forward is functional over those parameters: causal conv3d (replicated
first frame on the left, zero spatial padding) through ``F.conv3d``,
per-frame GroupNorm(1), Haar (de)patching by strided slicing, factorized
resblocks, hybrid down/upsampling, and the mid-block spatial and temporal
attentions as plain matmul + softmax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
_SQRT2 = math.sqrt(2.0)
# spatial attention: frames per chunk so that the fp32 logits stay ~1 GiB
_ATTN_LOGITS_PER_CHUNK = 1 << 28


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """CV tokenizer hyper-parameters."""

    in_channels: int = 3
    out_channels: int = 3
    channels: int = 128
    channels_mult: Tuple[int, ...] = (2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (32,)
    resolution: int = 1024
    patch_size: int = 4
    latent_channels: int = 16
    z_channels: int = 16
    z_factor: int = 1
    spatial_compression: int = 8
    temporal_compression: int = 8
    dtype: torch.dtype = torch.float32

    @property
    def num_resolutions(self) -> int:
        return len(self.channels_mult)

    @property
    def num_spatial_downs(self) -> int:
        return int(math.log2(self.spatial_compression)) - int(math.log2(self.patch_size))

    @property
    def num_temporal_downs(self) -> int:
        return int(math.log2(self.temporal_compression)) - int(math.log2(self.patch_size))


CV8x8x8 = VAEConfig()


# --------------------------- primitive layers ---------------------------


def causal_conv3d(params: Params, name: str, x: torch.Tensor, kernel: Tuple[int, int, int],
                  stride: int = 1, time_stride: int = 1, padding: int = 1) -> torch.Tensor:
    """Replicate the first frame time_pad times on the left, zero-pad space."""
    w = params[f"{name}.conv3d.weight"]
    b = params.get(f"{name}.conv3d.bias")
    time_pad = (kernel[0] - 1) + (1 - time_stride)
    if time_pad > 0:
        x = torch.cat([x[:, :, :1].expand(-1, -1, time_pad, -1, -1), x], dim=2)
    if padding > 0:
        x = F.pad(x, (padding, padding, padding, padding))
    return F.conv3d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=(time_stride, stride, stride))


def group_norm_per_frame(params: Params, name: str, x: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm(num_groups=1) per frame: statistics over (C, H, W) of each
    (batch, frame), fp32, per-channel affine."""
    B, C, T, H, W = x.shape
    xf = x.float().transpose(1, 2).reshape(B * T, C, H, W)
    out = F.group_norm(xf, 1, params[f"{name}.norm.weight"].float(),
                       params[f"{name}.norm.bias"].float(), eps)
    return out.reshape(B, T, C, H, W).transpose(1, 2).to(x.dtype)


# ------------------------------ Haar patching ------------------------------
# Haar filters: low-pass (flipped) (1/sqrt2, 1/sqrt2), high-pass (1/sqrt2, -1/sqrt2)
_HL = (1.0 / _SQRT2, 1.0 / _SQRT2)
_HH = (1.0 / _SQRT2, -1.0 / _SQRT2)


def _pair(x: torch.Tensor, k, dim: int) -> torch.Tensor:
    """y[i] = k0 * x[2i] + k1 * x[2i+1] along dim (stride-2 depthwise)."""
    n = x.shape[dim]
    even = x.narrow(dim, 0, n - 1)[(slice(None),) * dim + (slice(None, None, 2),)]
    odd = x.narrow(dim, 1, n - 1)[(slice(None),) * dim + (slice(None, None, 2),)]
    return k[0] * even + k[1] * odd


def _dwt3d(x: torch.Tensor) -> torch.Tensor:
    """One 3D Haar level: reflect pad (0,1) on T/H/W, 8 subbands on channels,
    rescaled by 1 / (2 sqrt 2)."""
    x = F.pad(x, (0, 1, 0, 1, 0, 1), mode="reflect")
    outs = []
    for a in (_pair(x, _HL, 2), _pair(x, _HH, 2)):
        for bb in (_pair(a, _HL, 3), _pair(a, _HH, 3)):
            outs.append(_pair(bb, _HL, 4))
            outs.append(_pair(bb, _HH, 4))
    return torch.cat(outs, dim=1) / (2.0 * _SQRT2)


def _up(a: torch.Tensor, k, dim: int) -> torch.Tensor:
    """Transposed stride-2 length-2 conv: y[2i] = k0 x[i], y[2i+1] = k1 x[i]."""
    stacked = torch.stack([k[0] * a, k[1] * a], dim=dim + 1)
    shape = list(a.shape)
    shape[dim] *= 2
    return stacked.reshape(shape)


def _idwt3d(x: torch.Tensor) -> torch.Tensor:
    """Inverse of _dwt3d, rescaled by 2 sqrt 2."""
    xlll, xllh, xlhl, xlhh, xhll, xhlh, xhhl, xhhh = torch.chunk(x, 8, dim=1)
    xll = _up(xlll, _HL, 4) + _up(xllh, _HH, 4)
    xlh = _up(xlhl, _HL, 4) + _up(xlhh, _HH, 4)
    xhl = _up(xhll, _HL, 4) + _up(xhlh, _HH, 4)
    xhh = _up(xhhl, _HL, 4) + _up(xhhh, _HH, 4)
    xl = _up(xll, _HL, 3) + _up(xlh, _HH, 3)
    xh = _up(xhl, _HL, 3) + _up(xhh, _HH, 3)
    return (_up(xl, _HL, 2) + _up(xh, _HH, 2)) * (2.0 * _SQRT2)


def haar_patch3d(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Replicate the first frame patch_size times, then log2(patch_size)
    DWT levels."""
    x = torch.cat([x[:, :, :1].expand(-1, -1, patch_size, -1, -1), x[:, :, 1:]], dim=2)
    for _ in range(int(math.log2(patch_size))):
        x = _dwt3d(x)
    return x


def haar_unpatch3d(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    for _ in range(int(math.log2(patch_size))):
        x = _idwt3d(x)
    return x[:, :, patch_size - 1:]


# ------------------------------ blocks ------------------------------


def resblock_factorized(params: Params, name: str, x: torch.Tensor, in_ch: int,
                        out_ch: int) -> torch.Tensor:
    h = F.silu(group_norm_per_frame(params, f"{name}.norm1", x))
    h = causal_conv3d(params, f"{name}.conv1.0", h, (1, 3, 3), padding=1)
    h = causal_conv3d(params, f"{name}.conv1.1", h, (3, 1, 1), padding=0)
    h = F.silu(group_norm_per_frame(params, f"{name}.norm2", h))
    h = causal_conv3d(params, f"{name}.conv2.0", h, (1, 3, 3), padding=1)
    h = causal_conv3d(params, f"{name}.conv2.1", h, (3, 1, 1), padding=0)
    if in_ch != out_ch:
        x = causal_conv3d(params, f"{name}.nin_shortcut", x, (1, 1, 1), padding=0)
    return x + h


def _qkv(params: Params, name: str, x: torch.Tensor):
    h = group_norm_per_frame(params, f"{name}.norm", x)
    return tuple(causal_conv3d(params, f"{name}.{p}", h, (1, 1, 1), padding=0)
                 for p in ("q", "k", "v"))


def attn_spatial(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Per-frame spatial self-attention, a few frames at a time (at 720p one
    frame's logits are 14080^2 fp32)."""
    B, C, T, H, W = x.shape
    q, k, v = (a.permute(0, 2, 3, 4, 1).reshape(B * T, H * W, C) for a in _qkv(params, name, x))
    per = max(1, _ATTN_LOGITS_PER_CHUNK // (H * W * H * W))
    outs = []
    for s in range(0, B * T, per):
        logits = torch.bmm(q[s:s + per], k[s:s + per].transpose(1, 2)).float() * (C ** -0.5)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        outs.append(torch.bmm(probs, v[s:s + per]))
    out = torch.cat(outs, dim=0).reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)
    return x + causal_conv3d(params, f"{name}.proj_out", out, (1, 1, 1), padding=0)


def attn_temporal(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Causal attention over time, per spatial position."""
    B, C, T, H, W = x.shape
    q, k, v = (a.permute(0, 3, 4, 2, 1).reshape(B * H * W, T, C) for a in _qkv(params, name, x))
    logits = torch.bmm(q, k.transpose(1, 2)).float() * (C ** -0.5)
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    logits = logits.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.bmm(probs, v).reshape(B, H, W, T, C).permute(0, 4, 3, 1, 2)
    return x + causal_conv3d(params, f"{name}.proj_out", out, (1, 1, 1), padding=0)


def hybrid_downsample(params: Params, name: str, x: torch.Tensor, spatial: bool,
                      temporal: bool) -> torch.Tensor:
    if not spatial and not temporal:
        return x
    if spatial:
        xp = F.pad(x, (0, 1, 0, 1))
        x1 = causal_conv3d(params, f"{name}.conv1", xp, (1, 3, 3), stride=2, padding=0)
        x = x1 + F.avg_pool3d(xp, (1, 2, 2), (1, 2, 2))
    if temporal:
        xp = torch.cat([x[:, :, :1], x], dim=2)
        x1 = causal_conv3d(params, f"{name}.conv2", xp, (3, 1, 1), time_stride=2, padding=0)
        x = x1 + F.avg_pool3d(xp, (2, 1, 1), (2, 1, 1))
    return causal_conv3d(params, f"{name}.conv3", x, (1, 1, 1), padding=0)


def hybrid_upsample(params: Params, name: str, x: torch.Tensor, spatial: bool,
                    temporal: bool) -> torch.Tensor:
    if not spatial and not temporal:
        return x
    if temporal:
        tf = 2 if x.shape[2] > 1 else 1
        x = x.repeat_interleave(tf, dim=2)[:, :, tf - 1:]
        x = causal_conv3d(params, f"{name}.conv1", x, (3, 1, 1), padding=0) + x
    if spatial:
        x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        x = causal_conv3d(params, f"{name}.conv2", x, (1, 3, 3), padding=1) + x
    return causal_conv3d(params, f"{name}.conv3", x, (1, 1, 1), padding=0)


# --------------------------- encoder / decoder ---------------------------


def _level_channels(cfg: VAEConfig):
    in_mult = (1,) + tuple(cfg.channels_mult)
    return [(cfg.channels * in_mult[i], cfg.channels * cfg.channels_mult[i])
            for i in range(cfg.num_resolutions)]


def _up_flags(cfg: VAEConfig, i_level: int) -> Tuple[bool, bool]:
    i_rev = cfg.num_resolutions - i_level - 1
    temporal_up = 0 < i_rev < cfg.num_temporal_downs + 1
    spatial_up = temporal_up or (
        i_rev < cfg.num_spatial_downs and cfg.num_spatial_downs > cfg.num_temporal_downs
    )
    return spatial_up, temporal_up


def vae_encode(params: Params, cfg: VAEConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, 3, T, H, W) in [-1, 1] -> latent (B, 16, (T-1)/8+1, H/8, W/8)."""
    x = haar_patch3d(x.to(cfg.dtype), cfg.patch_size)
    h = causal_conv3d(params, "encoder.conv_in.0", x, (1, 3, 3), padding=1)
    h = causal_conv3d(params, "encoder.conv_in.1", h, (3, 1, 1), padding=0)
    curr_res = cfg.resolution // cfg.patch_size
    for i_level, (cin, cout) in enumerate(_level_channels(cfg)):
        block_in = cin
        for i_block in range(cfg.num_res_blocks):
            h = resblock_factorized(params, f"encoder.down.{i_level}.block.{i_block}", h,
                                    block_in, cout)
            block_in = cout
            if curr_res in cfg.attn_resolutions:
                base = f"encoder.down.{i_level}.attn.{i_block}"
                h = attn_temporal(params, f"{base}.1", attn_spatial(params, f"{base}.0", h))
        if i_level != cfg.num_resolutions - 1:
            h = hybrid_downsample(params, f"encoder.down.{i_level}.downsample", h,
                                  spatial=i_level < cfg.num_spatial_downs,
                                  temporal=i_level < cfg.num_temporal_downs)
            curr_res //= 2
    mid = cfg.channels * cfg.channels_mult[-1]
    h = resblock_factorized(params, "encoder.mid.block_1", h, mid, mid)
    h = attn_temporal(params, "encoder.mid.attn_1.1", attn_spatial(params, "encoder.mid.attn_1.0", h))
    h = resblock_factorized(params, "encoder.mid.block_2", h, mid, mid)
    h = F.silu(group_norm_per_frame(params, "encoder.norm_out", h))
    h = causal_conv3d(params, "encoder.conv_out.0", h, (1, 3, 3), padding=1)
    h = causal_conv3d(params, "encoder.conv_out.1", h, (3, 1, 1), padding=0)
    return causal_conv3d(params, "quant_conv", h, (1, 1, 1), padding=0)


def vae_decode(params: Params, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """latent (B, 16, T', H', W') -> (B, 3, T, H, W)."""
    h = causal_conv3d(params, "post_quant_conv", z.to(cfg.dtype), (1, 1, 1), padding=0)
    h = causal_conv3d(params, "decoder.conv_in.0", h, (1, 3, 3), padding=1)
    h = causal_conv3d(params, "decoder.conv_in.1", h, (3, 1, 1), padding=0)
    mid = cfg.channels * cfg.channels_mult[-1]
    h = resblock_factorized(params, "decoder.mid.block_1", h, mid, mid)
    h = attn_temporal(params, "decoder.mid.attn_1.1", attn_spatial(params, "decoder.mid.attn_1.0", h))
    h = resblock_factorized(params, "decoder.mid.block_2", h, mid, mid)
    curr_res = (cfg.resolution // cfg.patch_size) // 2 ** (cfg.num_resolutions - 1)
    block_in = mid
    for i_level in reversed(range(cfg.num_resolutions)):
        block_out = cfg.channels * cfg.channels_mult[i_level]
        for i_block in range(cfg.num_res_blocks + 1):
            h = resblock_factorized(params, f"decoder.up.{i_level}.block.{i_block}", h,
                                    block_in, block_out)
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                base = f"decoder.up.{i_level}.attn.{i_block}"
                h = attn_temporal(params, f"{base}.1", attn_spatial(params, f"{base}.0", h))
        if i_level != 0:
            spatial_up, temporal_up = _up_flags(cfg, i_level)
            h = hybrid_upsample(params, f"decoder.up.{i_level}.upsample", h,
                                spatial=spatial_up, temporal=temporal_up)
            curr_res *= 2
    h = F.silu(group_norm_per_frame(params, "decoder.norm_out", h))
    h = causal_conv3d(params, "decoder.conv_out.0", h, (1, 3, 3), padding=1)
    h = causal_conv3d(params, "decoder.conv_out.1", h, (3, 1, 1), padding=0)
    return haar_unpatch3d(h, cfg.patch_size)


# ------------------------------ parameters ------------------------------


def vae_param_shapes(cfg: VAEConfig) -> Dict[str, Tuple[int, ...]]:
    """Reference state-dict name -> shape, in the JAX package's init order."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cin, cout, kernel):
        shapes[f"{name}.conv3d.weight"] = (cout, cin, *kernel)
        shapes[f"{name}.conv3d.bias"] = (cout,)

    def norm(name, ch):
        shapes[f"{name}.norm.weight"] = (ch,)
        shapes[f"{name}.norm.bias"] = (ch,)

    def resblock(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1.0", cin, cout, (1, 3, 3))
        conv(f"{name}.conv1.1", cout, cout, (3, 1, 1))
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2.0", cout, cout, (1, 3, 3))
        conv(f"{name}.conv2.1", cout, cout, (3, 1, 1))
        if cin != cout:
            conv(f"{name}.nin_shortcut", cin, cout, (1, 1, 1))

    def attn(name, ch):
        norm(f"{name}.norm", ch)
        for p in ("q", "k", "v", "proj_out"):
            conv(f"{name}.{p}", ch, ch, (1, 1, 1))

    p3 = cfg.patch_size ** 3
    conv("encoder.conv_in.0", cfg.in_channels * p3, cfg.channels, (1, 3, 3))
    conv("encoder.conv_in.1", cfg.channels, cfg.channels, (3, 1, 1))
    curr_res = cfg.resolution // cfg.patch_size
    for i_level, (cin, cout) in enumerate(_level_channels(cfg)):
        block_in = cin
        for i_block in range(cfg.num_res_blocks):
            resblock(f"encoder.down.{i_level}.block.{i_block}", block_in, cout)
            block_in = cout
            if curr_res in cfg.attn_resolutions:
                attn(f"encoder.down.{i_level}.attn.{i_block}.0", cout)
                attn(f"encoder.down.{i_level}.attn.{i_block}.1", cout)
        if i_level != cfg.num_resolutions - 1:
            if i_level < cfg.num_spatial_downs:
                conv(f"encoder.down.{i_level}.downsample.conv1", cout, cout, (1, 3, 3))
            if i_level < cfg.num_temporal_downs:
                conv(f"encoder.down.{i_level}.downsample.conv2", cout, cout, (3, 1, 1))
            if i_level < max(cfg.num_spatial_downs, cfg.num_temporal_downs):
                conv(f"encoder.down.{i_level}.downsample.conv3", cout, cout, (1, 1, 1))
            curr_res //= 2
    mid = cfg.channels * cfg.channels_mult[-1]
    resblock("encoder.mid.block_1", mid, mid)
    attn("encoder.mid.attn_1.0", mid)
    attn("encoder.mid.attn_1.1", mid)
    resblock("encoder.mid.block_2", mid, mid)
    norm("encoder.norm_out", mid)
    zf = cfg.z_factor * cfg.z_channels
    conv("encoder.conv_out.0", mid, zf, (1, 3, 3))
    conv("encoder.conv_out.1", zf, zf, (3, 1, 1))
    conv("quant_conv", zf, cfg.z_factor * cfg.latent_channels, (1, 1, 1))

    conv("post_quant_conv", cfg.latent_channels, cfg.z_channels, (1, 1, 1))
    conv("decoder.conv_in.0", cfg.z_channels, mid, (1, 3, 3))
    conv("decoder.conv_in.1", mid, mid, (3, 1, 1))
    resblock("decoder.mid.block_1", mid, mid)
    attn("decoder.mid.attn_1.0", mid)
    attn("decoder.mid.attn_1.1", mid)
    resblock("decoder.mid.block_2", mid, mid)
    curr_res = (cfg.resolution // cfg.patch_size) // 2 ** (cfg.num_resolutions - 1)
    block_in = mid
    for i_level in reversed(range(cfg.num_resolutions)):
        block_out = cfg.channels * cfg.channels_mult[i_level]
        for i_block in range(cfg.num_res_blocks + 1):
            resblock(f"decoder.up.{i_level}.block.{i_block}", block_in, block_out)
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                attn(f"decoder.up.{i_level}.attn.{i_block}.0", block_out)
                attn(f"decoder.up.{i_level}.attn.{i_block}.1", block_out)
        if i_level != 0:
            spatial_up, temporal_up = _up_flags(cfg, i_level)
            if temporal_up:
                conv(f"decoder.up.{i_level}.upsample.conv1", block_in, block_in, (3, 1, 1))
            if spatial_up:
                conv(f"decoder.up.{i_level}.upsample.conv2", block_in, block_in, (1, 3, 3))
            if temporal_up or spatial_up:
                conv(f"decoder.up.{i_level}.upsample.conv3", block_in, block_in, (1, 1, 1))
            curr_res *= 2
    norm("decoder.norm_out", block_in)
    out_ch = cfg.out_channels * p3
    conv("decoder.conv_out.0", block_in, out_ch, (1, 3, 3))
    conv("decoder.conv_out.1", out_ch, out_ch, (3, 1, 1))
    return shapes


class _Node(nn.Module):
    """Plain container: a path component of the reference parameter names."""


class CausalVAE(nn.Module):
    """Parameter tree of the tokenizer under the reference state-dict names;
    ``encode`` / ``decode`` run the functional forward over it."""

    def __init__(self, cfg: VAEConfig = CV8x8x8, device=None):
        super().__init__()
        self.cfg = cfg
        for name, shape in vae_param_shapes(cfg).items():
            parent = self
            *path, leaf = name.split(".")
            for part in path:
                if part not in parent._modules:
                    parent.add_module(part, _Node())
                parent = parent._modules[part]
            parent.register_parameter(
                leaf, nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device),
                                   requires_grad=False))

    def init_random(self, generator: torch.Generator) -> "CausalVAE":
        """Uniform(+-1/sqrt(fan_in)) conv weights, zero biases, unit norms
        (the JAX package's random init, other numbers)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".norm.weight"):
                    p.fill_(1.0)
                elif name.endswith(".bias"):
                    p.zero_()
                else:
                    bound = 1.0 / math.sqrt(p.shape[1] * math.prod(p.shape[2:]))
                    p.uniform_(-bound, bound, generator=generator)
        return self

    def params(self) -> Params:
        return dict(self.named_parameters())

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return vae_encode(self.params(), self.cfg, x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return vae_decode(self.params(), self.cfg, z)


# --------------------------- chunked tokenizer ---------------------------


class VideoTokenizer:
    """Chunked causal tokenizer with per-(channel, latent-frame) latent
    normalisation: videos are cut into pixel_chunk_duration-frame causal
    chunks, encoded/decoded together, and normalised by latent mean/std."""

    def __init__(
        self,
        vae: CausalVAE,
        pixel_chunk_duration: int = 121,
        latent_mean: Optional[torch.Tensor] = None,
        latent_std: Optional[torch.Tensor] = None,
        spatial_resolution: Tuple[int, int] = (704, 1280),
    ):
        self.vae = vae
        self.cfg = vae.cfg
        self.pixel_chunk_duration = pixel_chunk_duration
        self.temporal_compression_factor = self.cfg.temporal_compression
        self.spatial_compression_factor = self.cfg.spatial_compression
        self.spatial_resolution = spatial_resolution
        self.latent_ch = self.cfg.latent_channels
        device = next(vae.parameters()).device
        lc = self.latent_chunk_duration
        shape = (1, self.latent_ch, lc, 1, 1)
        self.latent_mean = (torch.zeros(shape, device=device) if latent_mean is None
                            else latent_mean.to(device=device, dtype=torch.float32))
        self.latent_std = (torch.ones(shape, device=device) if latent_std is None
                           else latent_std.to(device=device, dtype=torch.float32))

    @property
    def latent_chunk_duration(self) -> int:
        if (self.pixel_chunk_duration - 1) % self.temporal_compression_factor:
            raise ValueError("pixel_chunk_duration - 1 must divide the temporal compression")
        return (self.pixel_chunk_duration - 1) // self.temporal_compression_factor + 1

    @torch.no_grad()
    def encode(self, state: torch.Tensor) -> torch.Tensor:
        """(B, 3, N*chunk, H, W) in [-1, 1] -> normalised latent."""
        B, C, T, H, W = state.shape
        pc = self.pixel_chunk_duration
        if T % pc:
            raise ValueError(f"{T} frames is not a multiple of the {pc}-frame chunk")
        n = T // pc
        chunks = state.reshape(B, C, n, pc, H, W).transpose(1, 2).reshape(B * n, C, pc, H, W)
        latent = self.vae.encode(chunks)
        lc = self.latent_chunk_duration
        latent = latent.reshape(B, n, self.latent_ch, lc, *latent.shape[-2:])
        latent = latent.transpose(1, 2).reshape(B, self.latent_ch, n * lc, *latent.shape[-2:])
        mean = self.latent_mean.repeat(1, 1, n, 1, 1).to(latent.dtype)
        std = self.latent_std.repeat(1, 1, n, 1, 1).to(latent.dtype)
        return (latent - mean) / std

    @torch.no_grad()
    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        """normalised latent -> (B, 3, N*chunk, H, W)."""
        B, C, T, H, W = latent.shape
        lc = self.latent_chunk_duration
        if T % lc:
            raise ValueError(f"{T} latent frames is not a multiple of the {lc}-frame chunk")
        n = T // lc
        mean = self.latent_mean.repeat(1, 1, n, 1, 1).to(latent.dtype)
        std = self.latent_std.repeat(1, 1, n, 1, 1).to(latent.dtype)
        latent = latent * std + mean
        chunks = latent.reshape(B, C, n, lc, H, W).transpose(1, 2).reshape(B * n, C, lc, H, W)
        state = self.vae.decode(chunks)
        pc = self.pixel_chunk_duration
        state = state.reshape(B, n, state.shape[1], pc, *state.shape[-2:])
        return state.transpose(1, 2).reshape(B, state.shape[2], n * pc, *state.shape[-2:])
