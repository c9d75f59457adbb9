"""The Pixtral vision tower and its projector (port of
gen3c_tpu/aux/vision_encoder.py): the VLM prompt upsampler's eye.

Hugging Face ``PixtralVisionModel`` + Llava's multi-modal projector, under
their names, so released Pixtral weights load through a key map:

  patch_conv (a stride-P convolution, run as a patch matmul)
  -> RMSNorm (ln_pre)
  -> N pre-norm layers with 2D RoPE (the head-dim sub-bands alternate
     between the patch's row and column, rotate-half convention) and
     gated-SiLU MLPs
  -> the projector (linear, exact GELU, linear) into the text model's
     embedding space.

The linears are stored in ``cfg.dtype`` (bf16 for Pixtral-12B), the norm
scales in fp32, cast at each use: the JAX package keeps fp32 weights and
casts them at each use, which gives the same bits. The self-attention runs
``kernels.attention`` (counted "K1vit") on (1, L, heads, head_dim): on a
card for bf16 the wgmma body of ``attention_wgmma.cu``, for fp32
``attention_f32.cu``; on the CPU its plain version. One image at a time,
H and W multiples of the patch size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gen3c_tpu_torch import kernels


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Defaults = Pixtral-12B vision tower (HF PixtralVisionConfig)."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    image_size: int = 1024  # max side; sets the RoPE meshgrid extent
    rope_theta: float = 10000.0
    num_channels: int = 3
    text_hidden_size: int = 5120  # Pixtral-12B text dim
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class _Norm(nn.Module):
    """An RMSNorm scale, kept in fp32."""

    def __init__(self, d: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device),
                                   requires_grad=False)


def _lin(din: int, dout: int, dtype, device, bias: bool = False) -> nn.Linear:
    return nn.Linear(din, dout, bias=bias, device=device, dtype=dtype).requires_grad_(False)


class _Attention(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.q_proj, self.k_proj = _lin(d, d, dtype, device), _lin(d, d, dtype, device)
        self.v_proj, self.o_proj = _lin(d, d, dtype, device), _lin(d, d, dtype, device)


class _FeedForward(nn.Module):
    def __init__(self, d: int, hidden: int, dtype, device):
        super().__init__()
        self.gate_proj = _lin(d, hidden, dtype, device)
        self.up_proj = _lin(d, hidden, dtype, device)
        self.down_proj = _lin(hidden, d, dtype, device)


class _Layer(nn.Module):
    def __init__(self, cfg: VisionConfig, device):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.dtype
        self.attention_norm, self.ffn_norm = _Norm(d, device), _Norm(d, device)
        self.attention = _Attention(d, dt, device)
        self.feed_forward = _FeedForward(d, cfg.intermediate_size, dt, device)


class _Projector(nn.Module):
    def __init__(self, cfg: VisionConfig, device):
        super().__init__()
        d, t, dt = cfg.hidden_size, cfg.text_hidden_size, cfg.dtype
        self.linear_1 = _lin(d, t, dt, device, bias=True)
        self.linear_2 = _lin(t, t, dt, device, bias=True)


class VisionEncoder(nn.Module):
    """The Pixtral vision tower (``patch_conv``, ``ln_pre``,
    ``transformer.layers``) and the multi-modal projector
    (``multi_modal_projector``)."""

    def __init__(self, cfg: VisionConfig = VisionConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        P, C, D = cfg.patch_size, cfg.num_channels, cfg.hidden_size
        self.patch_conv = nn.Conv2d(C, D, P, P, bias=False, device=device,
                                    dtype=cfg.dtype).requires_grad_(False)
        self.ln_pre = _Norm(D, device)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList([_Layer(cfg, device)
                                                 for _ in range(cfg.num_layers)])
        self.multi_modal_projector = _Projector(cfg, device)

    @property
    def device(self) -> torch.device:
        return self.ln_pre.weight.device

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "VisionEncoder":
        """The JAX package's init (other numbers): each matrix uniform in
        +-sqrt(6 / (fan_in + fan_out)), unit norms, zero biases; drawn from
        ``generator`` on the weights' device."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight") or name == "ln_pre.weight":
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                w = p.reshape(p.shape[0], -1)
                a = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                p.uniform_(-a, a, generator=generator)
        return self


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    n = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (n * scale.float()).to(x.dtype)


def rope_2d_tables(cfg: VisionConfig, hp: int, wp: int, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF PixtralRotaryEmbedding: per-patch frequencies whose head-dim
    sub-bands alternate between the row index (freqs[::2]) and the column
    index (freqs[1::2]), duplicated for rotate-half; fp32 cos / sin (hp *
    wp, head_dim), formed in float64."""
    d = cfg.head_dim
    freqs = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    fh = np.outer(np.arange(hp, dtype=np.float64), freqs[::2])  # (hp, d//4)
    fw = np.outer(np.arange(wp, dtype=np.float64), freqs[1::2])  # (wp, d//4)
    inv = np.concatenate([np.broadcast_to(fh[:, None, :], (hp, wp, fh.shape[1])),
                          np.broadcast_to(fw[None, :, :], (hp, wp, fw.shape[1]))],
                         axis=-1).reshape(hp * wp, d // 2)
    emb = np.concatenate([inv, inv], axis=-1)
    return (torch.from_numpy(np.cos(emb).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(emb).astype(np.float32)).to(device))


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (L, H, d), cos / sin (L, d) cast to x's dtype, products and sum in
    x's dtype (as the JAX package's eager ops round them)."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None, :].to(x.dtype) + rot * sin[:, None, :].to(x.dtype)


@torch.no_grad()
def vision_tower_features(model: VisionEncoder, image: torch.Tensor) -> torch.Tensor:
    """(C, H, W) image (normalised pixels) -> (L, hidden): the tower's last
    hidden state (HF PixtralVisionModel), patches in row-major (h, w)
    order. H and W must be multiples of the patch size."""
    cfg = model.cfg
    C, H, W = image.shape
    P = cfg.patch_size
    hp, wp = H // P, W // P
    dtype = cfg.dtype
    # the stride-P convolution as a per-patch matmul, channel-major patches
    x = image.to(dtype).reshape(C, hp, P, wp, P).permute(1, 3, 0, 2, 4).reshape(hp * wp, -1)
    tokens = x @ model.patch_conv.weight.reshape(cfg.hidden_size, -1).T
    tokens = _rms(tokens, model.ln_pre.weight, cfg.norm_eps)
    cos, sin = rope_2d_tables(cfg, hp, wp, tokens.device)
    L, D = tokens.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    for layer in model.transformer.layers:
        att, ff = layer.attention, layer.feed_forward
        h = _rms(tokens, layer.attention_norm.weight, cfg.norm_eps)
        q = _apply_rope(F.linear(h, att.q_proj.weight).reshape(L, nh, hd), cos, sin)
        k = _apply_rope(F.linear(h, att.k_proj.weight).reshape(L, nh, hd), cos, sin)
        v = F.linear(h, att.v_proj.weight).reshape(L, nh, hd)
        attn = kernels.attention(q[None], k[None], v[None], kernel_id="K1vit")
        tokens = tokens + F.linear(attn.reshape(L, D), att.o_proj.weight)
        h = _rms(tokens, layer.ffn_norm.weight, cfg.norm_eps)
        tokens = tokens + F.linear(F.silu(F.linear(h, ff.gate_proj.weight))
                                   * F.linear(h, ff.up_proj.weight), ff.down_proj.weight)
    return tokens


@torch.no_grad()
def vision_encode(model: VisionEncoder, image: torch.Tensor) -> torch.Tensor:
    """(C, H, W) image -> (L, text_hidden) image tokens in the text
    embedding space (the tower, then the projector with exact GELU)."""
    pj = model.multi_modal_projector
    out = F.gelu(pj.linear_1(vision_tower_features(model, image)), approximate="none")
    return pj.linear_2(out)


def _strip(state_dict: Mapping, prefixes) -> Dict[str, object]:
    out = {}
    for k, v in state_dict.items():
        for p in prefixes:
            if k.startswith(p):
                out[k[len(p):]] = v
                break
    return out


def convert_hf_pixtral_vision(state_dict: Mapping, cfg: VisionConfig) -> Dict[str, torch.Tensor]:
    """A Hugging Face Pixtral / Llava state dict -> ``VisionEncoder``'s, in
    cfg.dtype (the norm scales fp32). Takes bare PixtralVisionModel keys
    (patch_conv.weight, transformer.layers.*), or a Llava checkpoint's
    (``vision_tower.*`` beside ``multi_modal_projector.*``, each with or
    without transformers' newer ``model.`` prefix); without a projector an
    identity one (the vision width into the text width)."""
    tower = _strip(state_dict, ("model.vision_tower.", "vision_tower.")) or dict(state_dict)
    proj = _strip(state_dict, ("model.multi_modal_projector.", "multi_modal_projector."))
    with torch.device("meta"):
        keys = list(VisionEncoder(cfg).state_dict())
    out = {}
    for k in keys:
        if k.startswith("multi_modal_projector."):
            continue
        v = tower[k]
        t = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        out[k] = t.float().to(torch.float32 if k.endswith("norm.weight") or k == "ln_pre.weight"
                              else cfg.dtype).contiguous()
    D, T = cfg.hidden_size, cfg.text_hidden_size
    if proj:
        for k, v in proj.items():
            t = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            out[f"multi_modal_projector.{k}"] = t.float().to(cfg.dtype).contiguous()
    else:
        out["multi_modal_projector.linear_1.weight"] = torch.eye(D, T, dtype=cfg.dtype).T.contiguous()
        out["multi_modal_projector.linear_1.bias"] = torch.zeros(T, dtype=cfg.dtype)
        out["multi_modal_projector.linear_2.weight"] = torch.eye(T, dtype=cfg.dtype)
        out["multi_modal_projector.linear_2.bias"] = torch.zeros(T, dtype=cfg.dtype)
    return out
