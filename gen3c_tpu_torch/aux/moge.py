"""MoGe monocular geometry (port of gen3c_tpu/aux/moge.py).

The single-image path estimates the seed frame's depth, and that of each
chunk's last frame between AR chunks, with MoGe ViT-L ("Ruicheng/moge-vitl"):
image -> affine-invariant point map + validity mask -> recovered focal and
z-shift -> depth and intrinsics.

  * backbone: DINOv2 ViT-L/14 (patch 14, width 1024, depth 24, 16 heads,
    LayerScale, pre-norm blocks, a cls token, the 37 x 37 learned position
    embedding resized bicubically to the input's patch grid); its
    attention runs ``kernels.attention`` (counted "K1vit"), in fp32: on a
    card ``attention_f32.cu``, three TF32 products on the tensor cores;
  * head: gen3c_tpu's multi-level fusion (a 1x1 projection per tapped
    layer, summed) and two bilinear x2 upsampling 3x3 convs to 4 channels
    (3 point-map channels and a mask logit);
  * recovery: the focal f and z-shift t minimising the projection error of
    (x, y, z + t) against the pixel grid, by a grid search over t refined
    three times, f in closed form per candidate.

Everything runs in fp32 (``cfg.dtype``), the convolutions with cuDNN's TF32
off. Every ``jax.image.resize`` of the JAX module goes through
``ops.resize``, which reproduces it (antialiased downscales, the Keys
cubic, half-pixel nearest). Parameters are a flat dict under the MoGe /
DINOv2 torch names ("backbone.blocks.N.attn.qkv.weight", ...), so a
torch MoGe state dict loads through ``convert_moge_state_dict``, which is
strict about its keys.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.ops.resize import resize

Params = Dict[str, torch.Tensor]

# ImageNet normalisation (DINOv2 preprocessing; MoGe uses the same)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class MoGeConfig:
    patch_size: int = 14
    width: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_ratio: int = 4
    pos_grid: int = 37  # 518 / 14: DINOv2's native position-embedding grid
    # the tapped blocks feeding the head (get_intermediate_layers(n=4): the last 4)
    intermediate_layers: Tuple[int, ...] = (20, 21, 22, 23)
    head_dim: int = 256
    out_channels: int = 4  # point map xyz + mask logit
    dtype: torch.dtype = torch.float32


MOGE_VITL = MoGeConfig()
MOGE_TINY = MoGeConfig(width=64, depth=4, heads=4, pos_grid=8, intermediate_layers=(0, 1, 2, 3),
                       head_dim=32)


# ----------------------------- init / convert -----------------------------


def moge_param_shapes(cfg: MoGeConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, in gen3c_tpu's ``init_moge_params`` order."""
    D, H, ps = cfg.width, cfg.head_dim, cfg.patch_size
    shapes = {
        "backbone.cls_token": (1, 1, D),
        "backbone.pos_embed": (1, cfg.pos_grid * cfg.pos_grid + 1, D),
        "backbone.patch_embed.proj.weight": (D, 3, ps, ps),
        "backbone.patch_embed.proj.bias": (D,),
        "backbone.norm.weight": (D,),
        "backbone.norm.bias": (D,),
    }
    for i in range(cfg.depth):
        b = f"backbone.blocks.{i}"
        shapes.update({
            f"{b}.norm1.weight": (D,), f"{b}.norm1.bias": (D,),
            f"{b}.attn.qkv.weight": (3 * D, D), f"{b}.attn.qkv.bias": (3 * D,),
            f"{b}.attn.proj.weight": (D, D), f"{b}.attn.proj.bias": (D,),
            f"{b}.ls1.gamma": (D,),
            f"{b}.norm2.weight": (D,), f"{b}.norm2.bias": (D,),
            f"{b}.mlp.fc1.weight": (cfg.mlp_ratio * D, D), f"{b}.mlp.fc1.bias": (cfg.mlp_ratio * D,),
            f"{b}.mlp.fc2.weight": (D, cfg.mlp_ratio * D), f"{b}.mlp.fc2.bias": (D,),
            f"{b}.ls2.gamma": (D,),
        })
    for i in range(len(cfg.intermediate_layers)):
        shapes[f"head.proj.{i}.weight"] = (H, D, 1, 1)
        shapes[f"head.proj.{i}.bias"] = (H,)
    for j in range(2):  # two x2 upsampling conv stages
        shapes[f"head.up.{j}.weight"] = (H, H, 3, 3)
        shapes[f"head.up.{j}.bias"] = (H,)
    shapes["head.out.weight"] = (cfg.out_channels, H, 3, 3)
    shapes["head.out.bias"] = (cfg.out_channels,)
    return shapes


def init_moge_params(generator: torch.Generator, cfg: MoGeConfig = MOGE_VITL,
                     device=None) -> Params:
    """Seeded weights (gen3c_tpu's ``init_moge_params``, other numbers):
    normal(0, 0.02) matrices and tokens, zero biases, unit norms, LayerScale
    1e-5."""
    params = {}
    for name, shape in moge_param_shapes(cfg).items():
        if name.endswith("gamma"):
            p = torch.full(shape, 1e-5, dtype=cfg.dtype, device=device)
        elif name.endswith(("norm.weight", "norm1.weight", "norm2.weight")):
            p = torch.ones(shape, dtype=cfg.dtype, device=device)
        elif name.endswith("bias"):
            p = torch.zeros(shape, dtype=cfg.dtype, device=device)
        else:
            p = torch.randn(shape, generator=generator, dtype=cfg.dtype, device=device) * 0.02
        params[name] = p
    return params


def convert_moge_state_dict(sd: dict, cfg: MoGeConfig = MOGE_VITL, strict: bool = True
                            ) -> Params:
    """A torch MoGe state dict (tensors or arrays) -> fp32 params under the
    same names. A missing key raises KeyError, a wrong shape ValueError,
    and with ``strict`` an unused key ValueError."""
    out = {}
    for k, shape in moge_param_shapes(cfg).items():
        if k not in sd:
            raise KeyError(f"MoGe checkpoint missing key {k}")
        v = sd[k]
        t = v.float() if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
        if tuple(t.shape) != shape:
            raise ValueError(f"MoGe checkpoint key {k}: shape {tuple(t.shape)}, expected {shape}")
        out[k] = t
    leftover = sorted(set(sd) - set(out))
    if strict and leftover:
        raise ValueError(f"{len(leftover)} unconsumed MoGe checkpoint keys (naming drift?): "
                         f"{leftover[:8]}{'...' if len(leftover) > 8 else ''}")
    return out


# ------------------------------- backbone -------------------------------


def _ln(p: Params, base: str, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * p[f"{base}.weight"] + p[f"{base}.bias"]


def _attn(p: Params, base: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    B, L, D = x.shape
    qkv = F.linear(x, p[f"{base}.qkv.weight"], p[f"{base}.qkv.bias"])
    q, k, v = (t.reshape(B, L, heads, D // heads) for t in qkv.chunk(3, dim=-1))
    o = kernels.attention(q, k, v, kernel_id="K1vit").reshape(B, L, D)
    return F.linear(o, p[f"{base}.proj.weight"], p[f"{base}.proj.bias"])


def _interp_pos_embed(pos: torch.Tensor, grid: int, h: int, w: int) -> torch.Tensor:
    """(1, 1 + grid^2, D) -> (1, 1 + h * w, D), bicubic over the patch grid."""
    if (h, w) == (grid, grid):
        return pos
    D = pos.shape[-1]
    patch = resize(pos[:, 1:].reshape(1, grid, grid, D), (1, h, w, D), "bicubic")
    return torch.cat([pos[:, :1], patch.reshape(1, h * w, D)], dim=1)


def dinov2_forward(params: Params, cfg: MoGeConfig, image: torch.Tensor) -> List[torch.Tensor]:
    """image (B, 3, H, W), ImageNet-normalised, H and W multiples of the
    patch -> the tapped blocks' patch tokens, each (B, width, H / 14, W /
    14), with the final norm applied (get_intermediate_layers(reshape=True,
    norm=True))."""
    B, _, H, W = image.shape
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    x = F.conv2d(image, params["backbone.patch_embed.proj.weight"].to(image.dtype),
                 stride=cfg.patch_size)
    x = x + params["backbone.patch_embed.proj.bias"].to(image.dtype)[None, :, None, None]
    x = x.reshape(B, cfg.width, gh * gw).transpose(1, 2)
    cls = params["backbone.cls_token"].expand(B, 1, cfg.width).to(x.dtype)
    x = torch.cat([cls, x], dim=1)
    x = x + _interp_pos_embed(params["backbone.pos_embed"].to(x.dtype), cfg.pos_grid, gh, gw)
    taps = {}
    for i in range(cfg.depth):
        b = f"backbone.blocks.{i}"
        x = x + params[f"{b}.ls1.gamma"] * _attn(params, f"{b}.attn",
                                                 _ln(params, f"{b}.norm1", x), cfg.heads)
        h = _ln(params, f"{b}.norm2", x)
        h = F.gelu(F.linear(h, params[f"{b}.mlp.fc1.weight"], params[f"{b}.mlp.fc1.bias"]))
        h = F.linear(h, params[f"{b}.mlp.fc2.weight"], params[f"{b}.mlp.fc2.bias"])
        x = x + params[f"{b}.ls2.gamma"] * h
        if i in cfg.intermediate_layers:
            taps[i] = x
    return [_ln(params, "backbone.norm", taps[i])[:, 1:].transpose(1, 2)
            .reshape(B, cfg.width, gh, gw) for i in cfg.intermediate_layers]


# --------------------------------- head ---------------------------------


def _conv(p: Params, base: str, x: torch.Tensor, padding: int = 1) -> torch.Tensor:
    y = F.conv2d(x, p[f"{base}.weight"].to(x.dtype), padding=padding)
    return y + p[f"{base}.bias"].to(x.dtype)[None, :, None, None]


def moge_head(params: Params, cfg: MoGeConfig, taps: List[torch.Tensor],
              out_hw: Tuple[int, int]) -> torch.Tensor:
    """The tapped features -> (B, 4, *out_hw): xyz point map + mask logit."""
    h = None
    for i, t in enumerate(taps):
        proj = _conv(params, f"head.proj.{i}", t, padding=0)
        h = proj if h is None else h + proj
    B, C = h.shape[:2]
    for j in range(2):
        h = resize(h, (B, C, h.shape[2] * 2, h.shape[3] * 2), "bilinear")
        h = F.relu(_conv(params, f"head.up.{j}", h))
    out = _conv(params, "head.out", h)
    return resize(out, (B, cfg.out_channels) + tuple(out_hw), "bilinear")


# --------------------------- focal / shift recovery ---------------------------


def _linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    """jnp.linspace in fp32: lo * (1 - s) + hi * s at s = i / (num - 1), hi last."""
    s = torch.arange(num - 1, dtype=torch.float32, device=lo.device) / (num - 1)
    return torch.cat([lo * (1 - s) + hi * s, hi.reshape(1)])


def recover_focal_shift(points: torch.Tensor, mask: torch.Tensor, num_candidates: int = 64,
                        refine_iters: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """(focal, shift) minimising || f (x, y) / (z + t) - (u, v) ||^2 over the
    valid pixels of an (H, W, 3) point map, the pixel grid centred and
    normalised by min(H, W) / 2 (the focal in those units): a grid search
    over t, refined around its best cell, with the optimal f in closed form
    per candidate. An all-False mask counts every pixel."""
    H, W = points.shape[:2]
    dev = points.device
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    s = min(H, W) / 2.0
    uv = torch.stack([((xx - (W - 1) / 2.0) / s).reshape(-1),
                      ((yy - (H - 1) / 2.0) / s).reshape(-1)])  # (2, N)
    if not bool(mask.any()):
        mask = torch.ones_like(mask)
    m = mask.float().reshape(-1)
    xy = torch.stack([points[..., 0].reshape(-1), points[..., 1].reshape(-1)])
    z = points[..., 2].reshape(-1)
    z_min = torch.where(mask.reshape(-1), z, torch.full_like(z, float("inf"))).min()
    lo, hi = -z_min + 1e-2, -z_min + 10.0
    t = f = None
    for _ in range(refine_iters):
        ts = _linspace(lo, hi, num_candidates)
        a = xy[None] / torch.clamp(z[None] + ts[:, None], min=1e-4)[:, None]  # (n, 2, N)
        wa = a * m
        fs = (wa * uv).sum((1, 2)) / torch.clamp((wa * a).sum((1, 2)), min=1e-12)
        fs = torch.clamp(fs, min=1e-2)  # the focal is positive
        rs = (m * ((fs[:, None, None] * a - uv) ** 2).sum(1)).sum(1) / torch.clamp(m.sum(),
                                                                                 min=1.0)
        i = torch.argmin(rs)
        step = (hi - lo) / (num_candidates - 1)
        t, f = ts[i], fs[i]
        lo, hi = torch.maximum(t - step, -z_min + 1e-3), t + step
    return f, t


# --------------------------------- infer ---------------------------------


def _fit_resolution(h: int, w: int, patch: int, max_pixels: int) -> Tuple[int, int]:
    scale = min(1.0, (max_pixels / (h * w)) ** 0.5)
    fh = max(patch, int(round(h * scale / patch)) * patch)
    fw = max(patch, int(round(w * scale / patch)) * patch)
    return fh, fw


@torch.no_grad()
def moge_infer(params: Params, cfg: MoGeConfig, image: torch.Tensor,
               max_pixels: int = 518 * 518) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """image (H, W, 3) float in [0, 1] on the params' device -> (depth (H,
    W), pixel intrinsics (3, 3), mask (H, W) bool); depth is NaN where the
    mask is off or the depth not positive. The image is fit to the pixel
    budget in multiples of the patch (704 x 1280 -> 378 x 700), and the
    outputs brought back by nearest neighbour."""
    H, W = image.shape[:2]
    fh, fw = _fit_resolution(H, W, cfg.patch_size, max_pixels)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        x = resize(image.float(), (fh, fw, 3), "bilinear")
        mean = torch.tensor(_MEAN, device=x.device)
        std = torch.tensor(_STD, device=x.device)
        x = ((x - mean) / std).permute(2, 0, 1)[None].to(cfg.dtype)
        out = moge_head(params, cfg, dinov2_forward(params, cfg, x), (fh, fw))[0]
    points = out[:3].permute(1, 2, 0)  # (fh, fw, 3)
    mask = torch.sigmoid(out[3]) > 0.5
    f, t = recover_focal_shift(points, mask)
    depth = points[..., 2] + t
    depth = torch.where(mask & (depth > 0), depth, torch.full_like(depth, float("nan")))
    # the normalised focal -> pixel intrinsics at the input's resolution
    intrinsics = torch.tensor([[0.0, 0.0, W / 2.0], [0.0, 0.0, H / 2.0], [0.0, 0.0, 1.0]],
                              device=f.device)
    intrinsics[0, 0] = intrinsics[1, 1] = f * (min(H, W) / 2.0)
    depth = resize(depth, (H, W), "nearest")
    mask_full = resize(mask.float(), (H, W), "nearest") > 0.5
    return depth, intrinsics, mask_full
