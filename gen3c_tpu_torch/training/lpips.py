"""LPIPS perceptual loss on VGG16 features, in PyTorch.

Port of gen3c_tpu/training/lpips.py (the reference:
cosmos_predict1/tokenizer/training/losses/lpips.py and continuous.py's
PerceptualLoss). ``lpips``: ScalingLayer -> torchvision VGG16 feature slices
(relu1_2 / 2_2 / 3_3 / 4_3 / 5_3) -> each map unit-normalised over channels
-> per-slice mean of squared differences -> summed (the classic "lin" 1x1
layers are dropped by the reference's strict=False load, so the loss is
the plain summed feature-space MSE). ``perceptual_loss``: the production
tokenizer term, layer-weighted masked L1 on the raw features plus the
optional gram-matrix term.

The weights are a flat dict under torchvision's names
(``features.N.{weight,bias}``), read from a torchvision-layout ``.pth`` (or
the reference's vgg.pth) or an ``.npz`` of it without torchvision.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# torchvision VGG16 `features` layout: (layer_index, C_in, C_out) of each
# conv; a ReLU follows every conv; MaxPool2d(2) sits at 4/9/16/23/30
VGG16_CONVS: List[Tuple[int, int, int]] = [
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256),
    (17, 256, 512), (19, 512, 512), (21, 512, 512),
    (24, 512, 512), (26, 512, 512), (28, 512, 512),
]
_POOL_AT = {4, 9, 16, 23}  # pools before the tapped slices 2..5
_TAP_AFTER = {2, 7, 14, 21, 28}  # the feature taps: after the ReLU of these convs

# ScalingLayer constants (lpips.py:115-123)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# pyramid layer weights (continuous.py PerceptualLoss)
LAYER_WEIGHTS = (1 / 2.6, 1 / 4.8, 1 / 3.7, 1 / 5.6, 10 / 1.5)


def init_vgg16_params(generator: torch.Generator, dtype=torch.float32, device=None) -> Params:
    """He-normal conv weights, zero biases, drawn from ``generator`` (the
    JAX package's init, other numbers): a stand-in where no weights exist."""
    params = {}
    for idx, cin, cout in VGG16_CONVS:
        w = torch.randn((cout, cin, 3, 3), generator=generator, dtype=torch.float32,
                        device=generator.device) * (2.0 / (cin * 9)) ** 0.5
        params[f"features.{idx}.weight"] = w.to(device=device, dtype=dtype)
        params[f"features.{idx}.bias"] = torch.zeros((cout,), dtype=dtype, device=device)
    return params


def convert_vgg16_state_dict(sd: dict, device=None) -> Params:
    """A torchvision VGG16 state dict (tensors or arrays) -> LPIPS params
    (features.* only; classifier.* and vgg.pth's lin* keys are dropped as
    the reference's strict=False load drops them). fp32."""
    params = {}
    for idx, cin, cout in VGG16_CONVS:
        w = torch.as_tensor(np.asarray(sd[f"features.{idx}.weight"], np.float32))
        b = torch.as_tensor(np.asarray(sd[f"features.{idx}.bias"], np.float32))
        if tuple(w.shape) != (cout, cin, 3, 3):
            raise ValueError(f"features.{idx}.weight: shape {tuple(w.shape)} != "
                             f"{(cout, cin, 3, 3)}")
        params[f"features.{idx}.weight"] = w.to(device)
        params[f"features.{idx}.bias"] = b.to(device)
    return params


def load_lpips_params(path: str, device=None) -> Params:
    """VGG16 weights from a torch .pth (torchvision layout or the reference
    vgg.pth) or an .npz of it. Raises FileNotFoundError where it is absent."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"LPIPS VGG16 checkpoint not found at {path}. Provide a "
            "torchvision vgg16 state dict (.pth) or an npz of it.")
    if path.endswith(".npz"):
        with np.load(path) as data:
            return convert_vgg16_state_dict({k: data[k] for k in data.files}, device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_vgg16_state_dict(
        {k: v.float().numpy() for k, v in sd.items() if k.startswith("features.")}, device)


def vgg16_features(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """(B, 3, H, W) -> the five tapped ReLU feature maps (vgg16.forward)."""
    taps = []
    h = x
    for idx, _, _ in VGG16_CONVS:
        if idx - 1 in _POOL_AT:  # a MaxPool2d(2) sits before this conv
            h = F.max_pool2d(h, 2)
        w = params[f"features.{idx}.weight"].to(h.dtype)
        h = F.relu(F.conv2d(h, w, params[f"features.{idx}.bias"].to(h.dtype), padding=1))
        if idx in _TAP_AFTER:
            taps.append(h)
    return taps


def _normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit-normalise over channels (lpips.py normalize_tensor)."""
    return x / (torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + eps)


def _scaled(x: torch.Tensor) -> torch.Tensor:
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    return (x - shift) / scale


def lpips(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) pairs in [-1, 1] -> per-sample LPIPS (B, 1, 1, 1)."""
    val = None
    for a, b in zip(vgg16_features(params, _scaled(x)), vgg16_features(params, _scaled(y))):
        r = torch.mean((_normalize(a) - _normalize(b)) ** 2, dim=(1, 2, 3), keepdim=True)
        val = r if val is None else val + r
    return val


def _frames(v: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B * T, C, H, W), time into the batch."""
    B, C, T, H, W = v.shape
    return v.transpose(1, 2).reshape(B * T, C, H, W)


def lpips_video(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, 3, T, H, W) videos -> the scalar mean LPIPS over every frame."""
    return torch.mean(lpips(params, _frames(x), _frames(y)))


def nearest_torch(m: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(mode="nearest")``'s rows and columns of m's last two
    axes as the reference takes them: source floor(dst * in / out) in fp32
    (not the half-pixel centres of jax.image.resize)."""
    H, W = m.shape[-2:]
    h2, w2 = hw
    ri = torch.floor(torch.arange(h2, dtype=torch.float32, device=m.device) * (H / h2)).long()
    ci = torch.floor(torch.arange(w2, dtype=torch.float32, device=m.device) * (W / w2)).long()
    return m[..., ri[:, None], ci[None, :]]


def perceptual_loss(
    params: Params,
    x: torch.Tensor,  # (B, 3, H, W) input images
    y: torch.Tensor,  # (B, 3, H, W) reconstructions
    mask: Optional[torch.Tensor] = None,  # (B, 1, H, W) pixel weights
    layer_weights: Tuple[float, ...] = LAYER_WEIGHTS,
    gram: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The production tokenizer perceptual term (continuous.py
    PerceptualLoss.forward): raw VGG features, masked L1 differences with
    the pyramid layer weights, and optionally the gram-matrix term (the
    masked features' gram, squared difference). Returns (per-sample value
    (B, 1, 1, 1), per-sample gram value (B, 1, 1) or None), before the
    WeightScheduler multipliers."""
    B = x.shape[0]
    if mask is None:
        mask = torch.ones((B, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    val = gram_val = None
    for lw, a, b in zip(layer_weights, vgg16_features(params, _scaled(x)),
                        vgg16_features(params, _scaled(y))):
        wm = nearest_torch(mask[:, :1], a.shape[-2:]).to(a.dtype)
        r = lw * torch.mean(wm * torch.abs(a - b), dim=(1, 2, 3), keepdim=True)
        val = r if val is None else val + r
        if gram:
            def _gram(f):
                c, hw = f.shape[1], f.shape[2] * f.shape[3]
                m = (wm * f).reshape(B, c, hw)
                return (m @ m.transpose(1, 2)) / float(hw)

            gr = lw * torch.mean((_gram(a) - _gram(b)) ** 2, dim=(1, 2), keepdim=True)
            gram_val = gr if gram_val is None else gram_val + gr
    return val, gram_val


def perceptual_video(
    params: Params,
    x: torch.Tensor,  # (B, 3, T, H, W)
    y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # (B, 1, T, H, W)
    gram: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Frames into the batch (continuous.py:161-166): the scalar means of the
    per-frame perceptual and gram terms."""
    m = None if mask is None else _frames(mask)
    val, gval = perceptual_loss(params, _frames(x), _frames(y), m, gram=gram)
    return torch.mean(val), (None if gval is None else torch.mean(gval))
