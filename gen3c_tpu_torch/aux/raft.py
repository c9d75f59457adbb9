"""RAFT-Large optical flow in PyTorch (torchvision's raft_large topology).

Port of gen3c_tpu/aux/raft.py, the flow network of the reference
tokenizer's FlowLoss (cosmos_predict1/tokenizer/training/losses/
continuous.py:218-311) with its two monkeypatches: absolute (x, y) pixel
coordinate grids at 1/8 resolution (make_coords_grid) and the 9 x 9
linspace neighbourhood sampled from each correlation level with
align_corners=True bilinear grid sampling and zero padding, x on the first
meshgrid axis, the centroid halved after every level (index_pyramid).

  feature encoder  Conv7x7/2 + InstanceNorm (no affine) -> 3 stages of 2
                   residual blocks (64 -> 64, -> 96 /2, -> 128 /2) -> 1x1
                   conv to 256; every conv with a bias.
  context encoder  the same with BatchNorm (eval mode: running stats) ->
                   128 hidden + 128 context.
  correlation      all-pairs <f1, f2> / sqrt(256), a 4-level avg-pool
                   pyramid, radius-4 lookups (324 channels).
  update block     MotionEncoder -> two ConvGRUs (1x5, 5x1) -> FlowHead.
  convex upsample  MaskPredictor -> softmax over 9 -> the weighted 3x3
                   unfold of 8 * flow.

Everything runs in fp32 with TF32 off on a card (``_fp32``), the backward
too (``_Fp32Backward``), the counterpart of JAX's Precision.HIGHEST: the
flow head's outputs add up into the pixel coordinates the lookups sample
at. The parameters are a
flat dict under torchvision's names, so its Raft_Large_Weights state dict
converts strictly against ``raft_state_spec()``.
"""

from __future__ import annotations

import contextlib
import math
import os
from functools import partial
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

_EPS_IN = 1e-5   # InstanceNorm2d default eps
_EPS_BN = 1e-5   # BatchNorm2d default eps

NUM_LEVELS = 4
RADIUS = 4
CORR_CHANNELS = NUM_LEVELS * (2 * RADIUS + 1) ** 2  # 324
HIDDEN = 128
CONTEXT = 128


# ---------------------------------------------------------------------------
# state-dict spec (torchvision raft_large names -> shapes)
# ---------------------------------------------------------------------------

def _encoder_spec(prefix: str, batch_norm: bool) -> Dict[str, Tuple[int, ...]]:
    """One FeatureEncoder (64, 64, 96, 128, 256): InstanceNorm2d(affine=False)
    has no entries, the context encoder's BatchNorm four a norm
    (num_batches_tracked is dropped on convert)."""
    spec: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cout, cin, kh, kw):
        spec[f"{prefix}.{name}.weight"] = (cout, cin, kh, kw)
        spec[f"{prefix}.{name}.bias"] = (cout,)
        if batch_norm:
            base = f"{prefix}.{name[:-2]}.1"  # Conv2dNormActivation index 1
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                spec[f"{base}.{leaf}"] = (cout,)

    conv("convnormrelu.0", 64, 3, 7, 7)
    for cin, cout, layer, downsample in ((64, 64, "layer1", False), (64, 96, "layer2", True),
                                         (96, 128, "layer3", True)):
        conv(f"{layer}.0.convnormrelu1.0", cout, cin, 3, 3)
        conv(f"{layer}.0.convnormrelu2.0", cout, cout, 3, 3)
        if downsample:
            conv(f"{layer}.0.downsample.0", cout, cin, 1, 1)
        conv(f"{layer}.1.convnormrelu1.0", cout, cout, 3, 3)
        conv(f"{layer}.1.convnormrelu2.0", cout, cout, 3, 3)
    spec[f"{prefix}.conv.weight"] = (256, 128, 1, 1)  # a plain nn.Conv2d, no norm
    spec[f"{prefix}.conv.bias"] = (256,)
    return spec


def raft_state_spec() -> Dict[str, Tuple[int, ...]]:
    """torchvision raft_large's state-dict spec (name -> shape)."""
    spec: Dict[str, Tuple[int, ...]] = {}
    spec.update(_encoder_spec("feature_encoder", batch_norm=False))
    spec.update(_encoder_spec("context_encoder", batch_norm=True))
    me = "update_block.motion_encoder"
    for name, shape in (("convcorr1.0", (256, CORR_CHANNELS, 1, 1)),
                        ("convcorr2.0", (192, 256, 3, 3)), ("convflow1.0", (128, 2, 7, 7)),
                        ("convflow2.0", (64, 128, 3, 3)), ("conv.0", (126, 256, 3, 3))):
        spec[f"{me}.{name}.weight"] = shape
        spec[f"{me}.{name}.bias"] = (shape[0],)
    rb = "update_block.recurrent_block"
    for gru, (kh, kw) in (("convgru1", (1, 5)), ("convgru2", (5, 1))):
        for gate in ("convz", "convr", "convq"):
            spec[f"{rb}.{gru}.{gate}.weight"] = (HIDDEN, HIDDEN + HIDDEN + CONTEXT, kh, kw)
            spec[f"{rb}.{gru}.{gate}.bias"] = (HIDDEN,)
    fh = "update_block.flow_head"
    spec[f"{fh}.conv1.weight"] = (256, HIDDEN, 3, 3)
    spec[f"{fh}.conv1.bias"] = (256,)
    spec[f"{fh}.conv2.weight"] = (2, 256, 3, 3)
    spec[f"{fh}.conv2.bias"] = (2,)
    spec["mask_predictor.convrelu.0.weight"] = (256, HIDDEN, 3, 3)
    spec["mask_predictor.convrelu.0.bias"] = (256,)
    spec["mask_predictor.conv.weight"] = (8 * 8 * 9, 256, 1, 1)
    spec["mask_predictor.conv.bias"] = (8 * 8 * 9,)
    return spec


def init_raft_params(generator: torch.Generator, dtype=torch.float32, device=None) -> Params:
    """He-normal conv weights, zero biases and running means, unit running
    variances and BatchNorm scales, drawn from ``generator`` in the spec's
    sorted order (the JAX package's init, other numbers): a structure-only
    stand-in, whose flow is noise."""
    params: Params = {}
    for name, shape in sorted(raft_state_spec().items()):
        if name.endswith("running_var") or (name.endswith(".1.weight") and len(shape) == 1):
            p = torch.ones(shape, dtype=dtype)
        elif len(shape) == 1:
            p = torch.zeros(shape, dtype=dtype)
        else:
            fan_in = int(np.prod(shape[1:]))
            p = torch.randn(shape, generator=generator, device=generator.device) \
                * (2.0 / fan_in) ** 0.5
        params[name] = p.to(device=device, dtype=dtype)
    return params


def convert_raft_state_dict(sd: dict, device=None) -> Params:
    """A torchvision raft_large state dict -> params, strictly: every spec
    key present with its shape, every input key consumed
    (num_batches_tracked dropped). fp32."""
    spec = raft_state_spec()
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    missing = sorted(set(spec) - set(sd))
    extra = sorted(set(sd) - set(spec))
    if missing or extra:
        raise ValueError(f"RAFT state dict mismatch: missing={missing[:8]} extra={extra[:8]} "
                         f"(of {len(missing)}/{len(extra)})")
    params = {}
    for name, shape in spec.items():
        w = np.asarray(sd[name], np.float32)
        if w.shape != shape:
            raise ValueError(f"{name}: shape {w.shape} != spec {shape}")
        params[name] = torch.from_numpy(w.copy()).to(device)
    return params


def load_raft_params(path: str, device=None) -> Params:
    """RAFT-Large weights from a torch .pth (torchvision's
    Raft_Large_Weights state dict) or an .npz of it. Raises
    FileNotFoundError where it is absent."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"RAFT checkpoint not found: {path}. Provide torchvision's "
            "Raft_Large_Weights.C_T_SKHT_V2 (raft_large_C_T_SKHT_V2-ff5fadd5.pth) "
            "or an npz of its state dict")
    if path.endswith(".npz"):
        with np.load(path) as z:
            return convert_raft_state_dict({k: z[k] for k in z.files}, device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return convert_raft_state_dict({k: v.float().numpy() for k, v in sd.items()}, device)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fp32():
    """Full fp32 products: cuDNN's convolutions and cuBLAS's matmuls with
    TF32 off (JAX's Precision.HIGHEST), restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _conv(p: Params, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    w = p[f"{name}.weight"].float()
    return F.conv2d(x, w, p[f"{name}.bias"].float(), stride=stride,
                    padding=(w.shape[2] // 2, w.shape[3] // 2))


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d(affine=False): per (N, C) over (H, W), the current
    statistics (eval mode too)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + _EPS_IN)


def _batch_norm(p: Params, base: str, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm2d in eval mode: running stats + affine."""
    scale = p[f"{base}.weight"].float() * torch.rsqrt(p[f"{base}.running_var"].float() + _EPS_BN)
    shift = p[f"{base}.bias"].float() - p[f"{base}.running_mean"].float() * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def _encoder_forward(p: Params, prefix: str, x: torch.Tensor, batch_norm: bool) -> torch.Tensor:
    """FeatureEncoder.forward: 1/8-resolution 256-channel features."""
    def cnr(name, x, stride=1, act=True):
        y = _conv(p, f"{prefix}.{name}", x, stride)
        y = _batch_norm(p, f"{prefix}.{name[:-2]}.1", y) if batch_norm else _instance_norm(y)
        return F.relu(y) if act else y

    x = cnr("convnormrelu.0", x, stride=2)
    for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        for blk in (0, 1):
            s = stride if blk == 0 else 1
            y = cnr(f"{layer}.{blk}.convnormrelu1.0", x, stride=s)
            y = cnr(f"{layer}.{blk}.convnormrelu2.0", y)
            if s != 1:
                x = cnr(f"{layer}.{blk}.downsample.0", x, stride=s, act=False)
            x = F.relu(x + y)
    return _conv(p, f"{prefix}.conv", x)


# ---------------------------------------------------------------------------
# correlation pyramid
# ---------------------------------------------------------------------------

def compute_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                         num_levels: int = NUM_LEVELS) -> List[torch.Tensor]:
    """CorrBlock.build_pyramid: all-pairs <f1[y, x], f2[v, u]> / sqrt(C) as
    (N h w, h, w), then 2 x 2 average pooling a level (floor on odd
    sizes); a level under 2 wide keeps the previous volume, as JAX's does."""
    N, C, h, w = fmap1.shape
    corr = torch.einsum("nchw,ncvu->nhwvu", fmap1.float(), fmap2.float()) / math.sqrt(C)
    corr = corr.reshape(N * h * w, h, w)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        m, hl, wl = corr.shape
        if hl >= 2 and wl >= 2:
            corr = corr[:, : hl // 2 * 2, : wl // 2 * 2].reshape(
                m, hl // 2, 2, wl // 2, 2).mean(dim=(2, 4))
        pyramid.append(corr)
    return pyramid


def _grid_sample_zeros(vol: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of vol (M, h, w) at the absolute pixel coordinates
    x, y (M, K), corners outside the volume contributing zero (torchvision's
    align_corners=True grid_sample of the normalised coordinates): (M, K)."""
    M, h, w = vol.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = vol.reshape(M, h * w)
    x0i, y0i = x0.long(), y0.long()

    def corner(yi, xi, wgt):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return torch.gather(flat, 1, idx) * wgt * valid

    return (corner(y0i, x0i, (1 - wy) * (1 - wx)) + corner(y0i, x0i + 1, (1 - wy) * wx)
            + corner(y0i + 1, x0i, wy * (1 - wx)) + corner(y0i + 1, x0i + 1, wy * wx))


def index_pyramid(pyramid: List[torch.Tensor], coords: torch.Tensor,
                  radius: int = RADIUS) -> torch.Tensor:
    """The reference's monkeypatched CorrBlock.index_pyramid: per level a
    (2r+1)^2 linspace neighbourhood around the centroid (x takes the first
    meshgrid axis, y the second), the centroid halved after every level,
    the levels concatenated channel-last. coords (N, 2, h, w) in (x, y)
    order -> (N, 324, h, w)."""
    N, _, h, w = coords.shape
    side = 2 * radius + 1
    d = torch.linspace(-radius, radius, side, dtype=torch.float32, device=coords.device)
    di, dj = torch.meshgrid(d, d, indexing="ij")
    dx, dy = di.reshape(-1), dj.reshape(-1)
    cx = coords[:, 0].reshape(N * h * w, 1)
    cy = coords[:, 1].reshape(N * h * w, 1)
    per_level = []
    for lvl, vol in enumerate(pyramid):
        scale = 0.5 ** lvl
        sampled = _grid_sample_zeros(vol, cx * scale + dx[None, :], cy * scale + dy[None, :])
        per_level.append(sampled.reshape(N, h, w, side * side))
    return torch.cat(per_level, dim=-1).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# update block
# ---------------------------------------------------------------------------

def _motion_encoder(p: Params, flow: torch.Tensor, corr_features: torch.Tensor) -> torch.Tensor:
    """MotionEncoder.forward: conv stacks on corr and flow, a joint conv to
    126 channels, the raw flow appended -> 128."""
    me = "update_block.motion_encoder"
    corr = F.relu(_conv(p, f"{me}.convcorr1.0", corr_features))
    corr = F.relu(_conv(p, f"{me}.convcorr2.0", corr))
    f = F.relu(_conv(p, f"{me}.convflow1.0", flow))
    f = F.relu(_conv(p, f"{me}.convflow2.0", f))
    joint = F.relu(_conv(p, f"{me}.conv.0", torch.cat([corr, f], dim=1)))
    return torch.cat([joint, flow], dim=1)


def conv_gru(p: Params, base: str, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ConvGRU.forward."""
    hx = torch.cat([h, x], dim=1)
    z = torch.sigmoid(_conv(p, f"{base}.convz", hx))
    r = torch.sigmoid(_conv(p, f"{base}.convr", hx))
    q = torch.tanh(_conv(p, f"{base}.convq", torch.cat([r * h, x], dim=1)))
    return (1 - z) * h + z * q


def _update_block(p: Params, hidden: torch.Tensor, context: torch.Tensor,
                  corr_features: torch.Tensor, flow: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """UpdateBlock.forward: the context first, two ConvGRUs (1x5 then 5x1)
    on the same input, the flow head's delta."""
    x = torch.cat([context, _motion_encoder(p, flow, corr_features)], dim=1)
    rb = "update_block.recurrent_block"
    hidden = conv_gru(p, f"{rb}.convgru1", hidden, x)
    hidden = conv_gru(p, f"{rb}.convgru2", hidden, x)
    fh = "update_block.flow_head"
    return hidden, _conv(p, f"{fh}.conv2", F.relu(_conv(p, f"{fh}.conv1", hidden)))


def _unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """F.unfold(kernel_size=3, padding=1)'s layout: (N, C, 9, h, w), the 9
    in (ky, kx) raster order, zero borders."""
    N, C, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    return torch.stack([xp[:, :, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)],
                       dim=2)


def upsample_flow(flow: torch.Tensor, up_mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Convex upsampling: a softmax over the 9 unfold taps of factor * flow
    for each of the factor x factor subpixel positions."""
    N, C, h, w = flow.shape
    mask = torch.softmax(up_mask.reshape(N, 1, 9, factor, factor, h, w), dim=2)
    taps = _unfold3x3(factor * flow).reshape(N, C, 9, 1, 1, h, w)
    up = torch.sum(mask * taps, dim=2)  # (N, C, f, f, h, w)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(N, C, h * factor, w * factor)


def _coords_grid(N: int, h: int, w: int, device) -> torch.Tensor:
    """make_coords_grid: (N, 2, h, w), channel 0 x, channel 1 y."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xx, yy], dim=0).expand(N, 2, h, w)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def raft_forward(params: Params, image1: torch.Tensor, image2: torch.Tensor,
                 num_flow_updates: int = 12) -> torch.Tensor:
    """RAFT.forward's final prediction (the reference takes
    ``flow_model(input1, input2)[-1]``): images (N, 3, H, W), H and W
    multiples of 8 -> (N, 2, H, W) flow in pixels (u = x, v = y). The
    convex upsample runs once, on the last state: the last element of
    torchvision's per-iteration list. Under autograd its backward runs
    with TF32 off too (``_Fp32Backward``)."""
    N, _, H, W = image1.shape
    if H % 8 or W % 8:
        raise ValueError(f"raft_forward takes sizes that are multiples of 8, got {(H, W)}")
    weights = [p for p in params.values() if p.requires_grad]
    if torch.is_grad_enabled() and (image1.requires_grad or image2.requires_grad or weights):
        return _Fp32Backward.apply(params, num_flow_updates, image1, image2, *weights)
    return _raft_forward(params, image1, image2, num_flow_updates)


class _Fp32Backward(torch.autograd.Function):
    """RAFT with its backward under ``_fp32`` as well. Autograd runs a
    backward after the forward's context has closed, where cuDNN's default
    (TF32 on) would differentiate the convolutions in TF32; so the forward
    records a graph of its own and the backward differentiates it inside
    ``_fp32``. ``weights`` are the parameters that take a gradient."""

    @staticmethod
    def forward(ctx, params, num_flow_updates, image1, image2, *weights):
        images = [t.detach().requires_grad_(t.requires_grad) for t in (image1, image2)]
        with torch.enable_grad():
            flow = _raft_forward(params, *images, num_flow_updates)
        ctx.graph = (flow, images + list(weights))
        return flow.detach()

    @staticmethod
    def backward(ctx, grad):
        flow, wrt = ctx.graph
        del ctx.graph
        with _fp32():
            got = iter(torch.autograd.grad(flow, [t for t in wrt if t.requires_grad], grad,
                                           allow_unused=True))
        return (None, None, *(next(got) if t.requires_grad else None for t in wrt))


def _raft_forward(params: Params, image1: torch.Tensor, image2: torch.Tensor,
                  num_flow_updates: int) -> torch.Tensor:
    N, _, H, W = image1.shape
    with _fp32():
        image1, image2 = image1.float(), image2.float()
        fmaps = _encoder_forward(params, "feature_encoder", torch.cat([image1, image2], dim=0),
                                 batch_norm=False)
        pyramid = compute_corr_pyramid(fmaps[:N], fmaps[N:])
        ctx = _encoder_forward(params, "context_encoder", image1, batch_norm=True)
        hidden, context = torch.tanh(ctx[:, :HIDDEN]), F.relu(ctx[:, HIDDEN:])
        coords0 = _coords_grid(N, H // 8, W // 8, image1.device)
        coords1 = coords0
        for _ in range(num_flow_updates):
            hidden, delta = _update_block(params, hidden, context,
                                          index_pyramid(pyramid, coords1), coords1 - coords0)
            coords1 = coords1 + delta
        mp = "mask_predictor"
        up_mask = 0.25 * _conv(params, f"{mp}.conv",
                               F.relu(_conv(params, f"{mp}.convrelu.0", hidden)))
        return upsample_flow(coords1 - coords0, up_mask)


def raft_flow(params: Params, frames1: torch.Tensor, frames2: torch.Tensor,
              num_flow_updates: int = 12) -> torch.Tensor:
    """The flow_fn contract (training/flow.py): (N, C, H, W) pairs -> (N, 2,
    H, W). Gray inputs are repeated to 3 channels; H and W are padded to
    multiples of 8 by edge replication and the flow cropped back."""
    N, C, H, W = frames1.shape
    if C == 1:
        frames1, frames2 = frames1.repeat(1, 3, 1, 1), frames2.repeat(1, 3, 1, 1)
    ph, pw = (-H) % 8, (-W) % 8
    if ph or pw:
        frames1 = F.pad(frames1, (0, pw, 0, ph), mode="replicate")
        frames2 = F.pad(frames2, (0, pw, 0, ph), mode="replicate")
    return raft_forward(params, frames1, frames2, num_flow_updates)[:, :, :H, :W]


def make_raft_flow_fn(params: Params, num_flow_updates: int = 12):
    """Bind params into FlowLoss's ``flow_fn`` slot."""
    return partial(raft_flow, params, num_flow_updates=num_flow_updates)
