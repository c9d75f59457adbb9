"""RetinaFace (ResNet-50) face detector and the pixelation blur (port of
gen3c_tpu/aux/retinaface.py).

ResNet-50 -> FPN -> SSH context modules -> class and box heads on fp32
cuDNN convolutions (TF32 off, as the JAX package's fp32), BatchNorm in eval
form; the SSD prior boxes, the box decode, NMS and the filtering in numpy.
The module keeps the public Resnet50_Final.pth names (biubug6's
Pytorch_Retinaface layout), so ``convert_retinaface`` is a key map.

Detection follows the reference CLI: BGR mean-subtracted input,
confidence 0.7, NMS 0.4, top-5000 / keep-750, faces of at least 20 x 20,
5 x 5-block pixelation. ``pixelate_face`` does in numpy what the JAX
package asks of OpenCV (``cv2.resize`` down with INTER_LINEAR, back up with
INTER_NEAREST), in OpenCV's fixed-point arithmetic, so the bits agree and
the port needs no OpenCV.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# cfg_re50 constants (Pytorch_Retinaface data/config.py)
MIN_SIZES = ((16, 32), (64, 128), (256, 512))
STEPS = (8, 16, 32)
VARIANCES = (0.1, 0.2)
OUT_CHANNEL = 256
IN_CHANNELS = (512, 1024, 2048)  # resnet50 C3, C4, C5
NUM_ANCHORS = 2
TOP_K = 5000
KEEP_TOP_K = 750
NMS_THRESHOLD = 0.4
CONFIDENCE_THRESHOLD = 0.7
BGR_MEANS = (104.0, 117.0, 123.0)
FACE_LOGIT_BIAS = 4.0  # the seeded detector's (``RetinaFace.init_random``)


# ------------------------------ the module ------------------------------


class _BN(nn.Module):
    """BatchNorm statistics and affine (eval form only)."""

    def __init__(self, c: int, device):
        super().__init__()
        f32 = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.ones(c, **f32), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c, **f32), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(c, **f32))
        self.register_buffer("running_var", torch.ones(c, **f32))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + eps) * self.weight
        return x * inv[None, :, None, None] + (self.bias - self.running_mean * inv)[None, :, None,
                                                                                  None]


def _conv(cin: int, cout: int, k: int, device, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, bias=bias, device=device).requires_grad_(False)


def _conv_bn(cin: int, cout: int, k: int, device) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, k, device), _BN(cout, device))


def _apply(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1, pad: int = 0) -> torch.Tensor:
    return F.conv2d(x, conv.weight, conv.bias, stride, pad)


def _apply_bn(x, seq: nn.Sequential, stride: int = 1, pad: int = 1, act: bool = True):
    out = seq[1](_apply(x, seq[0], stride, pad))
    return torch.relu(out) if act else out


class _Bottleneck(nn.Module):
    def __init__(self, cin: int, cmid: int, cout: int, downsample: bool, device):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, cmid, 1, device), _BN(cmid, device)
        self.conv2, self.bn2 = _conv(cmid, cmid, 3, device), _BN(cmid, device)
        self.conv3, self.bn3 = _conv(cmid, cout, 1, device), _BN(cout, device)
        if downsample:
            self.downsample = _conv_bn(cin, cout, 1, device)

    def forward(self, x: torch.Tensor, stride: int) -> torch.Tensor:
        out = torch.relu(self.bn1(_apply(x, self.conv1)))
        out = torch.relu(self.bn2(_apply(out, self.conv2, stride, 1)))
        out = self.bn3(_apply(out, self.conv3))
        if hasattr(self, "downsample"):
            x = self.downsample[1](_apply(x, self.downsample[0], stride))
        return torch.relu(out + x)


def _stage(cin: int, cmid: int, cout: int, n: int, device) -> nn.ModuleList:
    return nn.ModuleList([_Bottleneck(cin, cmid, cout, True, device)]
                         + [_Bottleneck(cout, cmid, cout, False, device) for _ in range(n - 1)])


class _Body(nn.Module):
    """torchvision's resnet50 through layer4."""

    def __init__(self, device):
        super().__init__()
        self.conv1, self.bn1 = _conv(3, 64, 7, device), _BN(64, device)
        self.layer1 = _stage(64, 64, 256, 3, device)
        self.layer2 = _stage(256, 128, 512, 4, device)
        self.layer3 = _stage(512, 256, 1024, 6, device)
        self.layer4 = _stage(1024, 512, 2048, 3, device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = torch.relu(self.bn1(_apply(x, self.conv1, 2, 3)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for stage, stride in ((self.layer1, 1), (self.layer2, 2), (self.layer3, 2),
                              (self.layer4, 2)):
            for i, blk in enumerate(stage):
                x = blk(x, stride if i == 0 else 1)
            outs.append(x)
        return outs[1], outs[2], outs[3]


class _SSH(nn.Module):
    def __init__(self, device):
        super().__init__()
        oc = OUT_CHANNEL
        self.conv3X3 = _conv_bn(oc, oc // 2, 3, device)
        self.conv5X5_1 = _conv_bn(oc, oc // 4, 3, device)
        self.conv5X5_2 = _conv_bn(oc // 4, oc // 4, 3, device)
        self.conv7X7_2 = _conv_bn(oc // 4, oc // 4, 3, device)
        self.conv7x7_3 = _conv_bn(oc // 4, oc // 4, 3, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c3 = _apply_bn(x, self.conv3X3, act=False)
        c5_1 = _apply_bn(x, self.conv5X5_1)
        c5 = _apply_bn(c5_1, self.conv5X5_2, act=False)
        c7 = _apply_bn(_apply_bn(c5_1, self.conv7X7_2), self.conv7x7_3, act=False)
        return torch.relu(torch.cat([c3, c5, c7], dim=1))


class _Head(nn.Module):
    def __init__(self, cout: int, device):
        super().__init__()
        self.conv1x1 = _conv(OUT_CHANNEL, cout, 1, device, bias=True)


def _upsample_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    h0, w0 = x.shape[2:]
    ri = torch.arange(h, device=x.device) * h0 // h
    ci = torch.arange(w, device=x.device) * w0 // w
    return x.index_select(2, ri).index_select(3, ci)


class RetinaFace(nn.Module):
    """The ResNet-50 RetinaFace detector, fp32, under Resnet50_Final.pth's
    names; ``forward`` is the JAX package's ``retinaface_forward``."""

    def __init__(self, device=None):
        super().__init__()
        oc = OUT_CHANNEL
        self.body = _Body(device)
        self.fpn = nn.Module()
        for name, cin, k in (("output1", IN_CHANNELS[0], 1), ("output2", IN_CHANNELS[1], 1),
                             ("output3", IN_CHANNELS[2], 1), ("merge1", oc, 3),
                             ("merge2", oc, 3)):
            setattr(self.fpn, name, _conv_bn(cin, oc, k, device))
        self.ssh1, self.ssh2, self.ssh3 = _SSH(device), _SSH(device), _SSH(device)
        self.ClassHead = nn.ModuleList([_Head(NUM_ANCHORS * 2, device) for _ in range(3)])
        self.BboxHead = nn.ModuleList([_Head(NUM_ANCHORS * 4, device) for _ in range(3)])

    @property
    def device(self) -> torch.device:
        return self.body.conv1.weight.device

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "RetinaFace":
        """Seeded weights whose outputs stay in a detector's range (the JAX
        package's N(0, 0.05) init saturates every score at 0 or 1 and every
        box at e^10 priors): conv weights N(0, 1 / fan_in), zero box-head
        biases and a class-head bias of -FACE_LOGIT_BIAS on the face logit
        (so that, as a trained detector, it finds faces rarely: its scores
        reach about 0.99 before the bias, 0.65 after), BatchNorm at identity
        but the stem's, whose variance 1e3 takes the mean-subtracted pixels
        (about +-100) to unit scale; drawn from ``generator`` on the
        weights' device."""
        for name, p in self.named_parameters():
            if name.endswith("conv1x1.bias"):
                p.zero_()
                if name.startswith("ClassHead."):
                    p[1::2] = -FACE_LOGIT_BIAS  # (background, face) per anchor
            elif p.ndim == 4:
                p.normal_(0.0, (1.0 / p[0].numel()) ** 0.5, generator=generator)
        self.body.bn1.running_var.fill_(1e3)
        return self

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, 3, H, W) BGR mean-subtracted fp32 -> (loc (B, P, 4),
        conf (B, P, 2) softmaxed), convolutions without TF32. cuDNN picks its
        algorithms by timing them once a shape (benchmark): its heuristics
        took 312 ms for SSH's 256 -> 128 3x3 convolution on 4 frames of
        88 x 160, 150 times the 256 -> 256 one beside it (on an H100)."""
        with torch.backends.cudnn.flags(enabled=True, benchmark=True, allow_tf32=False):
            c3, c4, c5 = self.body(images.float())
            fpn = self.fpn
            o1 = _apply_bn(c3, fpn.output1, pad=0)
            o2 = _apply_bn(c4, fpn.output2, pad=0)
            o3 = _apply_bn(c5, fpn.output3, pad=0)
            o2 = _apply_bn(o2 + _upsample_nearest(o3, *o2.shape[2:]), fpn.merge2)
            o1 = _apply_bn(o1 + _upsample_nearest(o2, *o1.shape[2:]), fpn.merge1)
            feats = [ssh(f) for ssh, f in zip((self.ssh1, self.ssh2, self.ssh3), (o1, o2, o3))]
            B = images.shape[0]
            locs = [_apply(f, h.conv1x1).permute(0, 2, 3, 1).reshape(B, -1, 4)
                    for f, h in zip(feats, self.BboxHead)]
            confs = [_apply(f, h.conv1x1).permute(0, 2, 3, 1).reshape(B, -1, 2)
                     for f, h in zip(feats, self.ClassHead)]
        return torch.cat(locs, dim=1), torch.softmax(torch.cat(confs, dim=1), dim=-1)


# --------------------------- priors / decode ---------------------------


def prior_boxes(height: int, width: int) -> np.ndarray:
    """SSD prior boxes in center-offset form (PriorBox.forward parity:
    cfg_re50 min_sizes/steps, clip=False). Returns (P, 4) [cx, cy, w, h]
    normalized."""
    anchors = []
    for k, step in enumerate(STEPS):
        fh = math.ceil(height / step)
        fw = math.ceil(width / step)
        for i in range(fh):
            for j in range(fw):
                for min_size in MIN_SIZES[k]:
                    s_kx = min_size / width
                    s_ky = min_size / height
                    cx = (j + 0.5) * step / width
                    cy = (i + 0.5) * step / height
                    anchors.append([cx, cy, s_kx, s_ky])
    return np.asarray(anchors, np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """Decode (B, P, 4) predictions -> corner-form boxes (normalized)
    (retinaface_utils.decode_batch parity)."""
    pr = priors[None]
    cxcy = pr[..., :2] + loc[..., :2] * VARIANCES[0] * pr[..., 2:]
    # clip the log-size offset: keeps garbage predictions finite (boxes
    # beyond e^10 prior sizes are meaningless anyway)
    wh = pr[..., 2:] * np.exp(np.clip(loc[..., 2:] * VARIANCES[1], -10, 10))
    boxes = np.concatenate([cxcy - wh / 2, cxcy + wh / 2], axis=-1)
    return boxes


def nms(dets: np.ndarray, thresh: float) -> List[int]:
    """Pure-numpy NMS (py_cpu_nms parity)."""
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][ovr <= thresh]
    return keep


def filter_detected_boxes(
    boxes: np.ndarray,
    scores: np.ndarray,
    confidence_threshold: float = CONFIDENCE_THRESHOLD,
    nms_threshold: float = NMS_THRESHOLD,
    top_k: int = TOP_K,
    keep_top_k: int = KEEP_TOP_K,
) -> np.ndarray:
    """retinaface_utils.filter_detected_boxes parity."""
    inds = np.where(scores > confidence_threshold)[0]
    boxes, scores = boxes[inds], scores[inds]
    order = scores.argsort()[::-1][:top_k]
    boxes, scores = boxes[order], scores[order]
    dets = np.hstack([boxes, scores[:, None]]).astype(np.float32)
    keep = nms(dets, nms_threshold)
    return dets[keep, :4][:keep_top_k]


# ------------------------------ pixelate ------------------------------

_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_ONE = 1 << _COEF_BITS


def _linear_taps(src: int, dst: int, clamp: bool):
    """OpenCV's INTER_LINEAR taps along one axis: (first source index,
    second, their fixed-point weights) of each destination position. fx =
    (d + 0.5) * scale - 0.5 in float; the x axis (``clamp``) moves a tap
    outside [0, src - 1] onto the edge with its weight whole, the y axis
    keeps the weights and clips the row indices."""
    scale = 1.0 / (dst / src)
    fx = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(np.float32)
    if clamp:
        low = sx < 0
        fx[low], sx[low] = 0.0, 0
        high = sx >= src - 1
        fx[high], sx[high] = 0.0, src - 1
    # saturate_cast<short> rounds to nearest, ties to even, as np.round
    a1 = np.round(fx * np.float32(_COEF_ONE)).astype(np.int64)
    a0 = np.round((np.float32(1.0) - fx) * np.float32(_COEF_ONE)).astype(np.int64)
    return np.clip(sx, 0, src - 1), np.clip(sx + 1, 0, src - 1), a0, a1


def _resize_linear_u8(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) of a uint8 (H, W,
    C) image: a horizontal pass into ints, a vertical one rounded back as
    OpenCV's VResizeLinear<uchar> does; an exact 2 x 2 downscale goes
    through INTER_AREA's rounded 2 x 2 mean, as OpenCV switches it."""
    H, W = img.shape[:2]
    s = img.astype(np.int64)
    if (W, H) == (2 * w, 2 * h):
        return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] + 2) >> 2
                ).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(W, w, clamp=True)
    y0, y1, b0, b1 = _linear_taps(H, h, clamp=False)
    rows = s[:, x0] * a0[None, :, None] + s[:, x1] * a1[None, :, None]  # (H, w, C)
    r0, r1 = rows[y0], rows[y1]
    out = (((b0[:, None, None] * (r0 >> 4)) >> 16) + ((b1[:, None, None] * (r1 >> 4)) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_NEAREST): source index
    floor(d * src / dst), clamped."""
    H, W = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(np.int64), W - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(np.int64), H - 1)
    return img[ys][:, xs]


def pixelate_face(face_img: np.ndarray, blocks: int = 5) -> np.ndarray:
    """blur_utils.pixelate_face parity: shrink a uint8 (h, w, 3) region to
    blocks x blocks (bilinear) and upscale back (nearest)."""
    h, w = face_img.shape[:2]
    return _resize_nearest(_resize_linear_u8(face_img, blocks, blocks), w, h)


@torch.no_grad()
def blur_faces_in_frames(
    net: RetinaFace,
    frames: np.ndarray,  # (T, H, W, 3) uint8 RGB
    batch_size: int = 4,
    confidence_threshold: float = CONFIDENCE_THRESHOLD,
    min_size: Tuple[int, int] = (20, 20),
) -> np.ndarray:
    """The face-blur postprocess: BGR mean-subtract -> detect (on the
    net's device, ``batch_size`` frames at a time) -> decode + NMS ->
    pixelate each box, clamped to the frame first, then size-checked."""
    T, H, W = frames.shape[:3]
    priors = prior_boxes(H, W)
    scale = np.array([W, H, W, H], np.float32)
    out = frames.copy()
    means = torch.tensor(BGR_MEANS, dtype=torch.float32, device=net.device)
    for s in range(0, T, batch_size):
        batch = torch.from_numpy(np.ascontiguousarray(frames[s:s + batch_size])).to(net.device)
        batch = batch.float().flip(-1) - means  # RGB -> BGR, mean-subtract
        loc, conf = net(batch.permute(0, 3, 1, 2).contiguous())
        loc, conf = loc.cpu().numpy(), conf.cpu().numpy()
        boxes = decode_boxes(loc, priors) * scale
        for i in range(len(loc)):
            filtered = filter_detected_boxes(boxes[i], conf[i, :, 1],
                                             confidence_threshold=confidence_threshold)
            frame = out[s + i]
            for box in filtered:
                if not np.isfinite(box).all():
                    continue
                x1, y1, x2, y2 = map(int, np.clip(box, -1e6, 1e6))
                x1, y1 = max(x1, 0), max(y1, 0)
                x2, y2 = min(x2, W), min(y2, H)
                if x2 - x1 < min_size[0] or y2 - y1 < min_size[1]:
                    continue
                frame[y1:y2, x1:x2] = pixelate_face(frame[y1:y2, x1:x2])
    return out


# --------------------------- init / convert ---------------------------


def init_retinaface_params(generator: torch.Generator, device=None) -> RetinaFace:
    """A randomly initialised detector (tests, shape checks, the smoke)."""
    return RetinaFace(device=device).init_random(generator)


def convert_retinaface(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """The public Resnet50_Final.pth state dict ({"state_dict": ...} or
    bare, "module."-prefixed or not) -> ``RetinaFace``'s, fp32: every key
    the module has (the landmark head and BatchNorm's
    num_batches_tracked are left out)."""
    if "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    sd = {k.split("module.", 1)[-1]: v for k, v in state_dict.items()}
    with torch.device("meta"):
        keys = list(RetinaFace().state_dict())
    out = {}
    for k in keys:
        v = sd[k]
        t = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        out[k] = t.float().contiguous()
    return out
