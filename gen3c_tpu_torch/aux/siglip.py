"""SigLIP vision encoder and the video safety classifier (port of
gen3c_tpu/aux/siglip.py).

The SigLIP so400m-patch14-384 vision tower computes
``SiglipModel.get_image_features`` (the attention-pooled feature, which the
filter L2-normalises), and a 3-layer MLP (1152 -> 512 -> 256 -> 7,
BatchNorm in eval form + ReLU) scores each frame. Both are fp32
``nn.Module``s under the Hugging Face names (``SiglipVisionTransformer``'s
and the safety checkpoint's ``layers.{0,1,3,4,6}``), so the converters are
key maps. The patch embedding is the JAX package's reshape + matmul; the
self-attention and the pooling head's probe attention run
``kernels.attention`` (counted "K1vit"): on a card ``attention_f32.cu``,
three TF32 products on the tensor cores, (B, 729, 16, 72) with d = 72
zero-padded to 128 inside the kernel; on the CPU its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gen3c_tpu_torch import kernels


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    """google/siglip-so400m-patch14-384 defaults."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def _ln(x: torch.Tensor, norm: nn.LayerNorm, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * norm.weight + norm.bias


def _linear(din: int, dout: int, device) -> nn.Linear:
    return nn.Linear(din, dout, device=device, dtype=torch.float32).requires_grad_(False)


def _norm(d: int, device) -> nn.LayerNorm:
    return nn.LayerNorm(d, device=device, dtype=torch.float32).requires_grad_(False)


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Projected q (B, Lq, D), k / v (B, Lk, D) -> (B, Lq, D) over ``heads``
    heads, K1vit."""
    B, Lq, D = q.shape
    hd = D // heads
    out = kernels.attention(q.reshape(B, Lq, heads, hd), k.reshape(B, -1, heads, hd),
                            v.reshape(B, -1, heads, hd), kernel_id="K1vit")
    return out.reshape(B, Lq, D)


class _Attention(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.q_proj, self.k_proj = _linear(d, d, device), _linear(d, d, device)
        self.v_proj, self.out_proj = _linear(d, d, device), _linear(d, d, device)


class _MLP(nn.Module):
    def __init__(self, d: int, hidden: int, device):
        super().__init__()
        self.fc1, self.fc2 = _linear(d, hidden, device), _linear(hidden, d, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))  # gelu_pytorch_tanh


class _Layer(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, device):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1, self.layer_norm2 = _norm(d, device), _norm(d, device)
        self.self_attn = _Attention(d, device)
        self.mlp = _MLP(d, cfg.intermediate_size, device)


class _Embeddings(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, device):
        super().__init__()
        d, ps = cfg.hidden_size, cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, d, ps, ps, device=device).requires_grad_(False)
        self.position_embedding = nn.Embedding(cfg.num_patches, d,
                                               device=device).requires_grad_(False)


class _InProj(nn.Module):
    """torch.nn.MultiheadAttention's packed q/k/v projection and its output."""

    def __init__(self, d: int, device):
        super().__init__()
        f32 = dict(device=device, dtype=torch.float32)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d, **f32), requires_grad=False)
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d, **f32), requires_grad=False)
        self.out_proj = _linear(d, d, device)


class _PoolingHead(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, device):
        super().__init__()
        d = cfg.hidden_size
        self.probe = nn.Parameter(torch.empty(1, 1, d, device=device), requires_grad=False)
        self.attention = _InProj(d, device)
        self.layernorm = _norm(d, device)
        self.mlp = _MLP(d, cfg.intermediate_size, device)


class SiglipVisionModel(nn.Module):
    """The SigLIP vision tower and its attention-pooling head, fp32;
    ``forward`` is ``siglip_image_features``."""

    def __init__(self, cfg: SiglipVisionConfig = SiglipVisionConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg, device)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([_Layer(cfg, device)
                                             for _ in range(cfg.num_hidden_layers)])
        self.post_layernorm = _norm(cfg.hidden_size, device)
        self.head = _PoolingHead(cfg, device)

    @property
    def device(self) -> torch.device:
        return self.post_layernorm.weight.device

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "SiglipVisionModel":
        """N(0, 0.02) weights and embeddings, zero biases, unit norms, drawn
        from ``generator`` on the weights' device."""
        for name, p in self.named_parameters():
            if "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=generator)
        return self

    @torch.no_grad()
    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, 3, S, S), normalised as ``preprocess_frame`` gives them
        -> pooled image features (B, hidden)."""
        cfg = self.cfg
        B, ps, g = pixels.shape[0], cfg.patch_size, cfg.image_size // cfg.patch_size
        eps, heads = cfg.layer_norm_eps, cfg.num_attention_heads
        # the stride-ps patch convolution as a patch matmul, channel-major
        # patches; a valid convolution's g x g patches take the first g * ps
        # rows and columns (so400m: 27 x 14 = 378 of 384), where the JAX
        # package's reshape of all 384 fails
        x = pixels.float()[:, :, :g * ps, :g * ps]
        x = x.reshape(B, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5)
        pe = self.embeddings.patch_embedding
        x = F.linear(x.reshape(B, g * g, 3 * ps * ps), pe.weight.reshape(pe.weight.shape[0], -1),
                     pe.bias)
        x = x + self.embeddings.position_embedding.weight
        for layer in self.encoder.layers:
            h = _ln(x, layer.layer_norm1, eps)
            a = layer.self_attn
            o = _mha(a.q_proj(h), a.k_proj(h), a.v_proj(h), heads)
            x = x + a.out_proj(o)
            x = x + layer.mlp(_ln(x, layer.layer_norm2, eps))
        x = _ln(x, self.post_layernorm, eps)
        head = self.head
        w, b = head.attention.in_proj_weight, head.attention.in_proj_bias
        wq, wk, wv = w.chunk(3)
        bq, bk, bv = b.chunk(3)
        probe = head.probe.expand(B, 1, -1)
        pooled = head.attention.out_proj(_mha(F.linear(probe, wq, bq), F.linear(x, wk, bk),
                                              F.linear(x, wv, bv), heads))
        pooled = pooled + head.mlp(_ln(pooled, head.layernorm, eps))
        return pooled[:, 0]


def siglip_image_features(model: SiglipVisionModel, pixels: torch.Tensor) -> torch.Tensor:
    """(B, 3, S, S) normalised pixels -> (B, hidden) pooled features
    (= SiglipModel.get_image_features)."""
    return model(pixels)


def _f32(v) -> torch.Tensor:
    t = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
    return t.float().contiguous()


def convert_hf_siglip_vision(state_dict: Mapping, cfg: SiglipVisionConfig
                             ) -> Dict[str, torch.Tensor]:
    """A Hugging Face SigLIP vision state dict ("vision_model."-prefixed, as
    in a full SiglipModel, or bare) -> ``SiglipVisionModel``'s state dict in
    fp32: every key the module has, nothing else (the text tower and
    ``position_ids`` are left out)."""
    with torch.device("meta"):
        keys = list(SiglipVisionModel(cfg).state_dict())
    out = {}
    for k in keys:
        for name in (f"vision_model.{k}", k):
            if name in state_dict:
                out[k] = _f32(state_dict[name])
                break
        else:
            raise KeyError(k)
    return out


# ---------------------- safety classifier head ----------------------


class SafetyClassifier(nn.Module):
    """The 7-class frame-safety MLP (in_dim -> 512 -> 256 -> 7) with
    BatchNorm in eval form, under the checkpoint's ``layers.{0,1,3,4,6}``."""

    def __init__(self, in_dim: int = 1152, device=None):
        super().__init__()
        dev = dict(device=device)
        self.layers = nn.Sequential(
            nn.Linear(in_dim, 512, **dev), nn.BatchNorm1d(512, **dev), nn.ReLU(),
            nn.Linear(512, 256, **dev), nn.BatchNorm1d(256, **dev), nn.ReLU(),
            nn.Linear(256, 7, **dev)).requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "SafetyClassifier":
        """N(0, 0.02) linears, zero biases, BatchNorm at its initial statistics."""
        for m in self.layers:
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=generator)
                m.bias.zero_()
        return self

    @torch.no_grad()
    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, in_dim) -> logits (B, 7)."""
        lin1, bn1, _, lin2, bn2, _, lin3 = self.layers

        def bn(m, x):
            return (x - m.running_mean) * torch.rsqrt(m.running_var + 1e-5) * m.weight + m.bias

        h = torch.relu(bn(bn1, lin1(feats)))
        h = torch.relu(bn(bn2, lin2(h)))
        return lin3(h)


def safety_classifier_apply(head: SafetyClassifier, feats: torch.Tensor) -> torch.Tensor:
    return head(feats)


def convert_safety_classifier(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """The safety_filter.pt state dict (``network.layers.N.*``, or
    ``layers.N.*``) -> ``SafetyClassifier``'s, fp32; BatchNorm's
    ``num_batches_tracked`` kept where given (else 0)."""
    out = {}
    for idx, names in ((0, ("weight", "bias")), (3, ("weight", "bias")), (6, ("weight", "bias")),
                       (1, ("weight", "bias", "running_mean", "running_var")),
                       (4, ("weight", "bias", "running_mean", "running_var"))):
        for n in names:
            for k in (f"network.layers.{idx}.{n}", f"layers.{idx}.{n}", f"{idx}.{n}"):
                if k in state_dict:
                    out[f"layers.{idx}.{n}"] = _f32(state_dict[k])
                    break
            else:
                raise KeyError(f"{idx}.{n}")
        if idx in (1, 4):
            tracked = next((state_dict[k] for k in (f"network.layers.{idx}.num_batches_tracked",
                                                    f"layers.{idx}.num_batches_tracked")
                            if k in state_dict), 0)
            out[f"layers.{idx}.num_batches_tracked"] = torch.as_tensor(tracked, dtype=torch.long)
    return out


def preprocess_frame(frame: np.ndarray, image_size: int = 384) -> np.ndarray:
    """uint8 (H, W, 3) -> normalized (3, S, S) float32 (SiglipProcessor
    semantics: bicubic resize to SxS, rescale 1/255, normalize mean/std
    0.5)."""
    from PIL import Image

    img = Image.fromarray(frame).resize(
        (image_size, image_size), Image.BICUBIC
    )
    x = np.asarray(img, np.float32) / 255.0
    x = (x - 0.5) / 0.5
    return x.transpose(2, 0, 1)
