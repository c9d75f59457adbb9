"""Llama-style autoregressive transformer over discrete video tokens.

Port of gen3c_tpu/models/ar_transformer.py (the Cosmos AR world model's
network: cosmos_predict1/autoregressive/networks/transformer.py): GQA
attention (wq/wk/wv/wo, no bias, optional per-head RMSNorm on q and k),
RMSNorm pre-norms, a SwiGLU MLP (w1/w2/w3), 1D or 3D RoPE (YaRN and llama3
scaling), optional cross-attention to a T5 context, and KV-cache decoding
with temperature / top-k / top-p sampling.

The parameters live in ``ARTransformer``, an ``nn.Module`` whose state-dict
keys are the reference Cosmos AR names (``layers.{i}.attention.wq.weight``,
``layers.{i}.feed_forward.w1.weight``, ...), linears in torch's (out, in)
layout. The linears and the token table are stored in ``cfg.dtype`` (bf16
for the 4B: 8 GB), the norm scales in fp32: gen3c_tpu keeps fp32 and casts
at each use (:104, :112), which gives the same bits. The KV cache is a
``KVCache`` of tensors updated in place, its position a Python int; the
decode loop is a Python loop over steps. Attention is kernel K8
(``kernels.gqa_attention``): on a card the hand-written kernel, which reads
the cache in place up to the last visible key; on the CPU its plain version,
``_gqa_attention`` line for line.

Training (gen3c_tpu/training/ar_train.py's forward): ``train_hidden``, the
cache-free forward with gradients and each layer recomputed in the
backward, through the same layer body (``_block``) as ``forward``.

Sampling: ``jax.random.categorical`` is argmax(logits + Gumbel noise). The
noise comes from a ``GumbelSource``, called with the step (0 for the
prefill's token, i for the i-th decode step) and the logits' shape; the
default draws from a ``torch.Generator``. Handing it JAX's draws for the
same key (step 0: ``key``; step i: ``split(fold_in(key, 1), n - 1)[i - 1]``)
reproduces gen3c_tpu's sampled tokens.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.models.dit import quantize_span_delta
from gen3c_tpu_torch.models.quantize import QuantEmbedding, QuantLinear

Rope = Tuple[torch.Tensor, torch.Tensor]
# (step, shape, device) -> fp32 Gumbel noise of that shape
GumbelSource = Callable[[int, Tuple[int, ...], torch.device], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ARConfig:
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    vocab_size: int = 64000
    ffn_hidden_size: int = 14336
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_seq_len: int = 8192
    use_qk_normalization: bool = True
    context_dim: int = 0  # > 0 enables cross-attention (video2world)
    rope_dim: str = "1D"  # "1D" | "3D"
    latent_shape: Tuple[int, int, int] = (0, 0, 0)  # (T, H, W) for 3D rope
    # llama3 rope scaling (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings); None = off
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    # YaRN long-context rope scaling (no magnitude scaling of the tables)
    apply_yarn: bool = False
    yarn_scale: float = 1.0
    yarn_beta_fast: int = 32
    yarn_beta_slow: int = 1
    original_seq_len: Optional[int] = None  # 1D yarn reference length
    original_latent_shape: Tuple[int, int, int] = (0, 0, 0)  # 3D yarn
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


AR_TINY = ARConfig(
    dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
    ffn_hidden_size=256, max_seq_len=256, dtype=torch.float32,
)


@dataclasses.dataclass
class KVCache:
    """k, v: (layers, B, max_seq, kv_heads, head_dim), written in place;
    pos: the filled length. The int8 cache holds codes in k/v and fp32
    absmax / 127 scales (layers, B, max_seq, kv_heads, 1)."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def init_kv_cache(cfg: ARConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
                  quantized: bool = False, device=None) -> KVCache:
    """An empty cache; quantized: int8 codes + fp32 per-(position, head)
    scales, half the bytes of a bf16 cache (plus 1 / head_dim)."""
    shape = (cfg.n_layers, batch, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    if quantized:
        sshape = shape[:-1] + (1,)
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device), 0,
                       torch.zeros(sshape, dtype=torch.float32, device=device),
                       torch.zeros(sshape, dtype=torch.float32, device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# ------------------------------ rope ------------------------------


def _yarn_scale_factors(inv_freq: np.ndarray, original_len: int, cfg: ARConfig) -> np.ndarray:
    """YaRN frequency interpolation: low frequencies divided by the scale,
    high ones kept, a linear ramp between."""
    high = 2 * np.pi * cfg.yarn_beta_fast / original_len
    low = 2 * np.pi * cfg.yarn_beta_slow / original_len
    smooth = np.clip((inv_freq - low) / (high - low), 0.0, 1.0)
    return (1 - smooth) / cfg.yarn_scale + smooth


def _rope_angles(cfg: ARConfig) -> np.ndarray:
    """The (max_seq_len, head_dim) float64 angles of ``rope_tables``: 1D
    (YaRN, llama3 scaling) or 3D over the (T, H, W) latent grid, t-major,
    zero past the grid (ar_transformer.py:172-231)."""
    d = cfg.head_dim
    if cfg.rope_dim == "1D":
        freqs = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2)[: d // 2] / d))
        if cfg.apply_yarn:
            if not cfg.original_seq_len:
                raise ValueError("original_seq_len required for yarn")
            freqs = freqs * _yarn_scale_factors(freqs, cfg.original_seq_len, cfg)
        if cfg.rope_scaling is not None:
            factor, low_f, high_f, orig_len = cfg.rope_scaling
            wavelen = 2 * np.pi / freqs
            low_wl = orig_len / low_f
            high_wl = orig_len / high_f
            scaled = freqs / factor
            smooth = (orig_len / wavelen - low_f) / (high_f - low_f)
            mid = (1 - smooth) * scaled + smooth * freqs
            freqs = np.where(wavelen > low_wl, scaled, np.where(wavelen < high_wl, freqs, mid))
        ang = np.outer(np.arange(cfg.max_seq_len), freqs)
        return np.concatenate([ang, ang], axis=-1)
    T, H, W = cfg.latent_shape
    if T * H * W <= 0:
        raise ValueError("latent_shape required for 3D rope")
    dim_h = d // 6 * 2
    dim_t = d - 2 * dim_h
    fh = 1.0 / cfg.rope_theta ** (np.arange(0, dim_h, 2)[: dim_h // 2] / dim_h)
    ft = 1.0 / cfg.rope_theta ** (np.arange(0, dim_t, 2)[: dim_t // 2] / dim_t)
    if cfg.apply_yarn:
        ot, oh = cfg.original_latent_shape[0], cfg.original_latent_shape[1]
        if not (ot and oh):
            raise ValueError("original_latent_shape required for 3D yarn")
        fh = fh * _yarn_scale_factors(fh, oh, cfg)
        ft = ft * _yarn_scale_factors(ft, ot, cfg)
    tt = np.repeat(np.arange(T), H * W)
    hh = np.tile(np.repeat(np.arange(H), W), T)
    ww = np.tile(np.arange(W), T * H)
    ang = np.concatenate([np.outer(tt, ft), np.outer(hh, fh), np.outer(ww, fh)], axis=-1)
    ang = np.concatenate([ang, ang], axis=-1)
    pad = cfg.max_seq_len - ang.shape[0]
    if pad > 0:
        ang = np.concatenate([ang, np.zeros((pad, d))], axis=0)
    return ang[: cfg.max_seq_len]


def rope_tables(cfg: ARConfig, device=None) -> Rope:
    """fp32 cos / sin (max_seq_len, head_dim), formed in float64 and cast,
    as gen3c_tpu does: the same bits."""
    ang = _rope_angles(cfg)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, L, H, d); cos/sin (L, d) shared by the batch or (B, L, d) per row."""
    d = x.shape[-1]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _gqa_attention(q, k, v, causal_offset=None, kv_valid_start=None, k_scale=None,
                   v_scale=None):
    """K8 (``kernels.gqa_attention``): q (B, Lq, Hq, d) over k/v (B, Lk,
    Hkv, d) with key j visible iff kv_valid_start[b] <= j <= causal_offset +
    i; the int8 cache's scales folded into the logits and probabilities."""
    return kernels.gqa_attention(q, k, v, causal_offset, kv_valid_start, k_scale, v_scale)


# ------------------------------ the module ------------------------------


class _Norm(nn.Module):
    """An RMSNorm scale, kept in fp32."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device),
                                   requires_grad=False)


def _linear(din: int, dout: int, dtype, device) -> nn.Linear:
    return nn.Linear(din, dout, bias=False, device=device, dtype=dtype).requires_grad_(False)


class _Attention(nn.Module):
    def __init__(self, cfg: ARConfig, kv_in: int, qk_norm: bool, device=None):
        super().__init__()
        hd, dt = cfg.head_dim, cfg.dtype
        self.wq = _linear(cfg.dim, cfg.n_heads * hd, dt, device)
        self.wk = _linear(kv_in, cfg.n_kv_heads * hd, dt, device)
        self.wv = _linear(kv_in, cfg.n_kv_heads * hd, dt, device)
        self.wo = _linear(cfg.n_heads * hd, cfg.dim, dt, device)
        if qk_norm:
            self.q_norm = _Norm(hd, device)
            self.k_norm = _Norm(hd, device)


class _FeedForward(nn.Module):
    def __init__(self, cfg: ARConfig, device=None):
        super().__init__()
        self.w1 = _linear(cfg.dim, cfg.ffn_hidden_size, cfg.dtype, device)
        self.w2 = _linear(cfg.ffn_hidden_size, cfg.dim, cfg.dtype, device)
        self.w3 = _linear(cfg.dim, cfg.ffn_hidden_size, cfg.dtype, device)


class ARBlock(nn.Module):
    def __init__(self, cfg: ARConfig, device=None):
        super().__init__()
        self.attention_norm = _Norm(cfg.dim, device)
        self.attention = _Attention(cfg, cfg.dim, cfg.use_qk_normalization, device)
        if cfg.context_dim:
            self.cross_attention_norm = _Norm(cfg.dim, device)
            self.cross_attention = _Attention(cfg, cfg.context_dim, False, device)
        self.ffn_norm = _Norm(cfg.dim, device)
        self.feed_forward = _FeedForward(cfg, device)


def _block(cfg: ARConfig, layer: ARBlock, h: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor, attend, context: Optional[torch.Tensor]) -> torch.Tensor:
    """One layer of ``ar_forward``: pre-norm GQA self-attention through
    attend(q, k, v) (the cache's or the prefill's K8), the cross-attention
    to the context (when the config has one and it is given), the SwiGLU
    MLP."""
    B, L = h.shape[:2]
    hd = cfg.head_dim
    att = layer.attention
    x = _rms(h, layer.attention_norm.weight, cfg.norm_eps)
    q = _mm(x, att.wq).reshape(B, L, cfg.n_heads, hd)
    k = _mm(x, att.wk).reshape(B, L, cfg.n_kv_heads, hd)
    v = _mm(x, att.wv).reshape(B, L, cfg.n_kv_heads, hd)
    if cfg.use_qk_normalization:
        q = _rms(q, att.q_norm.weight, cfg.norm_eps)
        k = _rms(k, att.k_norm.weight, cfg.norm_eps)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    h = h + _mm(attend(q, k, v).reshape(B, L, -1), att.wo)
    if cfg.context_dim and context is not None:
        ca = layer.cross_attention
        x = _rms(h, layer.cross_attention_norm.weight, cfg.norm_eps)
        cq = _mm(x, ca.wq).reshape(B, L, cfg.n_heads, hd)
        ctx = context.to(cfg.dtype)
        ckx = _mm(ctx, ca.wk).reshape(B, -1, cfg.n_kv_heads, hd)
        cvx = _mm(ctx, ca.wv).reshape(B, -1, cfg.n_kv_heads, hd)
        h = h + _mm(_gqa_attention(cq, ckx, cvx).reshape(B, L, -1), ca.wo)
    ff = layer.feed_forward
    x = _rms(h, layer.ffn_norm.weight, cfg.norm_eps)
    return h + _mm(F.silu(_mm(x, ff.w1)) * _mm(x, ff.w3), ff.w2)


def _mm(x: torch.Tensor, lin: nn.Module) -> torch.Tensor:
    """x @ W in x's dtype: a plain linear, or a QuantLinear (weight-only int8
    dequantized into the product; W8A8 through K7q + K7)."""
    if isinstance(lin, QuantLinear):
        return lin(x)
    return F.linear(x, lin.weight.to(x.dtype))


class ARTransformer(nn.Module):
    """The AR network; ``forward`` is gen3c_tpu's ``ar_forward``."""

    def __init__(self, cfg: ARConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim, device=device,
                                           dtype=cfg.dtype).requires_grad_(False)
        self.layers = nn.ModuleList([ARBlock(cfg, device) for _ in range(cfg.n_layers)])
        self.norm = _Norm(cfg.dim, device)
        self.output = _linear(cfg.dim, cfg.vocab_size, cfg.dtype, device)
        self._rope = {}

    @property
    def device(self) -> torch.device:
        return self.norm.weight.device

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "ARTransformer":
        """N(0, 0.02) linears and token table, unit norms (the JAX package's
        init, other numbers), drawn from ``generator`` on the weights' device."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)
        return self

    def rope(self, device=None) -> Rope:
        device = torch.device(device or self.device)
        key = str(device)
        if key not in self._rope:
            self._rope = {key: rope_tables(self.cfg, device)}
        return self._rope[key]

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if isinstance(self.tok_embeddings, QuantEmbedding):
            return self.tok_embeddings(tokens, self.cfg.dtype)
        return self.tok_embeddings.weight.to(self.cfg.dtype)[tokens]

    @torch.no_grad()
    def forward(self, tokens: Optional[torch.Tensor], rope: Optional[Rope] = None,
                cache: Optional[KVCache] = None, context: Optional[torch.Tensor] = None,
                pad_lens: Optional[torch.Tensor] = None,
                input_embeddings: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """(logits (B, L, vocab) fp32, the cache) for tokens (B, L).

        Without a cache: a full causal prefill. With one: positions [pos,
        pos + L) are written in place and pos advances by L. pad_lens (B,):
        row b's real tokens start at pad_lens[b] (left padding): its RoPE
        positions shift so that the first real token has position 0, and
        the padded keys are masked in every attention. input_embeddings (B,
        L, dim): the prefill's stream in embedding space (tokens ignored)."""
        cfg = self.cfg
        dtype = cfg.dtype
        if input_embeddings is not None:
            h = input_embeddings.to(dtype)
        else:
            h = self.embed(tokens)
        B, L = h.shape[:2]
        cos_full, sin_full = rope if rope is not None else self.rope(h.device)
        pos0 = cache.pos if cache is not None else 0
        if pos0 + L > cfg.max_seq_len:
            raise ValueError(f"positions {pos0} + {L} pass max_seq_len {cfg.max_seq_len}")
        if pad_lens is None:
            cos, sin = cos_full[pos0:pos0 + L], sin_full[pos0:pos0 + L]
        else:
            positions = (pos0 + torch.arange(L, device=h.device)[None, :]
                         - pad_lens.to(h.device)[:, None]).clamp_min(0)
            cos, sin = cos_full[positions], sin_full[positions]
        for li, layer in enumerate(self.layers):
            if cache is not None:
                def attend(q, k, v, li=li):
                    ck, cv = cache.k[li], cache.v[li]
                    cks = cvs = None
                    if cache.k_scale is not None:
                        kq, ks = quantize_span_delta(k)
                        vq, vs = quantize_span_delta(v)
                        ck[:, pos0:pos0 + L] = kq
                        cv[:, pos0:pos0 + L] = vq
                        cks, cvs = cache.k_scale[li], cache.v_scale[li]
                        cks[:, pos0:pos0 + L] = ks
                        cvs[:, pos0:pos0 + L] = vs
                    else:
                        ck[:, pos0:pos0 + L] = k.to(ck.dtype)
                        cv[:, pos0:pos0 + L] = v.to(cv.dtype)
                        ck, cv = ck.to(dtype), cv.to(dtype)
                    return _gqa_attention(q, ck, cv, pos0, pad_lens, cks, cvs)
            else:
                def attend(q, k, v):
                    return _gqa_attention(q, k, v, 0, pad_lens)
            h = _block(cfg, layer, h, cos, sin, attend, context)
        h = _rms(h, self.norm.weight, cfg.norm_eps)
        logits = _mm(h, self.output).float()
        if cache is not None:
            cache.pos = pos0 + L
        return logits, cache


def train_hidden(model: "ARTransformer", tokens: torch.Tensor,
                 context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ar_forward`` without a cache, with gradients, up to the final norm:
    (B, L, dim) for tokens (B, L), whose product with ``model.output`` is
    the forward's logits. Each layer is recomputed in the backward (remat:
    the 4B's 16 layers keep only their inputs); the self-attention is K8
    with K8bwd as its backward (``kernels.gqa_attention`` under autograd)."""
    cfg = model.cfg
    h = model.embed(tokens)
    L = h.shape[1]
    if L > cfg.max_seq_len:
        raise ValueError(f"{L} positions pass max_seq_len {cfg.max_seq_len}")
    cos, sin = (t[:L] for t in model.rope(h.device))

    def attend(q, k, v):
        return _gqa_attention(q, k, v, 0, None)

    for layer in model.layers:
        def run(h, layer=layer):
            return _block(cfg, layer, h, cos, sin, attend, context)

        h = checkpoint(run, h, use_reentrant=False)
    return _rms(h, model.norm.weight, cfg.norm_eps)


# ------------------------------ sampling ------------------------------


def filter_logits(logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """The logits ``sample_logits`` draws from (temperature > 0): scaled by
    1 / temperature, then -1e30 below the k-th largest (top_k > 0) and
    below the nucleus cutoff (top_p > 0; utils/sampling.py parity)."""
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30), logits)
    if top_p > 0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp_max(logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, torch.full_like(logits, -1e30), logits)
    return logits


def sample_logits(logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0, gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids (long) from logits (..., vocab): argmax at temperature <= 0,
    else argmax(filtered logits + gumbel) (``jax.random.categorical``);
    gumbel, Gumbel noise of the logits' shape, is required then."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    if gumbel is None:
        raise ValueError("sampling at temperature > 0 needs Gumbel noise")
    return torch.argmax(gumbel.to(logits.device) + filter_logits(logits, temperature, top_k,
                                                                 top_p), dim=-1)


def torch_gumbel(generator: torch.Generator) -> GumbelSource:
    """Gumbel noise -log(-log(u)), u uniform in [tiny, 1), from ``generator``
    (on the device it draws on), as ``jax.random.gumbel`` forms it."""
    tiny = float(np.finfo(np.float32).tiny)

    def draw(step: int, shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=generator.device)
        return -torch.log(-torch.log(u.clamp_min(tiny))).to(device)

    return draw


def _gumbel_source(model: ARTransformer, temperature: float, gumbel: Optional[GumbelSource],
                   seed: int) -> Optional[GumbelSource]:
    if temperature <= 0 or gumbel is not None:
        return gumbel
    return torch_gumbel(torch.Generator(device=model.device).manual_seed(seed))


def _sample(logits, step, temperature, top_k, top_p, noise):
    g = None if noise is None else noise(step, tuple(logits.shape), logits.device)
    return sample_logits(logits, temperature, top_k, top_p, g)


def _decode(model: ARTransformer, prompt: Optional[torch.Tensor], embeddings, max_new_tokens,
            temperature, top_k, top_p, context, pad_lens, quantize_kv, gumbel, seed,
            on_step=None) -> torch.Tensor:
    """Prefill, sample, then max_new_tokens - 1 decode steps on the cache:
    the (B, max_new_tokens) new tokens (``_generate_impl``'s loop).
    on_step(i) is called once the i-th new token is sampled (0: the
    prefill's; timing hooks)."""
    cfg = model.cfg
    B = (prompt if prompt is not None else embeddings).shape[0]
    noise = _gumbel_source(model, temperature, gumbel, seed)
    cache = init_kv_cache(cfg, B, dtype=cfg.dtype, quantized=quantize_kv, device=model.device)
    if pad_lens is not None:
        pad_lens = torch.as_tensor(pad_lens, device=model.device)
    logits, cache = model(prompt, cache=cache, context=context, pad_lens=pad_lens,
                          input_embeddings=embeddings)
    tok = _sample(logits[:, -1], 0, temperature, top_k, top_p, noise)
    out = [tok]
    if on_step is not None:
        on_step(0)
    for i in range(1, max_new_tokens):
        logits, cache = model(tok[:, None], cache=cache, context=context, pad_lens=pad_lens)
        tok = _sample(logits[:, -1], i, temperature, top_k, top_p, noise)
        out.append(tok)
        if on_step is not None:
            on_step(i)
    return torch.stack(out, dim=1)


def _prompt(model: ARTransformer, tokens) -> torch.Tensor:
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.array(tokens))
    return tokens.to(model.device).long()


def generate(model: ARTransformer, prompt_tokens, max_new_tokens: int,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
             context: Optional[torch.Tensor] = None, quantize_kv: bool = False,
             gumbel: Optional[GumbelSource] = None, seed: int = 0,
             on_step=None) -> torch.Tensor:
    """Prefill + KV-cache decode: (B, L0 + max_new_tokens) tokens.
    quantize_kv: an int8 cache. gumbel: the sampling noise (default: a
    torch.Generator seeded with ``seed`` on the model's device)."""
    prompt = _prompt(model, prompt_tokens)
    new = _decode(model, prompt, None, max_new_tokens, temperature, top_k, top_p, context, None,
                  quantize_kv, gumbel, seed, on_step)
    return torch.cat([prompt, new], dim=1)


def generate_padded(model: ARTransformer, prompt_tokens, pad_lens, max_new_tokens: int,
                    temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                    context: Optional[torch.Tensor] = None, quantize_kv: bool = False,
                    gumbel: Optional[GumbelSource] = None, seed: int = 0) -> torch.Tensor:
    """``generate`` over prompts LEFT-padded to one length, pad_lens (B,) the
    pad count of each row: each row's tokens are those of an unpadded
    ``generate`` of it."""
    prompt = _prompt(model, prompt_tokens)
    new = _decode(model, prompt, None, max_new_tokens, temperature, top_k, top_p, context,
                  pad_lens, quantize_kv, gumbel, seed)
    return torch.cat([prompt, new], dim=1)


def _bucket_length(longest: int, bucket: int, cfg: ARConfig, max_new_tokens: int) -> int:
    lpad = max(bucket, ((longest + bucket - 1) // bucket) * bucket)
    lpad = min(lpad, cfg.max_seq_len - max_new_tokens)
    if longest > lpad:
        raise ValueError(f"prompt length {longest} exceeds budget {lpad} "
                         f"(max_seq_len {cfg.max_seq_len} - {max_new_tokens} new)")
    return lpad


def generate_bucketed(model: ARTransformer, prompt_ids: Sequence, max_new_tokens: int,
                      temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                      context: Optional[torch.Tensor] = None, bucket: int = 128,
                      pad_id: int = 0, quantize_kv: bool = False,
                      gumbel: Optional[GumbelSource] = None, seed: int = 0) -> torch.Tensor:
    """Left-pads the prompts (a (B, L0) array or per-row lists) to the next
    multiple of ``bucket`` and runs ``generate_padded``: (B, Lpad +
    max_new_tokens), row b's real output from index pad_lens[b]."""
    rows = [np.asarray(r).reshape(-1) for r in prompt_ids]
    lpad = _bucket_length(max(r.shape[0] for r in rows), bucket, model.cfg, max_new_tokens)
    padded = np.full((len(rows), lpad), pad_id, np.int64)
    pads = np.zeros((len(rows),), np.int64)
    for i, r in enumerate(rows):
        pads[i] = lpad - r.shape[0]
        padded[i, pads[i]:] = r
    return generate_padded(model, padded, pads, max_new_tokens, temperature, top_k, top_p,
                           context, quantize_kv, gumbel, seed)


def generate_with_embeddings(model: ARTransformer, prompt_embeddings: torch.Tensor,
                             max_new_tokens: int, temperature: float = 1.0, top_k: int = 0,
                             top_p: float = 0.0, context: Optional[torch.Tensor] = None,
                             quantize_kv: bool = False, gumbel: Optional[GumbelSource] = None,
                             seed: int = 0) -> torch.Tensor:
    """``generate`` with an embedding-space prefill (B, L0, dim): only the
    (B, max_new_tokens) new tokens."""
    emb = prompt_embeddings.to(model.device)
    return _decode(model, None, emb, max_new_tokens, temperature, top_k, top_p, context, None,
                   quantize_kv, gumbel, seed)


def generate_with_embeddings_bucketed(model: ARTransformer, prompt_embeddings: torch.Tensor,
                                      max_new_tokens: int, temperature: float = 1.0,
                                      top_k: int = 0, top_p: float = 0.0,
                                      context: Optional[torch.Tensor] = None, bucket: int = 128,
                                      quantize_kv: bool = False,
                                      gumbel: Optional[GumbelSource] = None,
                                      seed: int = 0) -> torch.Tensor:
    """``generate_with_embeddings`` with the embeddings left zero-padded to
    the next multiple of ``bucket``: the same new tokens."""
    B, L0, _ = prompt_embeddings.shape
    lpad = _bucket_length(L0, bucket, model.cfg, max_new_tokens)
    pad = lpad - L0
    emb = F.pad(prompt_embeddings.to(model.device), (0, 0, pad, 0))
    pad_lens = torch.full((B,), pad, dtype=torch.long, device=model.device)
    return _decode(model, None, emb, max_new_tokens, temperature, top_k, top_p, context, pad_lens,
                   quantize_kv, gumbel, seed)
