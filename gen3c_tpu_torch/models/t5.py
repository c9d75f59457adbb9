"""T5 text encoding for prompt conditioning (port of gen3c_tpu/models/t5.py).

GEN3C conditions on the T5-11B ("google-t5/t5-11b") encoder's output for
the prompt, padded to 512 tokens and zeroed past each prompt's length;
with the prompt encoder disabled (the CLI's default) the embeddings are
zeros (``DummyT5TextEncoder``).

``T5Encoder`` is the encoder stack as a module (gen3c_tpu's
``t5_encoder_forward``): pre-RMSNorm blocks, unscaled attention with a
bucketed relative-position bias shared from layer 0 and a -1e9 key mask,
a ReLU FFN, no biases. Its weights are stored in ``cfg.dtype`` (bf16 for
t5-11b: 9.7 GB) and each is upcast to fp32 at its product, so every
product runs in fp32 on fp32 activations, as JAX's promotion of a bf16
weight against fp32 activations does (with TF32 off: torch's default for
matmuls). The attention is a plain matmul and softmax, as in JAX.

Two text encoders wrap it with the Hugging Face tokenizer, both loading
only from a local directory or the local Hugging Face cache:
``T5TextEncoder`` (the native stack on the run's device; ``--t5_backend
jax``, the counterpart of ``JaxT5TextEncoder``) and ``CosmosT5TextEncoder``
(transformers' own ``T5EncoderModel``; ``--t5_backend torch``). Without
``transformers`` or without the files they raise an error naming what is
missing.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

T5_MODEL_NAME = "google-t5/t5-11b"


class DummyT5TextEncoder:
    """Zero embeddings, (n_prompts, 512, 1024)."""

    def __init__(self, max_length: int = 512, embed_dim: int = 1024):
        self.max_length = max_length
        self.embed_dim = embed_dim

    def encode_prompts(self, prompts: Union[str, List[str]], max_length=None):
        if isinstance(prompts, str):
            prompts = [prompts]
        n = max_length or self.max_length
        emb = np.zeros((len(prompts), n, self.embed_dim), np.float32)
        mask = np.zeros((len(prompts), n), np.int64)
        return emb, mask


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Encoder hyper-parameters; defaults are t5-11b's (≈ 4.86 B parameters)."""

    vocab_size: int = 32128
    d_model: int = 1024
    num_layers: int = 24
    num_heads: int = 128
    d_kv: int = 128
    d_ff: int = 65536
    rel_buckets: int = 32
    rel_max_dist: int = 128
    dtype: torch.dtype = torch.bfloat16

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv


T5_11B = T5Config()


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """T5LayerNorm: no mean subtraction, fp32 statistics, fp32 out."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * scale.float()


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 x @ W^T with the (out, in) weight upcast at the product."""
    return F.linear(x, w.float())


def relative_position_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int
                             ) -> torch.Tensor:
    """Bidirectional T5 buckets of ``rel`` = key - query positions: half the
    buckets per sign, exact below num_buckets / 4, logarithmic up to
    max_distance (the float log cast to int truncates toward zero)."""
    nb = num_buckets // 2
    max_exact = nb // 2
    big = rel > 0
    rel = rel.abs()
    large = max_exact + (torch.log(rel.float() / max_exact + 1e-9)
                         / math.log(max_distance / max_exact) * (nb - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=nb - 1)
    return torch.where(rel < max_exact, rel.to(torch.int32), large) + torch.where(big, nb, 0)


class T5Layer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        d, inner = cfg.d_model, cfg.inner_dim

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.dtype), requires_grad=False)

        self.q, self.k, self.v, self.o = p(inner, d), p(inner, d), p(inner, d), p(d, inner)
        self.ln1, self.ln2 = p(d), p(d)
        self.wi, self.wo = p(cfg.d_ff, d), p(d, cfg.d_ff)


class T5Encoder(nn.Module):
    """The T5 encoder stack; ``forward(ids, mask)`` (B, L) ints -> (B, L,
    d_model) fp32, not zeroed past the prompts (the text encoders do that)."""

    def __init__(self, cfg: T5Config = T5_11B):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype),
                                  requires_grad=False)
        self.rel_bias = nn.Parameter(torch.empty(cfg.rel_buckets, cfg.num_heads, dtype=cfg.dtype),
                                     requires_grad=False)
        self.layers = nn.ModuleList(T5Layer(cfg) for _ in range(cfg.num_layers))
        self.final_ln = nn.Parameter(torch.empty(cfg.d_model, dtype=cfg.dtype),
                                     requires_grad=False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "T5Encoder":
        """Seeded weights for runs without the checkpoint: normal(0, 1/sqrt(fan
        in)) matrices (embedding and bias tables 1.0), unit norms."""
        for name, p in self.named_parameters():
            if p.ndim == 1:
                p.fill_(1.0)
            else:
                std = 1.0 if name in ("embed", "rel_bias") else p.shape[1] ** -0.5
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)
        return self

    @torch.no_grad()
    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, L = ids.shape
        h = self.embed[ids.long()]
        pos = torch.arange(L, device=ids.device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], cfg.rel_buckets,
                                           cfg.rel_max_dist)
        bias = self.rel_bias[buckets.long()].permute(2, 0, 1)[None].float()  # (1, H, L, L)
        bias = bias + (1.0 - mask[:, None, None, :].float()) * -1e9
        for lp in self.layers:
            x = _rms(h, lp.ln1)
            q, k, v = (_product(x, w).view(B, L, cfg.num_heads, -1) for w in (lp.q, lp.k, lp.v))
            # no 1/sqrt(d): T5 folds the scale into its initialisation
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) + bias
            probs = torch.softmax(logits, dim=-1)
            attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, -1)
            h = h + _product(attn, lp.o)
            x = _rms(h, lp.ln2)
            h = h + _product(F.relu(_product(x, lp.wi)), lp.wo)
        return _rms(h, self.final_ln)


def t5_config_from_hf(hf_config, dtype: torch.dtype = torch.bfloat16) -> T5Config:
    return T5Config(vocab_size=hf_config.vocab_size, d_model=hf_config.d_model,
                    num_layers=hf_config.num_layers, num_heads=hf_config.num_heads,
                    d_kv=hf_config.d_kv, d_ff=hf_config.d_ff,
                    rel_buckets=hf_config.relative_attention_num_buckets,
                    rel_max_dist=hf_config.relative_attention_max_distance, dtype=dtype)


def convert_hf_t5_encoder(state_dict, dtype: torch.dtype = torch.bfloat16
                          ) -> dict:
    """transformers ``T5EncoderModel`` state dict -> ``T5Encoder`` state dict
    in ``dtype`` (bf16 by default: t5-11b's encoder is ~19 GB in fp32). The
    linears keep torch's (out, in) layout; JAX's tree holds them
    transposed."""
    def get(name):
        return state_dict[name].detach().float().to(dtype)

    out = {"embed": get("shared.weight"),
           "rel_bias": get("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
           "final_ln": get("encoder.final_layer_norm.weight")}
    i = 0
    while f"encoder.block.{i}.layer.0.SelfAttention.q.weight" in state_dict:
        a, f = f"encoder.block.{i}.layer.0", f"encoder.block.{i}.layer.1"
        for name in "qkvo":
            out[f"layers.{i}.{name}"] = get(f"{a}.SelfAttention.{name}.weight")
        out[f"layers.{i}.ln1"] = get(f"{a}.layer_norm.weight")
        out[f"layers.{i}.wi"] = get(f"{f}.DenseReluDense.wi.weight")
        out[f"layers.{i}.wo"] = get(f"{f}.DenseReluDense.wo.weight")
        out[f"layers.{i}.ln2"] = get(f"{f}.layer_norm.weight")
        i += 1
    return out


def _transformers():
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            "the T5 prompt encoder needs the `transformers` package for its tokenizer "
            "(T5TokenizerFast) and weights (T5EncoderModel), and it is not installed; "
            "run without --enable_prompt_encoder or install it") from e
    return transformers


def _local_dir(model_name: str, cache_dir: Optional[str]) -> str:
    """The directory holding ``model_name``'s files: the name itself if it is
    a directory, else its snapshot in the local Hugging Face cache (looked
    up with ``local_files_only``: nothing is downloaded). It must hold a
    config and a tokenizer; missing files raise FileNotFoundError naming
    them."""
    where = model_name
    if not os.path.isdir(model_name):
        from huggingface_hub import snapshot_download

        try:
            where = snapshot_download(model_name, cache_dir=cache_dir, local_files_only=True)
        except Exception as e:  # noqa: BLE001 - the hub's not-in-cache errors vary by version
            raise FileNotFoundError(
                f"{model_name!r} is neither a directory nor in the local Hugging Face cache "
                f"(cache_dir={cache_dir}); put the {T5_MODEL_NAME} tokenizer and weights in "
                f"<checkpoint_dir>/{T5_MODEL_NAME}. Nothing is downloaded.") from e
    files = set(os.listdir(where))
    missing = [f for f in ("config.json",) if f not in files]
    if not files & {"tokenizer.json", "spiece.model"}:
        missing.append("tokenizer.json or spiece.model")
    if missing:
        raise FileNotFoundError(f"{where} lacks the {T5_MODEL_NAME} files {missing}")
    return where


def _tokenize(tokenizer, prompts: List[str], max_length: int):
    assert all(p for p in prompts), "prompts must be non-empty"
    batch = tokenizer(prompts, return_tensors="pt", truncation=True, padding="max_length",
                      max_length=max_length)
    return batch["input_ids"], batch["attention_mask"]


class T5TextEncoder:
    """The Hugging Face tokenizer on the host and ``T5Encoder`` on
    ``device``, the weights converted from the local ``T5EncoderModel``
    (gen3c_tpu's ``JaxT5TextEncoder``)."""

    def __init__(self, model_name: str = T5_MODEL_NAME, cache_dir: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        tf = _transformers()
        where = _local_dir(model_name, cache_dir)
        self.tokenizer = tf.T5TokenizerFast.from_pretrained(where, local_files_only=True)
        model = tf.T5EncoderModel.from_pretrained(where, local_files_only=True,
                                                  torch_dtype=torch.bfloat16)
        cfg = t5_config_from_hf(model.config)
        state = convert_hf_t5_encoder(model.state_dict(), cfg.dtype)
        del model
        with torch.device("meta"):
            encoder = T5Encoder(cfg)
        self.encoder = encoder.to_empty(device=device)
        self.encoder.load_state_dict(state)

    def encode_prompts(self, prompts: Union[str, List[str]], max_length: int = 512):
        prompts = [prompts] if isinstance(prompts, str) else prompts
        ids, mask = _tokenize(self.tokenizer, prompts, max_length)
        dev = self.encoder.embed.device
        out = self.encoder(ids.to(dev), mask.to(dev)) * mask.to(dev)[..., None]
        return out.cpu().numpy().astype(np.float32), mask.numpy().astype(np.int64)


class CosmosT5TextEncoder:
    """transformers' ``T5EncoderModel`` itself on ``device``
    (cosmos_predict1/auxiliary/t5_text_encoder.py)."""

    def __init__(self, model_name: str = T5_MODEL_NAME, cache_dir: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        tf = _transformers()
        where = _local_dir(model_name, cache_dir)
        self.tokenizer = tf.T5TokenizerFast.from_pretrained(where, local_files_only=True)
        self.text_encoder = tf.T5EncoderModel.from_pretrained(
            where, local_files_only=True).to(device).eval()
        self.device = torch.device(device)

    @torch.no_grad()
    def encode_prompts(self, prompts: Union[str, List[str]], max_length: int = 512):
        prompts = [prompts] if isinstance(prompts, str) else prompts
        ids, mask = _tokenize(self.tokenizer, prompts, max_length)
        out = self.text_encoder(input_ids=ids.to(self.device),
                                attention_mask=mask.to(self.device)).last_hidden_state
        for i, n in enumerate(mask.sum(dim=1).tolist()):
            out[i][n:] = 0  # zero past each prompt's length
        return out.float().cpu().numpy(), mask.numpy().astype(np.int64)


def make_t5_encoder(backend: str = "jax", checkpoint_dir: Optional[str] = None,
                    device: Union[str, torch.device] = "cuda"):
    """The T5 encoder of a backend name of gen3c_tpu: "jax" = the native
    stack (``T5TextEncoder``), "torch" = transformers' (``CosmosT5TextEncoder``),
    "dummy" = zeros. The weights come from <checkpoint_dir>/google-t5/t5-11b
    where that directory exists, else from the local Hugging Face cache."""
    if backend == "dummy":
        return DummyT5TextEncoder()
    local = os.path.join(checkpoint_dir, T5_MODEL_NAME) if checkpoint_dir else None
    model_name = local if local and os.path.isdir(local) else T5_MODEL_NAME
    if backend == "torch":
        return CosmosT5TextEncoder(model_name, device=device)
    if backend == "jax":
        return T5TextEncoder(model_name, device=device)
    raise ValueError(f"unknown t5 backend {backend!r}; expected 'jax', 'torch' or 'dummy'")
