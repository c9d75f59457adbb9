"""Int8 DiT weights: weight-only int8 and W8A8 (port of gen3c_tpu/models/quantize.py).

Every large linear of the DiT is stored as int8 codes with one fp32 absmax
scale per output channel. A weight-only (``act_quant=False``) linear
dequantizes in the compute dtype and runs a bf16 matmul; a W8A8
(``act_quant=True``) linear quantizes its input per token on the fly and
runs the int8 GEMM (kernels K7q and K7 on a card). The JAX package stores a
weight (in, out) with a (1, out) scale; the port keeps torch's (out, in)
layout with an (out,) scale, so quantizing a weight is the per-row
quantization of its activations.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gen3c_tpu_torch import kernels

# linears with at least this many elements get quantized (quantize.py _MIN_SIZE)
_MIN_SIZE = 1 << 20

# the GeneralDIT linears that are {"w"} leaves of the JAX param tree; the
# AdaLN modulation layers ({"w1", "w2"} leaves) are never quantized
_QUANTIZABLE_SUFFIXES = (
    "x_embedder.proj.1", "t_embedder.1.linear_1", "t_embedder.1.linear_2",
    "to_q.0", "to_k.0", "to_v.0", "to_out.0", "layer1", "layer2", "final_layer.linear",
)


def quantize_linear(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel absmax int8 of an (out, in) weight: (codes (out,
    in) int8, scales (out,) fp32), the numbers of quantize.py
    ``quantize_linear`` transposed. On a card this launches K7q."""
    return kernels.quantize_rows(w)


class QuantLinear(nn.Module):
    """A bias-free linear holding int8 ``weight`` (out, in) and fp32
    ``scale`` (out,). ``act_quant`` selects W8A8 (the "q8" entries of the
    JAX tree) over weight-only int8 (the "q" entries)."""

    def __init__(self, in_features: int, out_features: int, act_quant: bool, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.act_quant = act_quant
        self.register_buffer("weight", torch.zeros((out_features, in_features),
                                                   dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones((out_features,), dtype=torch.float32,
                                                 device=device))

    def dequantize(self, dtype: torch.dtype) -> torch.Tensor:
        """codes.astype(dtype) * scale.astype(dtype): the product is rounded
        in ``dtype`` (quantize.py ``weight``)."""
        return self.weight.to(dtype) * self.scale.to(dtype)[:, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x @ W in x's dtype: the W8A8 GEMM, or the dequantized matmul
        (dit.py ``_linear``)."""
        if self.act_quant:
            return kernels.w8a8_matmul(x, self.weight, self.scale, x.dtype)
        return F.linear(x, self.dequantize(x.dtype))

    def extra_repr(self) -> str:
        return f"{self.in_features}, {self.out_features}, act_quant={self.act_quant}"


def linear_weight(module: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """The (out, in) weight of a plain or quantized linear in ``dtype``,
    dequantized where needed (dit.py ``_w``)."""
    if isinstance(module, QuantLinear):
        return module.dequantize(dtype)
    return module.weight.to(dtype)


@torch.no_grad()
def quantize_dit_(net: nn.Module, act_quant: bool = False, structure_only: bool = False,
                  min_size: Optional[int] = None) -> nn.Module:
    """Replace, in place and one layer at a time, every large linear of a
    GeneralDIT with a QuantLinear, freeing each source weight as it goes
    (quantize.py ``quantize_dit_params_inplace``). The layers are those
    the JAX package quantizes: the {"w"} linears with >= _MIN_SIZE
    elements (x_embedder, the timestep MLP, every q/k/v/out, fc1, fc2; the
    final linear only if it is that large). structure_only: put empty
    QuantLinears in their place (on the weights' device, ``meta`` too),
    for a pre-quantized checkpoint to load into. min_size replaces
    _MIN_SIZE (0: every such linear, as the quality curve's W8A8 rows
    quantize the toy net, gen3c_tpu/diffusion/quality.py:78-103)."""
    min_size = _MIN_SIZE if min_size is None else min_size
    targets = [name for name, mod in net.named_modules()
               if isinstance(mod, nn.Linear) and name.endswith(_QUANTIZABLE_SUFFIXES)
               and mod.weight.numel() >= min_size]
    for name in targets:
        parent_name, _, attr = name.rpartition(".")
        parent = net.get_submodule(parent_name)
        lin = getattr(parent, attr)
        q = QuantLinear(lin.in_features, lin.out_features, act_quant, device=lin.weight.device)
        if not structure_only:
            codes, scale = quantize_linear(lin.weight)
            q.weight.copy_(codes)
            q.scale.copy_(scale)
            del codes, scale
        setattr(parent, attr, q)
        del lin
    return net


class QuantEmbedding(nn.Module):
    """A token table held as int8 ``weight`` (vocab, dim) with one fp32
    ``scale`` a hidden channel (dim,): quantize.py quantizes the (vocab,
    dim) table per column and dequantizes the looked-up rows."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.register_buffer("weight", torch.zeros((num_embeddings, embedding_dim),
                                                   dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones((embedding_dim,), dtype=torch.float32,
                                                 device=device))

    def forward(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """codes[tokens].astype(dtype) * scale.astype(dtype) (ar_transformer.py ``_embed``)."""
        return self.weight[tokens].to(dtype) * self.scale.to(dtype)


def _quantized_ar_module(mod: nn.Module, act_quant: bool, structure_only: bool,
                         min_size: int, device) -> Optional[nn.Module]:
    """The quantized replacement of one AR linear or token table (None: kept).
    Every linear of the AR network is one of quantize.py's _AR_QUANT_KEYS
    (wq, wk, wv, wo, w1, w2, w3, cwq, cwk, cwv, cwo, output); the table
    never takes W8A8."""
    if isinstance(mod, nn.Embedding) and mod.weight.numel() >= min_size:
        q = QuantEmbedding(mod.num_embeddings, mod.embedding_dim, device=device)
        if not structure_only:
            codes, scale = quantize_linear(mod.weight.T)
            q.weight.copy_(codes.T)
            q.scale.copy_(scale)
        return q
    if isinstance(mod, nn.Linear) and mod.weight.numel() >= min_size:
        q = QuantLinear(mod.in_features, mod.out_features, act_quant, device=device)
        if not structure_only:
            codes, scale = quantize_linear(mod.weight)
            q.weight.copy_(codes)
            q.scale.copy_(scale)
        return q
    return None


@torch.no_grad()
def quantize_ar_params(model: nn.Module, act_quant: bool = False, structure_only: bool = False,
                       min_size: Optional[int] = None, device=None) -> nn.Module:
    """Int8 weight-only (or W8A8, act_quant) quantization of an
    ``ARTransformer`` in place, one layer at a time (quantize.py
    ``quantize_ar_params``): every linear and the token table with >=
    _MIN_SIZE elements, per output channel (the table per hidden channel,
    dequantized on lookup); the norm scales stay fp32. device: where the
    quantized layers go (default: where each weight is); quantizing on the
    CPU and placing each layer on the card as it is done is
    ``quantize_ar_params_transfer``. structure_only: empty quantized layers
    for a pre-quantized state dict to load into."""
    min_size = _MIN_SIZE if min_size is None else min_size
    targets = [name for name, mod in model.named_modules()
               if isinstance(mod, (nn.Linear, nn.Embedding))]
    for name in targets:
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        mod = getattr(parent, attr)
        q = _quantized_ar_module(mod, act_quant, structure_only, min_size, mod.weight.device)
        if q is None:
            if device is not None:
                setattr(parent, attr, mod.to(device))
            continue
        setattr(parent, attr, q if device is None else q.to(device))
        del mod
    if device is not None:
        model.to(device)  # the norm scales and what stayed unquantized
    return model


def quantize_ar_params_transfer(model: nn.Module, act_quant: bool = False,
                                device=None) -> nn.Module:
    """Quantize a CPU-resident AR network and move it to ``device`` (default
    the current card) layer by layer: the card never holds the unquantized
    weights, only the int8 codes, scales and one layer at a time
    (quantize.py ``quantize_ar_params_transfer``)."""
    return quantize_ar_params(model, act_quant=act_quant,
                              device=device if device is not None else torch.device("cuda"))


def maybe_quantized_convert(convert_fn, env_var: str = "GEN3C_QUANTIZE_LLM",
                            act_quant: bool = False, device=None):
    """Run a converter thunk (returning an AR network) with opt-in int8
    quantization: with the variable "1" the thunk builds on the CPU and the
    quantized layers move to ``device`` one by one; otherwise it runs as it
    is (quantize.py ``maybe_quantized_convert``). convert_fn(device) takes
    the device to build on."""
    import os

    if os.environ.get(env_var, "0") != "1":
        return convert_fn(device)
    return quantize_ar_params_transfer(convert_fn("cpu"), act_quant=act_quant, device=device)
