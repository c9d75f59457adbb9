"""The port's int8 / W8A8 quantization against gen3c_tpu.models.quantize on the CPU.

Weights and activations are numpy-seeded and go through both packages.
The JAX functions are jitted, as the JAX package always runs them (XLA
compiles ``absmax / 127.0`` into a multiply by the fp32 reciprocal, which
the port reproduces). The port stores a weight (out, in) with an (out,)
scale, the JAX package (in, out) with a (1, out) scale, so codes are
compared transposed.
Quantization codes, scales and int32 accumulators must agree exactly (the
same fp32 divisions, round-half-even and clipping); the rescaled W8A8
output within 1 ulp in fp32 and exactly in bf16. Whole quantized DiTs are
compared at the fp32 DiT tolerance (1e-4, other summation orders) for
weight-only int8. W8A8 re-quantizes every activation, so a value that the
two packages' fp32 roundings put on either side of a code boundary takes
the neighbouring code (one step is 1/127 of its row's absmax), and
attention spreads that to other tokens: over three seeds of the tiny DiT
(mean |out| 0.78) the max |delta| was 0.5e-3 to 3.5e-3 and the mean
0.7e-6 to 1.0e-4, so those nets are held at max 1e-2 and mean 3e-4.
At the tiny width no linear reaches _MIN_SIZE, so those tests lower it to
1 in both packages (as tests/test_quantize.py does for the AR model).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gen3c_tpu.models.quantize as jq
import gen3c_tpu_torch.models.quantize as tq
from gen3c_tpu.models import dit as jdit
from gen3c_tpu.pipelines.factory import GEN3C_TINY_PRESET as JAX_TINY
from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.bridge import dit_state_from_jax
from gen3c_tpu_torch.models import dit as tdit
from gen3c_tpu_torch.pipelines.factory import GEN3C_TINY_PRESET

torch.set_num_threads(2)

DIT_INT8_TOL = 1e-4
DIT_W8A8_TOL = {"max": 1e-2, "mean": 3e-4}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.fixture
def small_min_size(monkeypatch):
    monkeypatch.setattr(jq, "_MIN_SIZE", 1)
    monkeypatch.setattr(tq, "_MIN_SIZE", 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_in,n_out", [(64, 48), (333, 17), (1000, 130)])
def test_quantize_linear_matches_jax(dtype, n_in, n_out):
    rng = np.random.default_rng(n_in)
    w = (rng.standard_normal((n_in, n_out)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero output channel: scale 1e-12, codes 0
    w[:4, 5] = [127.0, 2.5, 3.5, -0.5]  # scale 1: exact ties round to even
    jw = jnp.asarray(w, getattr(jnp, dtype))
    want = jax.jit(jq.quantize_linear)(jw)
    tw = torch.from_numpy(w).to(getattr(torch, dtype)).T.contiguous()
    codes, scale = tq.quantize_linear(tw)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.T.numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want["scale"])[0])
    assert codes[5, 1] == 2 and codes[5, 2] == 4 and codes[5, 3] == 0
    # dequantization rounds the product in the target dtype, as weight() does
    q = tq.QuantLinear(n_in, n_out, act_quant=False)
    q.weight.copy_(codes)
    q.scale.copy_(scale)
    for dt in ("float32", "bfloat16"):
        np.testing.assert_array_equal(
            _np(q.dequantize(getattr(torch, dt))).T,
            np.asarray(jq.weight(want, getattr(jnp, dt)).astype(jnp.float32)))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
# K = 16,384 is fc2's input width (the 7B's MLP), K = 1,003 not a multiple of 8
@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (37, 1000, 130), (64, 2100, 33),
                                   (3, 16384, 8), (5, 1003, 9)])
def test_w8a8_matmul_matches_jax(out_dtype, m, k, n):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    x[0, 0] = 0.0  # a zero token (the zero T5 embeddings)
    x[1, -1] *= 50.0  # an outlier token
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    entry = jax.jit(jq.quantize_linear, static_argnames="act_quant")(jnp.asarray(w),
                                                                    act_quant=True)
    want = np.asarray(jax.jit(jq.w8a8_matmul, static_argnums=2)(
        jnp.asarray(x), entry, getattr(jnp, out_dtype)).astype(jnp.float32))
    codes = torch.from_numpy(np.asarray(entry["q8"]).T.copy())
    wscale = torch.from_numpy(np.asarray(entry["scale"])[0].copy())
    got = kernels.w8a8_matmul(torch.from_numpy(x), codes, wscale, getattr(torch, out_dtype))
    assert got.shape == (2, m, n) and got.dtype == getattr(torch, out_dtype)

    # the two halves: per-token codes and the exact int32 accumulators
    @jax.jit
    def jax_codes(xf):  # quantize.py:55-59
        xscale = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-12)
        return jnp.clip(jnp.round(xf / xscale), -127, 127).astype(jnp.int8), xscale

    jcodes, xscale = (np.asarray(a) for a in jax_codes(jnp.asarray(x.reshape(-1, k))))
    tcodes, tscale = kernels.quantize_rows_reference(torch.from_numpy(x.reshape(-1, k)))
    np.testing.assert_array_equal(tcodes.numpy(), jcodes)
    np.testing.assert_array_equal(tscale.numpy(), xscale[:, 0])
    acc = kernels.int8_matmul_reference(tcodes, codes)
    np.testing.assert_array_equal(
        acc.numpy(), jcodes.astype(np.int64) @ np.asarray(entry["q8"]).astype(np.int64))

    if out_dtype == "float32":
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    else:
        np.testing.assert_array_equal(_np(got), want)
    assert (got[0, 0] == 0).all()


def _tiny_params(seed=0):
    params = jdit.randomize_degenerate_inits(jdit.init_dit_params(jax.random.PRNGKey(seed),
                                                                  JAX_TINY.dit))
    return params, jax.tree.map(np.asarray, params)


def _jax_quantized(params, act_quant):
    copy = jax.tree.map(jnp.array, params)  # quantize_dit_params_inplace deletes its input
    return jax.tree.map(np.asarray, jq.quantize_dit_params_inplace(copy, act_quant=act_quant))


def _dit_inputs(cfg_in, seed=0, T=3):
    rng = np.random.default_rng(seed)
    B, H, W = 2, 12, 20
    x = rng.standard_normal((B, cfg_in, T, H, W)).astype(np.float32)
    t = rng.uniform(-2, 1, (B,)).astype(np.float32)
    ctx = rng.standard_normal((B, 512, 1024)).astype(np.float32)
    ctx[1] = 0.0  # zero text embeddings: all-zero rows through W8A8 k/v
    return x, t, ctx


@pytest.mark.parametrize("act_quant", [False, True])
def test_quantized_dit_matches_jax(small_min_size, act_quant):
    """A JAX-quantized tree bridged into a QuantLinear net runs the same
    forward as dit_forward on the quantized tree."""
    params, _ = _tiny_params()
    qtree = _jax_quantized(params, act_quant)
    key = "q8" if act_quant else "q"
    assert key in qtree["blocks"][0]["mlp"]["fc1"] and key in qtree["final"]["linear"]
    net = tq.quantize_dit_(tdit.GeneralDIT(GEN3C_TINY_PRESET.dit), act_quant=act_quant)
    net.load_state_dict(dit_state_from_jax(qtree), strict=True)
    x, t, ctx = _dit_inputs(JAX_TINY.dit.in_channels)
    forward = jax.jit(jdit.dit_forward, static_argnames=("cfg", "fps"))
    want = np.asarray(forward(jax.tree.map(jnp.asarray, qtree), JAX_TINY.dit, jnp.asarray(x),
                              jnp.asarray(t), jnp.asarray(ctx), fps=24.0))
    before = dict(kernels.launch_counts)
    got = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), fps=24.0).numpy()
    assert kernels.launch_counts == before  # the CPU path launches no kernel
    assert np.abs(want).max() > 1e-2
    if act_quant:
        err = np.abs(got - want)
        assert err.max() <= DIT_W8A8_TOL["max"] and err.mean() <= DIT_W8A8_TOL["mean"], \
            (err.max(), err.mean())
    else:
        np.testing.assert_allclose(got, want, atol=DIT_INT8_TOL, rtol=0)


def test_port_quantization_equals_bridged_jax_tree(small_min_size):
    """quantize_dit_ of the bridged fp32 net == the bridged JAX-quantized tree."""
    params, tree = _tiny_params(seed=3)
    net = tdit.GeneralDIT(GEN3C_TINY_PRESET.dit)
    net.load_state_dict(dit_state_from_jax(tree), strict=True)
    tq.quantize_dit_(net, act_quant=True)
    want = dit_state_from_jax(_jax_quantized(params, True))
    got = net.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        assert torch.equal(got[name], value), name


def test_quantized_leaves_at_1024_channels():
    """With the real _MIN_SIZE, the port quantizes exactly the leaves the
    JAX package does: at 1024 channels every q/k/v/out (the cross-attention
    k/v included), fc1, fc2 and the timestep MLP; not the AdaLN layers
    (here 1024 x 1024, at the threshold, but not {"w"} leaves), the patch
    embedding or the final linear (too small)."""
    kw = dict(in_channels=81, model_channels=1024, num_blocks=1, num_heads=8,
              adaln_lora_dim=1024)
    jcfg = dataclasses.replace(JAX_TINY.dit, **kw)
    params = jdit.init_dit_params(jax.random.PRNGKey(0), jcfg)
    net = tdit.GeneralDIT(dataclasses.replace(GEN3C_TINY_PRESET.dit, **kw))
    net.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    tq.quantize_dit_(net, act_quant=True)
    want = dit_state_from_jax(_jax_quantized(params, True))
    got = net.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    quantized = sorted(n for n, m in net.named_modules() if isinstance(m, tq.QuantLinear))
    assert len(quantized) == 2 + 8 + 2, quantized
    assert not any("adaLN" in n or "final" in n or "x_embedder" in n for n in quantized)
    assert all(m.act_quant for m in net.modules() if isinstance(m, tq.QuantLinear))
