"""Temporal-band attention (K3's plain version) against gen3c_tpu on the CPU.

attention_reference(band=...) against gen3c_tpu.models.dit.attention_op
(temporal_band=...), whose CPU path applies the dense frame mask with
-1e30 before an fp32 softmax, for several (hw, window, prefix) with frames
of hw tokens that straddle 64-token tiles; and the band DiT
(attn_temporal_window) against dit_forward over 5 latent frames.
Tolerances as the full-attention tests: 1e-5 (fp32) and 2e-2 (bf16) for
the op, 1e-4 for the fp32 DiT. A window of at least T - 1 frames masks
nothing and must give full attention exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.models import dit as jdit
from gen3c_tpu.pipelines.factory import GEN3C_TINY_PRESET as JAX_TINY
from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.bridge import dit_state_from_jax
from gen3c_tpu_torch.kernels.reference import attention_reference
from gen3c_tpu_torch.models import dit as tdit
from gen3c_tpu_torch.pipelines.factory import GEN3C_TINY_PRESET

torch.set_num_threads(2)


@pytest.mark.parametrize("band", [(7, 0, 0), (7, 2, 1), (60, 1, 1), (60, 3, 2), (100, 1, 0),
                                  (45, 2, 1)])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_band_attention_reference_matches_jax(band, dtype, atol):
    rng = np.random.default_rng(band[0])
    b, L, h, d = 2, 333, 3, 24
    q, k, v = (rng.standard_normal((b, L, h, d)).astype(np.float32) for _ in range(3))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jdit.attention_op(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                        jnp.asarray(v, jdt), temporal_band=band)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = attention_reference(tq, tk, tv, band)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    full = attention_reference(tq, tk, tv)
    assert (got.float() - full.float()).abs().max() > 10 * atol  # the band matters
    before = dict(kernels.launch_counts)
    assert torch.equal(kernels.attention(tq, tk, tv, band=band), got)
    assert kernels.launch_counts == before  # the CPU path launches no kernel


def test_band_wider_than_the_video_is_full_attention():
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 300, 2, 16)).astype(np.float32))
               for _ in range(3))
    for band in [(60, 4, 0), (60, 7, 1), (100, 2, 3)]:  # 5 or 3 frames
        assert torch.equal(attention_reference(q, k, v, band), attention_reference(q, k, v))


def _band_pair(window, prefix):
    jcfg = dataclasses.replace(JAX_TINY.dit, attn_temporal_window=window,
                               attn_prefix_frames=prefix)
    params = jdit.randomize_degenerate_inits(jdit.init_dit_params(jax.random.PRNGKey(1), jcfg))
    net = tdit.GeneralDIT(dataclasses.replace(GEN3C_TINY_PRESET.dit, attn_temporal_window=window,
                                              attn_prefix_frames=prefix))
    net.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return params, jcfg, net


def _inputs(jcfg, T=5):
    rng = np.random.default_rng(2)
    B, H, W = 2, 12, 20  # 6 x 10 = 60 tokens per latent frame
    x = rng.standard_normal((B, jcfg.in_channels, T, H, W)).astype(np.float32)
    t = rng.uniform(-2, 1, (B,)).astype(np.float32)
    ctx = rng.standard_normal((B, 512, 1024)).astype(np.float32)
    return x, t, ctx


@pytest.mark.parametrize("window,prefix", [(0, 1), (1, 1), (2, 0)])
def test_band_dit_matches_jax(window, prefix):
    params, jcfg, net = _band_pair(window, prefix)
    x, t, ctx = _inputs(jcfg)
    want = np.asarray(jax.jit(jdit.dit_forward, static_argnames=("cfg", "fps"))(
        params, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), fps=24.0))
    got = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), fps=24.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    full = GEN3C_TINY_PRESET.dit
    net.cfg = full
    unbanded = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                   fps=24.0).numpy()
    assert np.abs(unbanded - got).max() > 1e-3  # the band changed the net


def test_band_dit_full_window_is_full_attention():
    _, jcfg, net = _band_pair(4, 1)  # T = 5: every frame pair is in the band
    x, t, ctx = (torch.from_numpy(a) for a in _inputs(jcfg))
    banded = net(x, t, ctx, fps=24.0)
    net.cfg = GEN3C_TINY_PRESET.dit
    assert torch.equal(banded, net(x, t, ctx, fps=24.0))
