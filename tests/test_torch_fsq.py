"""The port's FSQ and discrete video tokenizer against gen3c_tpu's on the CPU.

Seeded latents go through both packages' ``fsq_bound`` / ``fsq_quantize`` /
``fsq_indices_to_codes``: indices equal, codes and bounded values at atol
1e-6 (tanh in two libraries). The straight-through gradient of the codes is
the bounded latent's, as ``jax.grad`` gives it. ``DiscreteVideoFSQTokenizer``
on DV_TINY shares JAX's weights (``bridge.vae_state_from_jax``): encode
indices equal, decode at atol 1e-4 (a stack of fp32 convolutions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.models import fsq as jfsq
from gen3c_tpu.models import vae as jvae
from gen3c_tpu.pipelines import autoregressive as jar_cli
from gen3c_tpu_torch.bridge import vae_state_from_jax
from gen3c_tpu_torch.models import fsq as tfsq
from gen3c_tpu_torch.models.vae import CausalVAE
from gen3c_tpu_torch.pipelines import autoregressive as tar_cli

torch.set_num_threads(2)

LEVELS = {"default": jfsq.DEFAULT_LEVELS, "odd_even": (7, 6, 5), "two": (8, 5)}


def _latent(levels, seed=0):
    return (np.random.RandomState(seed).standard_normal((2, 3, 5, 4, len(levels)))
            .astype(np.float32) * 2.0)


@pytest.mark.parametrize("name", sorted(LEVELS))
def test_fsq_bound_quantize_and_inverse(name):
    levels = LEVELS[name]
    z = _latent(levels)
    np.testing.assert_allclose(tfsq.fsq_bound(torch.from_numpy(z), levels).numpy(),
                               np.asarray(jfsq.fsq_bound(jnp.asarray(z), levels)), atol=1e-6,
                               rtol=0)
    jcodes, jidx = jfsq.fsq_quantize(jnp.asarray(z), levels)
    tcodes, tidx = tfsq.fsq_quantize(torch.from_numpy(z), levels)
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tcodes.numpy(), np.asarray(jcodes), atol=1e-6, rtol=0)
    assert 0 <= int(tidx.min()) and int(tidx.max()) < int(np.prod(levels))
    back = tfsq.fsq_indices_to_codes(tidx, levels)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(jfsq.fsq_indices_to_codes(jidx, levels)), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(back.numpy(), tcodes.numpy(), atol=1e-6, rtol=0)


def test_fsq_straight_through_gradient():
    levels = jfsq.DEFAULT_LEVELS
    z = _latent(levels, seed=1)
    w = np.random.RandomState(2).standard_normal(z.shape).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(jfsq.fsq_quantize(x, levels)[0] * w))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    (tfsq.fsq_quantize(zt, levels)[0] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert np.abs(np.asarray(want)).max() > 0


def test_dv8x16x16_config():
    assert tfsq.DV8x16x16.vocab_size == jfsq.DV8x16x16.vocab_size == 64000
    for field in ("latent_channels", "z_channels", "spatial_compression", "temporal_compression",
                  "channels_mult", "levels"):
        assert getattr(tfsq.DV8x16x16, field) == getattr(jfsq.DV8x16x16, field), field


def test_discrete_tokenizer_on_dv_tiny():
    cfg_j = jar_cli.DV_TINY
    params = jvae.init_vae_params(jax.random.PRNGKey(3), cfg_j)
    jtok = jfsq.DiscreteVideoFSQTokenizer(params, cfg_j, pixel_chunk_duration=9)
    vae = CausalVAE(tar_cli.DV_TINY)
    vae.load_state_dict(vae_state_from_jax({k: np.asarray(v) for k, v in params.items()}))
    ttok = tfsq.DiscreteVideoFSQTokenizer(vae, pixel_chunk_duration=9)
    assert ttok.latent_chunk_duration == jtok.latent_chunk_duration == 2
    video = np.random.RandomState(4).uniform(-1, 1, (1, 3, 9, 32, 32)).astype(np.float32)
    jcodes, jidx = jtok.encode(jnp.asarray(video))
    tcodes, tidx = ttok.encode(torch.from_numpy(video))
    assert tidx.shape == (1, 2, 4, 4)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tcodes.numpy(), np.asarray(jcodes), atol=1e-6, rtol=0)
    jout = jtok.decode(jidx)
    tout = ttok.decode(tidx)
    assert tout.shape == (1, 3, 9, 32, 32)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4, rtol=0)


def test_ar_4b_tokenizer_departure():
    """gen3c_tpu's ar_4b preset pairs the 4B with DiscreteVAEConfig(): the
    continuous VAE's 16 channels at 8x, which fsq_quantize's 6 levels cannot
    take (shapes only, jax.eval_shape: no 640x1024 encode runs). The port's
    ar_4b takes DV8x16x16 and its (1, 3, 33, 640, 1024) prompt gives the (5,
    40, 64) grid that AR_4B_VIDEO.latent_shape expects (meta tensors)."""
    ar_cfg, dv_cfg, h, w, chunk = jar_cli.AR_PRESETS["ar_4b"]
    params = jax.eval_shape(lambda: jvae.init_vae_params(jax.random.PRNGKey(0), dv_cfg))
    video = jax.ShapeDtypeStruct((1, 3, chunk, h, w), jnp.float32)
    z = jax.eval_shape(lambda p, x: jvae.vae_encode(p, dv_cfg, x), params, video)
    assert z.shape == (1, 16, 5, 80, 128)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        jax.eval_shape(lambda p, x: jfsq.DiscreteVideoFSQTokenizer(p, dv_cfg).encode(x),
                       params, video)

    preset = tar_cli.AR_PRESETS["ar_4b"]
    assert preset.dv is tfsq.DV8x16x16
    with torch.device("meta"):
        tok = tfsq.DiscreteVideoFSQTokenizer(CausalVAE(preset.dv), preset.chunk)
        codes, idx = tok.encode(torch.empty((1, 3, preset.chunk, preset.height, preset.width)))
    assert tuple(idx.shape[1:]) == preset.ar.latent_shape == (5, 40, 64)
    assert tuple(codes.shape) == (1, 6, 5, 40, 64)
