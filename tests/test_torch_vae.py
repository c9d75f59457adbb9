"""The VAE tokenizer port against gen3c_tpu.models.vae on the CPU.

The JAX package's random init goes through bridge.vae_state_from_jax (the
identity on the reference names) into the port's CausalVAE; both encode
and decode the same numpy video. fp32 throughout; the convolutions and
norms sum in different orders, so atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.models import vae as jvae
from gen3c_tpu.pipelines.factory import GEN3C_TINY_PRESET as JAX_TINY
from gen3c_tpu_torch.bridge import vae_state_from_jax
from gen3c_tpu_torch.models import vae as tvae
from gen3c_tpu_torch.pipelines.factory import GEN3C_TINY_PRESET

torch.set_num_threads(2)

ATOL = 1e-4


def _configs(with_level_attn):
    """(JAX cfg, port cfg): the tiny preset's VAE, optionally with
    attention blocks in the level at resolution 32."""
    jcfg, tcfg = JAX_TINY.vae, GEN3C_TINY_PRESET.vae
    if with_level_attn:
        jcfg = dataclasses.replace(jcfg, attn_resolutions=(32,))
        tcfg = dataclasses.replace(tcfg, attn_resolutions=(32,))
    return jcfg, tcfg


def _build(with_level_attn, seed=0):
    jcfg, tcfg = _configs(with_level_attn)
    params = jvae.init_vae_params(jax.random.PRNGKey(seed), jcfg)
    # non-trivial norms and biases, so the bridge is checked on every leaf
    rng = np.random.default_rng(seed)
    params = {k: (np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
                  if k.endswith(("bias", "norm.weight")) else np.asarray(v))
              for k, v in params.items()}
    model = tvae.CausalVAE(tcfg)
    missing = model.load_state_dict(vae_state_from_jax(params), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    assert set(model.state_dict()) == set(params)
    return {k: jnp.asarray(v) for k, v in params.items()}, jcfg, model


@pytest.mark.parametrize("with_level_attn", [False, True])
def test_vae_encode_decode_match_jax(with_level_attn):
    jparams, jcfg, model = _build(with_level_attn)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 3, 9, 32, 48)).astype(np.float32)
    want = np.asarray(jax.jit(jvae.vae_encode, static_argnums=1)(jparams, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 2, 4, 6)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    z = np.random.default_rng(2).standard_normal(want.shape).astype(np.float32)
    want_x = np.asarray(jax.jit(jvae.vae_decode, static_argnums=1)(jparams, jcfg, jnp.asarray(z)))
    with torch.no_grad():
        got_x = model.decode(torch.from_numpy(z)).numpy()
    assert got_x.shape == want_x.shape == (2, 3, 9, 32, 48)
    np.testing.assert_allclose(got_x, want_x, atol=ATOL, rtol=0)


def test_haar_patching_roundtrip_matches_jax():
    x = np.random.default_rng(3).standard_normal((1, 3, 9, 16, 24)).astype(np.float32)
    want = np.asarray(jvae.haar_patch3d(jnp.asarray(x), 4))
    got = tvae.haar_patch3d(torch.from_numpy(x), 4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tvae.haar_unpatch3d(torch.from_numpy(want), 4).numpy(),
                               np.asarray(jvae.haar_unpatch3d(jnp.asarray(want), 4)),
                               atol=1e-5, rtol=0)


def test_video_tokenizer_two_chunks_match_jax():
    jparams, jcfg, model = _build(False, seed=4)
    rng = np.random.default_rng(5)
    lat_t = 2  # (9 - 1) // 8 + 1
    mean = rng.standard_normal((1, 16, lat_t, 1, 1)).astype(np.float32)
    std = rng.uniform(0.5, 2.0, (1, 16, lat_t, 1, 1)).astype(np.float32)
    jtok = jvae.VideoTokenizer(jparams, jcfg, pixel_chunk_duration=9,
                               latent_mean=jnp.asarray(mean), latent_std=jnp.asarray(std),
                               spatial_resolution=(32, 48))
    ttok = tvae.VideoTokenizer(model, pixel_chunk_duration=9, latent_mean=torch.from_numpy(mean),
                               latent_std=torch.from_numpy(std), spatial_resolution=(32, 48))
    video = rng.uniform(-1, 1, (1, 3, 18, 32, 48)).astype(np.float32)  # two chunks
    want = np.asarray(jtok.encode(jnp.asarray(video)))
    got = ttok.encode(torch.from_numpy(video)).numpy()
    assert got.shape == want.shape == (1, 16, 4, 4, 6)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    want_v = np.asarray(jtok.decode(jnp.asarray(want)))
    got_v = ttok.decode(torch.from_numpy(want)).numpy()
    assert got_v.shape == want_v.shape == video.shape
    np.testing.assert_allclose(got_v, want_v, atol=ATOL, rtol=0)
