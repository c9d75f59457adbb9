"""The port's AR diffusion decoder against gen3c_tpu's on the CPU.

``split_with_overlap`` (its reflect pad, and the ValueError where the pad
reaches the chunk's body) and ``linear_blend_video_list`` are exact.
``embed_tokens`` at 1x and 2x against ``jax.image.resize`` at atol 1e-6
(fp32 weight matrices contracted in another order). ``refine`` on the tiny
decoder, its weights JAX's (``bridge.dd_state_from_jax`` and
``vae_state_from_jax``; the zero AdaLN gates randomized so that the
blocks act): each chunk's latent at atol 1e-4, the frames as uint8 within
one level on at least 99.9% of the values, one chunk and three. The 7B
builder is checkpoint-gated and loads a dd_dit.npz written by
gen3c_tpu's ``save_params_npz``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.models import vae as jvae
from gen3c_tpu.models.dit import randomize_degenerate_inits
from gen3c_tpu.pipelines import diffusion_decoder as jdd
from gen3c_tpu.utils import checkpoint as jckpt
from gen3c_tpu_torch.bridge import dd_state_from_jax, vae_state_from_jax
from gen3c_tpu_torch.pipelines import diffusion_decoder as tdd

torch.set_num_threads(2)

STEPS = 3


def _frames_u8(video):
    v = np.asarray(video, np.float32)
    return ((v + 1) / 2 * 255).clip(0, 255).astype(np.uint8)


def _assert_frames_close(got, want):
    assert got.shape == want.shape
    diff = np.abs(_frames_u8(got).astype(np.int16) - _frames_u8(want).astype(np.int16))
    assert (diff <= 1).mean() >= 0.999, (diff.max(), (diff > 1).mean())


@pytest.mark.parametrize("T,num,overlap", [(12, 8, 2), (8, 8, 2), (5, 8, 2), (4, 2, 1),
                                           (9, 4, 1), (1, 3, 1)])
def test_split_with_overlap(T, num, overlap):
    x = np.arange(2 * 3 * T * 2 * 2, dtype=np.float32).reshape(2, 3, T, 2, 2)
    try:
        want = jdd.split_with_overlap(jnp.asarray(x), num, overlap)
    except ValueError:
        with pytest.raises(ValueError, match="reflect pad"):
            tdd.split_with_overlap(torch.from_numpy(x), num, overlap)
        return
    got = tdd.split_with_overlap(torch.from_numpy(x), num, overlap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_split_with_overlap_raises_where_jax_does():
    x = torch.zeros((1, 1, 5, 1, 1))
    with pytest.raises(ValueError, match="reflect pad"):
        tdd.split_with_overlap(x, 10, 2)
    with pytest.raises(ValueError):
        tdd.split_with_overlap(x, 2, 2)


@pytest.mark.parametrize("n,d", [(2, 2), (3, 1), (4, 3)])
def test_linear_blend_video_list(n, d):
    rs = np.random.RandomState(n)
    vids = [rs.standard_normal((1, 3, 9, 4, 5)).astype(np.float32) for _ in range(n)]
    want = jdd.linear_blend_video_list([jnp.asarray(v) for v in vids], d)
    got = tdd.linear_blend_video_list([torch.from_numpy(v) for v in vids], d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale", [1, 2])
def test_embed_tokens(scale):
    rs = np.random.RandomState(0)
    table = rs.standard_normal((1000, 32)).astype(np.float32)
    idx = rs.randint(0, 1000, (2, 3, 5, 7)).astype(np.int32)
    hw = (5 * scale, 7 * scale)
    want = jdd.embed_tokens(jnp.asarray(table), jnp.asarray(idx), hw)
    got = tdd.embed_tokens(torch.from_numpy(table), torch.from_numpy(idx), hw)
    assert tuple(got.shape) == (2, 32, 3) + hw
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


_PIPES = {}


def _pipes():
    """(JAX tiny pipeline, port pipeline) on the same weights, STEPS steps."""
    if not _PIPES:
        jp = jdd.build_dd_pipeline("ar_tiny", jax.random.PRNGKey(5))
        jp.dit_params = randomize_degenerate_inits(jp.dit_params)
        jp.sampling.num_steps = STEPS
        tp = tdd.build_dd_pipeline("ar_tiny", device="cpu", seed=0)
        tp.net.load_state_dict(dd_state_from_jax(jax.tree.map(np.asarray, jp.dit_params)))
        tp.continuous_tokenizer.vae.load_state_dict(vae_state_from_jax(
            {k: np.asarray(v) for k, v in jp.continuous_tokenizer.params.items()}))
        tp.sampling.num_steps = STEPS
        _PIPES["pair"] = (jp, tp)
    return _PIPES["pair"]


@pytest.mark.parametrize("T", [2, 4])
def test_refine_matches_jax(T):
    """T = 2: one chunk of the tiny decoder's 2 latent frames; T = 4: three
    chunks overlapping by one, blended."""
    jp, tp = _pipes()
    tokens = np.random.RandomState(T).randint(0, 64000, (1, T, 8, 8)).astype(np.int32)
    jchunks = jdd.split_with_overlap(jnp.asarray(tokens)[:, None], 2, 1) if T > 2 else \
        [jnp.asarray(tokens)[:, None]]
    tchunks = tp.chunks(torch.from_numpy(tokens))
    assert len(tchunks) == len(jchunks) == (1 if T == 2 else 3)
    t5 = np.zeros((1, 512, 1024), np.float32)
    for jc, tc in zip(jchunks, tchunks):
        want = jp._refine_chunk(jc, jnp.asarray(t5), seed=3)
        got = tp._refine_chunk(tc, torch.from_numpy(t5), seed=3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    want = jp.refine(jnp.asarray(tokens), seed=3)
    got = tp.refine(torch.from_numpy(tokens), seed=3)
    assert tuple(got.shape) == tuple(want.shape) == ((1, 3, 9, 64, 64) if T == 2
                                                     else (1, 3, 25, 64, 64))
    _assert_frames_close(got.numpy(), np.asarray(want))


def test_7b_builder_is_checkpoint_gated(tmp_path, monkeypatch):
    """No checkpoint dir, or one without gen3c_tpu/dd_dit.npz: FileNotFoundError
    (as gen3c_tpu). With the file (written by gen3c_tpu's save_params_npz,
    a tree of the 7B's structure at a cut size) the decoder loads it."""
    with pytest.raises(FileNotFoundError, match="dd_dit.npz"):
        tdd.build_dd_pipeline("ar_4b", device="cpu")
    with pytest.raises(FileNotFoundError, match="dd_dit.npz"):
        tdd.build_dd_pipeline("ar_4b", device="cpu", checkpoint_dir=str(tmp_path))
    small = jdd.DIFFUSION_DECODER_TINY
    params = jdd.init_dd_params(jax.random.PRNGKey(1), small, vocab_size=64)
    os.makedirs(tmp_path / "gen3c_tpu")
    jckpt.save_params_npz(str(tmp_path / "gen3c_tpu" / "dd_dit.npz"), params)
    cut = dict(dit_cfg=tdd.DIFFUSION_DECODER_TINY, cv_cfg=tdd.CV_TINY, vocab_size=64,
               sampling=tdd.DDSamplingConfig(dd_train_num_video_frames=9))
    made, original = [], tdd.make_dd_pipeline

    def make(device="cuda", seed=0, **kw):
        made.append(seed)
        return original(device=device, seed=seed, **cut)

    monkeypatch.setattr(tdd, "make_dd_pipeline", make)
    pipe = tdd.build_dd_pipeline("ar_4b", device="cpu", checkpoint_dir=str(tmp_path))
    assert made == [0]
    np.testing.assert_array_equal(pipe.net.token_embedder.weight.numpy(),
                                  np.asarray(params["token_embedder.weight"]))
    np.testing.assert_array_equal(pipe.net.final_layer.linear.weight.numpy(),
                                  np.asarray(params["final"]["linear"]["w"]).T)


def test_7b_config_and_seeded_build():
    """DIFFUSION_DECODER_7B is gen3c_tpu's (48 input channels, RoPE 1.5x in H
    and W) in bf16; the seeded build (meta, then the device) gives a
    DiffusionDecoderDiT with a 64,000 x 32 fp32 token table."""
    j, t = jdd.DIFFUSION_DECODER_7B, tdd.DIFFUSION_DECODER_7B
    for f in ("in_channels", "model_channels", "num_blocks", "num_heads",
              "rope_h_extrapolation_ratio", "rope_w_extrapolation_ratio",
              "rope_t_extrapolation_ratio", "patch_spatial", "max_img_h", "max_img_w"):
        assert getattr(j, f) == getattr(t, f), f
    assert t.dtype == torch.bfloat16 and t.patch_in_dim == (48 + 1) * 4
    with torch.device("meta"):
        net = tdd.DiffusionDecoderDiT(t)
    assert tuple(net.token_embedder.weight.shape) == (64000, 32)
    assert net.token_embedder.weight.dtype == torch.float32
    assert jvae.CV8x8x8.latent_channels == tdd.CV8x8x8.latent_channels == 16
