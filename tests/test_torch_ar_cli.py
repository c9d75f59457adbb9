"""The port's AR world-model CLI against gen3c_tpu's on the CPU.

Both run the ar_tiny preset on a seeded 9-frame 64x64 clip (PNG frames,
which both packages' ``read_video_bcthw`` read) with the same weights: JAX's
``demo`` inits them from its seed, and the port's ``demo`` gets JAX's AR
tree, DV tokenizer and diffusion decoder (its zero AdaLN gates randomized,
in both) through ``bridge``, and JAX's Gumbel draws for its sampling
(temperature 0.9, top-p 0.8). The generated tokens, 64 prefix + 192 new,
decode to frames within one level on at least 99.9% of the values (the
criterion of the other CLI parity tests), through the diffusion decoder
(3 chunks, 2 steps, the first 18 frames) and through the DV tokenizer
(--disable_diffusion_decoder, 25 frames).
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import gen3c_tpu.utils.io as jio
from gen3c_tpu.models import ar_transformer as jar
from gen3c_tpu.models import vae as jvae
from gen3c_tpu.models.dit import randomize_degenerate_inits
from gen3c_tpu.pipelines import autoregressive as jcli
from gen3c_tpu.pipelines import diffusion_decoder as jdd
from gen3c_tpu_torch.bridge import ar_state_from_jax, dd_state_from_jax, vae_state_from_jax
from gen3c_tpu_torch.models.ar_transformer import ARTransformer
from gen3c_tpu_torch.models.fsq import DiscreteVideoFSQTokenizer
from gen3c_tpu_torch.models.vae import CausalVAE
from gen3c_tpu_torch.pipelines import autoregressive as tcli
from gen3c_tpu_torch.pipelines import diffusion_decoder as tdd

torch.set_num_threads(2)

SEED = 0


def _clip(root):
    frames = (np.random.RandomState(0).rand(9, 64, 64, 3) * 255).astype(np.uint8)
    os.makedirs(root, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(root, f"{i:05d}.png"))
    return root


def _jax_gumbel(key, n, shape):
    keys = [key] + list(jax.random.split(jax.random.fold_in(key, 1), n - 1))
    draws = [np.asarray(jax.random.gumbel(k, shape)) for k in keys]
    return lambda step, shp, device: torch.tensor(draws[step], device=device)


def _assert_frames_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (diff <= 1).mean() >= 0.999, (diff.max(), (diff > 1).mean())


@pytest.mark.parametrize("dd", ["dd", "no_dd"])
def test_ar_cli_matches_jax(tmp_path, monkeypatch, dd):
    clip = _clip(str(tmp_path / "clip"))
    argv = ["--input_video", clip, "--model_preset", "ar_tiny", "--temperature", "0.9",
            "--diffusion_decoder_steps", "2", "--seed", str(SEED),
            "--video_save_folder", str(tmp_path / "out")]
    if dd == "no_dd":
        argv.append("--disable_diffusion_decoder")

    saved, pipes = [], []
    monkeypatch.setattr(jio, "save_video",
                        lambda video, fps, path, *a, **k: saved.append(np.array(video)) or path)
    build = jdd.build_dd_pipeline

    def build_randomized(*a, **k):
        pipe = build(*a, **k)
        pipe.dit_params = randomize_degenerate_inits(pipe.dit_params)
        pipes.append(pipe)
        return pipe

    monkeypatch.setattr(jdd, "build_dd_pipeline", build_randomized)
    jcli.demo(jcli.create_parser().parse_args(argv))

    preset = tcli.AR_PRESETS["ar_tiny"]
    key = jax.random.PRNGKey(SEED)
    model = ARTransformer(preset.ar)
    model.load_state_dict(ar_state_from_jax(jax.tree.map(
        np.asarray, jar.init_ar_params(key, jcli.AR_TINY_VIDEO))))
    vae = CausalVAE(preset.dv)
    vae.load_state_dict(vae_state_from_jax({k: np.asarray(v) for k, v in jvae.init_vae_params(
        jax.random.fold_in(key, 1), jcli.DV_TINY).items()}))
    tokenizer = DiscreteVideoFSQTokenizer(vae, preset.chunk)
    decoder = None
    if dd == "dd":
        decoder = tdd.build_dd_pipeline("ar_tiny", device="cpu")
        decoder.net.load_state_dict(dd_state_from_jax(jax.tree.map(np.asarray,
                                                                   pipes[0].dit_params)))
        decoder.continuous_tokenizer.vae.load_state_dict(vae_state_from_jax(
            {k: np.asarray(v) for k, v in pipes[0].continuous_tokenizer.params.items()}))
    record = {}
    path = tcli.demo(tcli.create_parser().parse_args(argv + ["--device", "cpu"]),
                     built=(model, tokenizer, decoder), record=record,
                     gumbel=_jax_gumbel(key, 192, (1, 64000)))
    assert os.path.exists(path) or os.path.isdir(os.path.splitext(path)[0])
    assert record["tokens"].shape == (1, 4, 8, 8)
    assert record["video"].shape == ((18 if dd == "dd" else 25), 64, 64, 3)
    _assert_frames_close(record["video"], saved[0])


def test_ar_cli_parser():
    """Every flag of gen3c_tpu's parser, and --device defaulting to cuda."""
    jflags = {a.dest for a in jcli.create_parser()._actions}
    tparser = tcli.create_parser()
    tflags = {a.dest for a in tparser._actions}
    assert jflags <= tflags and tflags - jflags == {"device"}
    args = tparser.parse_args(["--input_video", "x"])
    assert args.device == "cuda" and args.model_preset == "ar_4b"
    assert set(tcli.AR_PRESETS) == set(jcli.AR_PRESETS)


def test_ar_cli_builds_seeded_models_without_checkpoints(tmp_path):
    """Without checkpoint files the CLI's builders give seeded random
    weights (the same for the same seed) and the decoder of ar_tiny."""
    preset = tcli.AR_PRESETS["ar_tiny"]
    a = tcli.build_ar_model(preset, "cpu", seed=3, checkpoint_dir=str(tmp_path))
    b = tcli.build_ar_model(preset, "cpu", seed=3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    tok = tcli.build_dv_tokenizer(preset, "cpu", seed=3)
    assert tok.latent_chunk_duration == 2 and tok.cfg.vocab_size == 64000
    assert tdd.build_dd_pipeline("ar_tiny", device="cpu").token_to_latent_scale == 1


def test_time_ar_world_refuses_without_a_card(monkeypatch):
    """No card: a refusal. Its run is the uncut one: every token of the
    ar_4b grid after the 2-frame prefix, and the decoder's own steps."""
    from gen3c_tpu_torch.pipelines import autoregressive as tar
    from gen3c_tpu_torch.pipelines import diffusion_decoder as tdd
    from gen3c_tpu_torch.scripts import time_ar_world

    t, h, w = tar.AR_PRESETS["ar_4b"].ar.latent_shape
    assert time_ar_world.TOKENS == (t - 2) * h * w == 7680
    assert time_ar_world.DD_STEPS == tdd.DDSamplingConfig().num_steps
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        time_ar_world.main([])
