"""The Cosmos sibling pipelines of the port against gen3c_tpu on the CPU.

text2world / video2world (``generate_world`` and the CLI), the world
interpolator (one pair, and ``--input_video`` segments chained without
their duplicated first frame) and the tokenizer CLI (encode, decode,
round trip, a short unaligned clip) run in both packages on the tiny
presets with the same weights: JAX's fp32 init with the DiT's zero gates
randomized, bridged into the port (``bridge.dit_state_from_jax``,
``vae_state_from_jax``). Frames are compared as uint8 with the criterion
of the existing CLI parity tests (tests/test_torch_pipeline.py): within one
level on at least 99.9% of the values; latents at atol 1e-4.
"""

import argparse
import dataclasses
import os

import imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import gen3c_tpu.utils.io as jio
from gen3c_tpu.models import conditioner as jcond
from gen3c_tpu.models import vae as jvae
from gen3c_tpu.models.dit import randomize_degenerate_inits
from gen3c_tpu.pipelines import factory as jfactory
from gen3c_tpu.pipelines import text2world as jt2w
from gen3c_tpu.pipelines import tokenizer_cli as jtok
from gen3c_tpu.pipelines import world_interpolator as jinterp
from gen3c_tpu_torch.bridge import dit_state_from_jax, vae_state_from_jax
from gen3c_tpu_torch.models import conditioner as tcond
from gen3c_tpu_torch.models.vae import CausalVAE, VideoTokenizer
from gen3c_tpu_torch.pipelines import factory as tfactory
from gen3c_tpu_torch.pipelines import text2world as tt2w
from gen3c_tpu_torch.pipelines import tokenizer_cli as ttok
from gen3c_tpu_torch.pipelines import video2world as tv2w
from gen3c_tpu_torch.pipelines import world_interpolator as tinterp

torch.set_num_threads(2)


def _assert_frames_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (diff <= 1).mean() >= 0.999, (diff.max(), (diff > 1).mean())


_PAIRS = {}


def _pair(name):
    """(JAX model, port model, preset) of a tiny T2W preset on shared weights."""
    if name not in _PAIRS:
        jm, preset = jfactory.build_gen3c_model(jt2w.T2W_PRESETS[name], checkpoint_dir=None,
                                                seed=0, param_dtype=jnp.float32)
        jm.dit_params = randomize_degenerate_inits(jm.dit_params)
        tm, _ = tfactory.build_gen3c_model(tt2w.T2W_PRESETS[name], device="cpu", seed=0)
        tm.net.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, jm.dit_params)))
        tm.tokenizer.vae.load_state_dict(
            vae_state_from_jax({k: np.asarray(v) for k, v in jm.tokenizer.params.items()}))
        _PAIRS[name] = (jm, tm, preset)
    return _PAIRS[name]


def _capture_saves(monkeypatch):
    """The frames gen3c_tpu's CLIs hand to save_video."""
    saved = []

    def save(video, fps, path, *a, **kw):
        saved.append(np.asarray(video).copy())
        return path

    monkeypatch.setattr(jio, "save_video", save)
    return saved


def _image(path, h, w, seed):
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (h // 8, w // 8, 3))
    img = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w]
    Image.fromarray(img.astype(np.uint8)).save(path)


def test_presets_match_jax():
    assert list(tt2w.T2W_PRESETS) == list(jt2w.T2W_PRESETS)
    for name, t in tt2w.T2W_PRESETS.items():
        j = jt2w.T2W_PRESETS[name]
        assert (t.height, t.width, t.chunk_size, t.state_shape) == (
            j.height, j.width, j.chunk_size, j.state_shape), name
        for f in ("in_channels", "out_channels", "model_channels", "num_blocks", "num_heads",
                  "adaln_lora_dim", "crossattn_emb_channels", "rope_t_extrapolation_ratio",
                  "rope_h_extrapolation_ratio", "concat_padding_mask", "max_frames"):
            assert getattr(t.dit, f) == getattr(j.dit, f), (name, f)
        assert (t.vae.channels, t.vae.channels_mult, t.vae.num_res_blocks) == (
            j.vae.channels, j.vae.channels_mult, j.vae.num_res_blocks)
    assert tt2w.COSMOS_T2W_7B.dit.dtype == torch.bfloat16
    assert tt2w.COSMOS_T2W_7B.dit.num_blocks == 28 and tt2w.COSMOS_T2W_7B.dit.model_channels == 4096


@pytest.mark.parametrize("name,solver", [("cosmos_t2w_tiny", "euler"), ("cosmos_t2w_tiny", "dpm2m"),
                                         ("cosmos_v2w_tiny", "res2ab")])
def test_generate_world_matches_jax(name, solver):
    jm, tm, preset = _pair(name)
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((1, 512, 1024)).astype(np.float32)
    neg = rng.standard_normal((1, 512, 1024)).astype(np.float32) * 0.5
    kw = dict(guidance=3.0, num_steps=3, seed=5, solver=solver)
    jcl = tcl = None
    n_cond = 0
    if name.startswith("cosmos_v2w"):
        frames = rng.uniform(-1, 1, (1, 3, 1, preset.height, preset.width)).astype(np.float32)
        jcl = jm.create_condition_latent_from_input_frames(jnp.asarray(frames), 1)
        tcl = tm.create_condition_latent_from_input_frames(torch.from_numpy(frames), 1)
        np.testing.assert_allclose(tcl.numpy(), np.asarray(jcl), atol=1e-4, rtol=0)
        n_cond = 1
    want = jt2w.generate_world(jm, preset, emb, neg_t5_embeddings=neg, condition_latent=jcl,
                               num_condition_t=n_cond, **kw)
    steps = []
    got = tt2w.generate_world(tm, preset, emb, neg_t5_embeddings=neg, condition_latent=tcl,
                              num_condition_t=n_cond, on_step=lambda *a: steps.append(a), **kw)
    assert got.shape == (preset.chunk_size, preset.height, preset.width, 3)
    assert len(steps) == 3
    _assert_frames_close(got, want)


def _t2w_argv(tmp_path, name, *extra):
    return ["--prompt", "a calm lake", "--model_preset", name, "--num_steps", "2",
            "--checkpoint_dir", str(tmp_path / "none"), "--video_save_folder",
            str(tmp_path / "out"), "--guidance", "7", *extra]


@pytest.mark.parametrize("mode", ["text2world", "video2world"])
def test_cli_matches_jax(tmp_path, monkeypatch, mode):
    name = "cosmos_t2w_tiny" if mode == "text2world" else "cosmos_v2w_tiny"
    jm, tm, preset = _pair(name)
    argv = _t2w_argv(tmp_path, name, "--mode", mode, "--solver", "dpm2m")
    if mode == "video2world":
        _image(tmp_path / "seed.png", preset.height, preset.width, 3)
        argv += ["--input_image_path", str(tmp_path / "seed.png")]
    monkeypatch.setattr(jt2w, "build_gen3c_model", lambda *a, **kw: (jm, preset))
    saved = _capture_saves(monkeypatch)
    jt2w.demo(jt2w.create_parser().parse_args(argv))
    record = {}
    path = tt2w.demo(tt2w.create_parser().parse_args(argv + ["--device", "cpu"]),
                     built=(tm, preset), record=record)
    assert os.path.exists(path) or os.path.isdir(os.path.splitext(path)[0])
    assert [s["cfg"] for s in record["steps"]] == [True, True]
    _assert_frames_close(record["video"], saved[0])


def test_video2world_entry_point_runs(tmp_path):
    """``python -m gen3c_tpu_torch.pipelines.video2world`` on the tiny v2w
    preset, on the CPU, with the port's own seeded weights."""
    _image(tmp_path / "seed.png", 96, 160, 4)
    path = tv2w.main(_t2w_argv(tmp_path, "cosmos_v2w_tiny", "--device", "cpu",
                               "--input_image_path", str(tmp_path / "seed.png")))
    assert os.path.exists(path) or os.path.isdir(os.path.splitext(path)[0])


def test_video2world_needs_an_input(tmp_path):
    _, tm, preset = _pair("cosmos_v2w_tiny")
    args = tt2w.create_parser().parse_args(_t2w_argv(tmp_path, "cosmos_v2w_tiny", "--mode",
                                                     "video2world", "--device", "cpu"))
    with pytest.raises(ValueError, match="input_image_path"):
        tt2w.demo(args, built=(tm, preset))


def test_clis_default_to_the_card():
    assert tt2w.create_parser().parse_args(["--prompt", "x"]).device == "cuda"
    assert tinterp.create_parser().parse_args([]).device == "cuda"
    assert tinterp.create_parser().parse_args([]).solver == "res2ab"


# ------------------------------ the interpolator ------------------------------


def _interp_args(**over):
    ns = dict(num_steps=3, guidance=7.0, guidance_interval=None, solver="res2ab")
    ns.update(over)
    return argparse.Namespace(**ns)


@pytest.mark.parametrize("solver", ["res2ab", "euler"])
def test_interpolate_pair_matches_jax(solver):
    jm, tm, preset = _pair("cosmos_v2w_tiny")
    rng = np.random.default_rng(2)
    first, last = (rng.uniform(-1, 1, (1, 3, 1, preset.height, preset.width)).astype(np.float32)
                   for _ in range(2))
    args = _interp_args(solver=solver)
    want = jinterp._interpolate_pair(jm, preset, first, last, args, seed=3)
    record = {}
    got = tinterp._interpolate_pair(tm, preset, first, last, args, seed=3, record=record)
    assert len(record["step_seconds"][0]) == 3
    _assert_frames_close(got, want)


def test_interpolator_input_video_chains_as_jax(tmp_path, monkeypatch):
    """Three frames, stride 1: two pairs, 9 + 8 frames (the second segment
    without its duplicated first frame), the prompt ignored by both."""
    jm, tm, preset = _pair("cosmos_v2w_tiny")
    clip = tmp_path / "clip"
    clip.mkdir()
    for i in range(3):
        _image(clip / f"{i:03d}.png", preset.height, preset.width, 10 + i)
    argv = ["--input_video", str(clip), "--model_preset", "cosmos_v2w_tiny", "--num_steps", "2",
            "--prompt", "ignored", "--checkpoint_dir", str(tmp_path / "none"),
            "--video_save_folder", str(tmp_path / "out")]
    monkeypatch.setattr(jinterp, "build_gen3c_model", lambda *a, **kw: (jm, preset))
    saved = _capture_saves(monkeypatch)
    jinterp.demo(jinterp.create_parser().parse_args(argv))
    record = {}
    tinterp.demo(tinterp.create_parser().parse_args(argv + ["--device", "cpu"]),
                 built=(tm, preset), record=record)
    assert record["video"].shape[0] == 2 * preset.chunk_size - 1
    assert len(record["step_seconds"]) == 2
    _assert_frames_close(record["video"], saved[0])


def test_interpolator_pair_mode_cli_runs(tmp_path):
    for name, seed in (("a.png", 1), ("b.png", 2)):
        _image(tmp_path / name, 96, 160, seed)
    path = tinterp.main(["--first_image", str(tmp_path / "a.png"), "--last_image",
                         str(tmp_path / "b.png"), "--model_preset", "cosmos_v2w_tiny",
                         "--num_steps", "2", "--device", "cpu", "--checkpoint_dir",
                         str(tmp_path / "none"), "--video_save_folder", str(tmp_path / "out")])
    assert os.path.exists(path) or os.path.isdir(os.path.splitext(path)[0])


def test_interpolator_refuses_a_t2w_preset(tmp_path):
    _, tm, preset = _pair("cosmos_t2w_tiny")
    args = tinterp.create_parser().parse_args(["--model_preset", "cosmos_t2w_tiny",
                                               "--device", "cpu"])
    with pytest.raises(ValueError, match="v2w"):
        tinterp.demo(args, built=(tm, preset))


# ------------------------------ conditions ------------------------------


@pytest.mark.parametrize("location,n,video_cond", [("first_n", 2, True),
                                                   ("first_and_last_1", 1, True),
                                                   ("first_and_last_1", 2, False),
                                                   ("first_n", 1, False)])
def test_condition_location_and_video_cond_bool_match_jax(location, n, video_cond):
    latent = np.random.default_rng(0).standard_normal((2, 4, 5, 3, 3)).astype(np.float32)
    jc = jcond.add_condition_video_indicator_and_input_mask(
        jnp.asarray(latent), jcond.VideoExtendCondition(crossattn_emb=jnp.zeros((2, 1, 8)),
                                                        video_cond_bool=video_cond), n, location)
    tc = tcond.add_condition_video_indicator_and_input_mask(
        torch.from_numpy(latent), tcond.VideoExtendCondition(crossattn_emb=torch.zeros(2, 1, 8),
                                                             video_cond_bool=video_cond),
        n, location)
    np.testing.assert_array_equal(tc.condition_video_indicator.numpy(),
                                  np.asarray(jc.condition_video_indicator))
    np.testing.assert_array_equal(tc.condition_video_input_mask.numpy(),
                                  np.asarray(jc.condition_video_input_mask))
    assert tc.condition_video_input_mask.any() == video_cond


def test_unknown_condition_location_raises():
    with pytest.raises(ValueError, match="condition_location"):
        tcond.add_condition_video_indicator_and_input_mask(
            torch.zeros(1, 4, 3, 2, 2), tcond.VideoExtendCondition(torch.zeros(1, 1, 8)), 1,
            "last_n")


# ------------------------------ the tokenizer CLI ------------------------------


@pytest.fixture
def shared_tokenizer(monkeypatch):
    """Both CLIs' build_tokenizer on JAX's tiny init (PRNGKey 0), bridged."""
    params = jvae.init_vae_params(jax.random.PRNGKey(0), jtok.VAE_PRESETS["tiny"])
    state = vae_state_from_jax({k: np.asarray(v) for k, v in params.items()})
    monkeypatch.setattr(jtok, "build_tokenizer", lambda args: jvae.VideoTokenizer(
        params, jtok.VAE_PRESETS[args.vae_preset], pixel_chunk_duration=args.chunk_duration))

    def port_tokenizer(args, device):
        vae = CausalVAE(ttok.VAE_PRESETS[args.vae_preset], device=device)
        vae.load_state_dict(state)
        return VideoTokenizer(vae, pixel_chunk_duration=args.chunk_duration)

    monkeypatch.setattr(ttok, "build_tokenizer", port_tokenizer)


def _gif(path, t, h, w, seed=0):
    frames = (np.random.RandomState(seed).rand(t, h, w, 3) * 255).astype(np.uint8)
    imageio.mimsave(str(path), list(frames))


@pytest.mark.parametrize("t,h,w,chunk", [(9, 64, 64, "9"), (7, 50, 70, None)],
                         ids=["aligned", "short-unaligned"])
def test_tokenizer_roundtrip_matches_jax(tmp_path, monkeypatch, capsys, shared_tokenizer,
                                         t, h, w, chunk):
    _gif(tmp_path / "in.gif", t, h, w)
    argv = ["--mode", "roundtrip", "--input", str(tmp_path / "in.gif"), "--vae_preset", "tiny"]
    if chunk:
        argv += ["--chunk_duration", chunk]
    saved = _capture_saves(monkeypatch)
    jtok.main(argv + ["--output", str(tmp_path / "j.mp4")])
    jpsnr = float(capsys.readouterr().out.strip().split()[-1])
    record = {}
    ttok.main(argv + ["--output", str(tmp_path / "t.mp4"), "--device", "cpu"], record=record)
    assert f"PSNR: {record['psnr']:.2f}" in capsys.readouterr().out
    assert record["frames"].shape == (t, h, w, 3)
    _assert_frames_close(record["frames"], saved[0])
    assert abs(record["psnr"] - jpsnr) <= 0.02


def test_tokenizer_encode_decode_match_jax(tmp_path, monkeypatch, shared_tokenizer):
    _gif(tmp_path / "in.gif", 9, 64, 64, seed=1)
    common = ["--vae_preset", "tiny", "--chunk_duration", "9"]
    jtok.main(["--mode", "encode", "--input", str(tmp_path / "in.gif"), "--output",
               str(tmp_path / "j.npz"), *common])
    ttok.main(["--mode", "encode", "--input", str(tmp_path / "in.gif"), "--output",
               str(tmp_path / "t.npz"), "--device", "cpu", *common])
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert t["latent"].shape == (1, 16, 2, 8, 8)
    np.testing.assert_allclose(t["latent"], j["latent"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t["crop_region"], j["crop_region"])
    saved = _capture_saves(monkeypatch)
    jtok.main(["--mode", "decode", "--input", str(tmp_path / "j.npz"), "--output",
               str(tmp_path / "j.mp4"), *common])
    record = {}
    ttok.main(["--mode", "decode", "--input", str(tmp_path / "j.npz"), "--output",
               str(tmp_path / "t.mp4"), "--device", "cpu", *common], record=record)
    _assert_frames_close(record["frames"], saved[0])


@pytest.mark.parametrize("shape,align,rule", [((1, 3, 7, 50, 70), 8, "causal"),
                                              ((1, 3, 9, 64, 64), 8, "causal"),
                                              ((1, 3, 130, 33, 17), 121, "multiple")])
def test_pad_video_and_psnr_match_jax(shape, align, rule):
    video = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    got, gcrop = ttok.pad_video_bcthw(video, align, temporal_rule=rule)
    want, wcrop = jtok.pad_video_bcthw(video, align, temporal_rule=rule)
    np.testing.assert_array_equal(got, want)
    assert gcrop == wcrop
    a = (video[0, 0] * 100 + 128).astype(np.uint8)
    assert ttok.psnr(a, a[::-1]) == jtok.psnr(a, a[::-1])


def test_tokenizer_cli_seeded_weights_run(tmp_path):
    """The port's own seeded tiny tokenizer, no checkpoint directory."""
    _gif(tmp_path / "in.gif", 9, 32, 32, seed=2)
    record = {}
    ttok.main(["--mode", "roundtrip", "--input", str(tmp_path / "in.gif"), "--output",
               str(tmp_path / "o.mp4"), "--vae_preset", "tiny", "--chunk_duration", "9",
               "--device", "cpu"], record=record)
    assert np.isfinite(record["psnr"]) and record["frames"].shape == (9, 32, 32, 3)


# ------------------------------ checkpoints ------------------------------


def test_t2w_checkpoint_loads(tmp_path):
    """A cosmos_t2w_tiny DiT written in both layouts the factory reads (the
    reference's wrapped model.pt, the native dit.npz) loads back bit-equal:
    the T2W net has the GEN3C net's keys at 16 input channels."""
    from gen3c_tpu_torch.models.convert import convert_dit_state_dict
    from gen3c_tpu_torch.utils.checkpoint import save_params_npz

    preset = tt2w.COSMOS_T2W_TINY
    model, _ = tfactory.build_gen3c_model(preset, device="cpu", seed=3)
    state = model.net.state_dict()
    assert state["x_embedder.proj.1.weight"].shape[1] == 17 * 4  # 16 + the padding mask
    os.makedirs(tmp_path / "pt" / "GEN3C-Cosmos-7B")
    torch.save({"model": {f"net.{k}": v for k, v in state.items()}},
               tmp_path / "pt" / "GEN3C-Cosmos-7B" / "model.pt")
    save_params_npz(str(tmp_path / "npz" / "gen3c_tpu" / "dit.npz"),
                    convert_dit_state_dict(state, dataclasses.replace(preset.dit)))
    for layout in ("pt", "npz"):
        loaded, _ = tfactory.build_gen3c_model(preset, device="cpu",
                                               checkpoint_dir=str(tmp_path / layout))
        for k, v in loaded.net.state_dict().items():
            assert torch.equal(v, state[k]), (layout, k)
