"""The multiview Cosmos world model of the port against gen3c_tpu on the CPU.

``models/dit_multiview.py``, ``pipelines/text2world_multiview.py``, the
multiview converter and bridge, the multiview train step and the clip
datasets run in both packages on the tiny presets with the same weights:
JAX's fp32 init with the zero AdaLN gates, the final linear and the
repeat-frame embedding randomized (so every path, frame_repeat included,
reaches the output), bridged into the port (``bridge.multiview_state_from_jax``,
``vae_state_from_jax``).

Tolerances: the sincos tables and the converted trees bit for bit; the
forward (fp32) atol 1e-5; the sampler's final latents atol 1e-4 and the
uint8 frames within one level on at least 99.9% of the values (the
criterion of tests/test_torch_cosmos_pipelines.py); the train step's loss
rtol 1e-5 and each gradient leaf within 1e-4 of its largest |value|, a
full step's loss and grad-norm rtol 1e-4 and its params within 0.05 * lr
(as tests/test_torch_training.py); dataset latents atol 1e-5.
"""

import dataclasses
import os
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import gen3c_tpu.utils.io as jio
from gen3c_tpu.models import convert as jconvert
from gen3c_tpu.models import dit_multiview as jmv
from gen3c_tpu.models.dit import randomize_degenerate_inits
from gen3c_tpu.pipelines import factory as jfactory
from gen3c_tpu.pipelines import text2world_multiview as jt
from gen3c_tpu.training import datasets as jds
from gen3c_tpu.training import losses as jlosses
from gen3c_tpu.training import train_step as jts
from gen3c_tpu.utils.checkpoint import save_params_npz
from gen3c_tpu_torch.bridge import multiview_state_from_jax, train_params_from_jax, vae_state_from_jax
from gen3c_tpu_torch.models import convert as tconvert
from gen3c_tpu_torch.models import dit_multiview as tmv
from gen3c_tpu_torch.pipelines import factory as tfactory
from gen3c_tpu_torch.pipelines import text2world_multiview as tt
from gen3c_tpu_torch.training import datasets as tds
from gen3c_tpu_torch.training.train import build_net
from gen3c_tpu_torch.training import train_step as tts

torch.set_num_threads(2)
LR = 1e-3


def _assert_frames_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (diff <= 1).mean() >= 0.999, (diff.max(), (diff > 1).mean())


def _jparams(cfg, seed=0):
    """JAX's multiview init with every zero-init layer that gates the
    output drawn at random (the repeat-frame Linear too)."""
    p = randomize_degenerate_inits(jmv.init_multiview_dit_params(jax.random.PRNGKey(seed), cfg))
    if "repeat_frame_embedding" in p:
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed + 77))
        rf = p["repeat_frame_embedding"]
        p["repeat_frame_embedding"] = {"w": 0.5 * jax.random.normal(k1, rf["w"].shape),
                                       "b": 0.1 * jax.random.normal(k2, rf["b"].shape)}
    return p


def _port_net(cfg, jparams):
    with torch.device("meta"):
        net = tmv.MultiviewGeneralDIT(cfg)
    net = net.to_empty(device="cpu")
    net.load_state_dict(multiview_state_from_jax(jax.tree.map(np.asarray, jparams)))
    return net.eval()


_JM = {}


def _jax_tokenizer():
    """gen3c_tiny's fp32 JAX model: its tokenizer is the multiview tiny
    presets' (9-frame chunk)."""
    if "m" not in _JM:
        _JM["m"], _ = jfactory.build_gen3c_model("gen3c_tiny", checkpoint_dir=None, seed=0,
                                                 param_dtype=jnp.float32)
    return _JM["m"]


def _port_tokenizer(preset):
    tok = tfactory.build_tokenizer(
        dataclasses.replace(tfactory.GEN3C_TINY_PRESET, vae=preset.vae, height=preset.height,
                            width=preset.width, chunk_size=preset.num_video_frames), "cpu")
    tok.vae.load_state_dict(vae_state_from_jax(
        {k: np.asarray(v) for k, v in _jax_tokenizer().tokenizer.params.items()}))
    return tok


_PAIRS = {}


def _pair(name):
    """(JAX params, port MultiviewModel, JAX preset, port preset) of a tiny preset."""
    if name not in _PAIRS:
        jp, tp = jt.MV_PRESETS[name], tt.MV_PRESETS[name]
        params = _jparams(jp.dit)
        model = tt.MultiviewModel(net=_port_net(tp.dit, params), tokenizer=_port_tokenizer(tp))
        _PAIRS[name] = (params, model, jp, tp)
    return _PAIRS[name]


def _image(path, h, w, seed):
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (h // 8, w // 8, 3))
    Image.fromarray(np.repeat(np.repeat(coarse, 8, 0), 8, 1).astype(np.uint8)).save(path)


# ------------------------------ the DiT ------------------------------


@pytest.mark.parametrize("n,d,r", [(5, 22, 1.0), (30, 1366, 1.0), (53, 1364, 2.5), (1, 8, 3.0)])
def test_sincos_axis_emb_bit_equal(n, d, r):
    assert np.array_equal(tmv._sincos_axis_emb(n, d, r), jmv._sincos_axis_emb(n, d, r))


@pytest.mark.parametrize("args", [(64, 2, 4, 6), (4096, 8, 30, 53), (96, 3, 5, 7, 2.0, 1.5, 0.5)])
def test_multiview_sincos_extra_bit_equal(args):
    got = tmv._multiview_sincos_extra(*args)
    assert got.dtype == np.float64 and np.array_equal(got, jmv._multiview_sincos_extra(*args))


def test_presets_match_jax():
    assert list(tt.MV_PRESETS) == list(jt.MV_PRESETS)
    assert tt.VIEW_NAMES == jt.VIEW_NAMES and tt.DEFAULT_PROMPTS == jt.DEFAULT_PROMPTS
    for name, t in tt.MV_PRESETS.items():
        j = jt.MV_PRESETS[name]
        assert (t.height, t.width, t.num_video_frames, t.state_shape) == (
            j.height, j.width, j.num_video_frames, j.state_shape), name
        for f in ("in_channels", "model_channels", "num_blocks", "num_heads", "adaln_lora_dim",
                  "n_views", "view_condition_dim", "add_repeat_frame_embedding",
                  "concat_view_embedding", "concat_padding_mask", "patch_in_dim",
                  "rope_t_extrapolation_ratio", "extra_t_extrapolation_ratio"):
            assert getattr(t.dit, f) == getattr(j.dit, f), (name, f)
    mv7b = tt.MV_T2W_7B
    C, VT, Hl, Wl = mv7b.state_shape
    assert (mv7b.dit.num_blocks, mv7b.dit.model_channels, mv7b.dit.dtype) == (
        28, 4096, torch.bfloat16)
    assert VT * (Hl // 2) * (Wl // 2) == 76_320  # 6 views x 8 x 30 x 53


@pytest.mark.parametrize("name", ["cosmos_t2w_mv_tiny", "cosmos_v2w_mv_tiny"])
@pytest.mark.parametrize("frame_repeat,padding_mask", [(False, False), (True, False),
                                                      (True, True)])
def test_forward_matches_jax(name, frame_repeat, padding_mask):
    params, model, jp, _ = _pair(name)
    rng = np.random.default_rng(3)
    C, VT, H, W = jp.dit.in_channels, jp.state_shape[1], jp.state_shape[2], jp.state_shape[3]
    x = rng.standard_normal((2, C, VT, H, W)).astype(np.float32)
    t = np.array([0.3, 1.7], np.float32)
    ctx = rng.standard_normal((2, 3 * 7, 1024)).astype(np.float32)
    kw = {}
    if frame_repeat:
        kw["frame_repeat"] = np.array([[0.0, 0.0, 0.0], [1.0, 0.5, 1.0]], np.float32)
    if padding_mask:
        kw["padding_mask"] = (rng.uniform(size=(2, H, W)) > 0.5).astype(np.float32)
    want = np.asarray(jmv.multiview_dit_forward(
        params, jp.dit, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), fps=24.0,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    with torch.no_grad():
        got = model.net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                        fps=24.0, **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    assert got.shape == want.shape == (2, 16, VT, H, W)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if frame_repeat:  # the repeat-frame embedding reaches the output
        with torch.no_grad():
            plain = model.net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                              fps=24.0).numpy()
        assert np.abs(plain[1] - got[1]).max() > 1e-3


# tests/test_multiview_dit.py's config, on the port's net
TINY_MV = tmv.MultiviewDiTConfig(max_img_h=16, max_img_w=16, max_frames=8, in_channels=16,
                                 out_channels=16, model_channels=96, num_blocks=2, num_heads=4,
                                 crossattn_emb_channels=32, adaln_lora_dim=8, n_views=3,
                                 view_condition_dim=4, add_repeat_frame_embedding=True,
                                 dtype=torch.float32)


def test_multiview_forward_shape():
    net = build_net(TINY_MV, "cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    B, V, T, H, W = 1, 3, 2, 8, 8
    x = torch.randn((B, 16, V * T, H, W), generator=g)
    ctx = torch.randn((B, V * 4, 32), generator=g)
    with torch.no_grad():
        out = net(x, torch.tensor([0.5]), ctx, fps=24.0)
    assert out.shape == (B, 16, V * T, H, W)
    assert torch.isfinite(out).all()


def test_view_embedding_differentiates_views():
    """Identical per-view inputs give different outputs per view: the view
    embedding breaks the symmetry."""
    net = build_net(TINY_MV, "cpu", seed=3)
    net.randomize_degenerate_inits(torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(4)
    B, V, T, H, W = 1, 3, 2, 8, 8
    x = torch.randn((B, 16, T, H, W), generator=g).repeat(1, 1, V, 1, 1)
    ctx = torch.randn((B, 4, 32), generator=g).repeat(1, V, 1)
    with torch.no_grad():
        out = net(x, torch.tensor([1.0]), ctx, fps=24.0)
    assert (out[:, :, :T] - out[:, :, T:2 * T]).abs().max() > 1e-6


def test_context_that_does_not_split_into_views_is_refused():
    """A context of 512 tokens at V = 3 (MultiviewClipDataset's zeros
    without a .t5.npy): gen3c_tpu's reshape fails, the port refuses it."""
    params, model, jp, _ = _pair("cosmos_t2w_mv_tiny")
    x = np.zeros((1, 16) + jp.state_shape[1:], np.float32)
    ctx = np.zeros((1, 512, 1024), np.float32)
    with pytest.raises((TypeError, ValueError)):
        jmv.multiview_dit_forward(params, jp.dit, jnp.asarray(x), jnp.ones((1,)),
                                  jnp.asarray(ctx), fps=24.0)
    with pytest.raises(ValueError, match="does not split into 3 views"):
        model.net(torch.from_numpy(x), torch.ones(1), torch.from_numpy(ctx), fps=24.0)


# ------------------------------ conversion and loading ------------------------------


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def test_convert_multiview_state_dict_bit_equal():
    """A Sample-AV-named state dict ("net." prefixes, a TE _extra_state and
    a logvar key to skip) through both converters: every leaf equal; and
    into the port's net through dit_state_for_net, the weights back."""
    net = build_net(tt.MV_V2W_TINY.dit, "cpu", seed=5)
    net.randomize_degenerate_inits(torch.Generator().manual_seed(6))
    sd = {f"net.{k}": v.clone() for k, v in net.state_dict().items()}
    sd["net.blocks.block0.blocks.0.block.attn.to_q.0._extra_state"] = torch.zeros(3)
    sd["logvar.0.freqs"] = torch.ones(128)
    want = jconvert.convert_multiview_dit_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jt.MV_V2W_TINY.dit)
    got = tconvert.convert_multiview_dit_state_dict(sd, tt.MV_V2W_TINY.dit)
    fw, fg = _flat(want), _flat(jax.tree.map(lambda t: t.numpy(), got))
    assert sorted(fw) == sorted(fg)
    for k in fw:
        assert fw[k].dtype == fg[k].dtype and np.array_equal(fw[k], fg[k]), k
    with torch.device("meta"):
        other = tmv.MultiviewGeneralDIT(tt.MV_V2W_TINY.dit)
    other = other.to_empty(device="cpu")
    other.load_state_dict(tconvert.dit_state_for_net(sd, other.state_dict().keys()))
    for k, v in net.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    # and gen3c_tpu's tree carries back to the same net
    back = multiview_state_from_jax(jax.tree.map(np.asarray, want))
    assert set(back) == set(net.state_dict())
    for k, v in back.items():
        assert torch.equal(torch.as_tensor(v), net.state_dict()[k]), k


def test_npz_checkpoint_loads(tmp_path):
    """``<checkpoint_dir>/gen3c_tpu/<preset>.npz`` written by gen3c_tpu
    loads into the port's net bit for bit (fp32 and bf16 nets)."""
    params, _, _, tp = _pair("cosmos_t2w_mv_tiny")
    os.makedirs(tmp_path / "gen3c_tpu")
    save_params_npz(str(tmp_path / "gen3c_tpu" / "cosmos_t2w_mv_tiny.npz"), params)
    want = multiview_state_from_jax(jax.tree.map(np.asarray, params))
    model = tt.build_model(tp, "cpu", seed=9, checkpoint_dir=str(tmp_path))
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, want[k]), k
    bf16 = dataclasses.replace(tp, dit=dataclasses.replace(tp.dit, dtype=torch.bfloat16))
    model = tt.build_model(bf16, "cpu", checkpoint_dir=str(tmp_path))
    for k, v in model.net.state_dict().items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, want[k].to(torch.bfloat16)), k


# ------------------------------ generation ------------------------------


@pytest.mark.parametrize("name", ["cosmos_t2w_mv_tiny", "cosmos_v2w_mv_tiny"])
def test_generate_multiview_world_matches_jax(name):
    params, model, jp, tp = _pair(name)
    jm = _jax_tokenizer()
    rng = np.random.default_rng(1)
    t5 = rng.standard_normal((1, 3 * 512, 1024)).astype(np.float32)
    jcl = tcl = None
    if name.startswith("cosmos_v2w"):
        img = rng.uniform(-1, 1, (1, 3, 1, jp.height, jp.width)).astype(np.float32)
        pad = np.concatenate([img] + [np.zeros_like(img)] * (jp.num_video_frames - 1), axis=2)
        jcl = jm.encode(jnp.asarray(pad))
        tcl = model.encode(torch.from_numpy(pad))
        np.testing.assert_allclose(tcl.numpy(), np.asarray(jcl), atol=1e-4, rtol=0)
    kw = dict(guidance=3.0, num_steps=3, seed=5, frame_repeat_negative_condition=10.0)
    jlat = []

    def jdecode(lat):
        jlat.append(np.asarray(lat))
        return jm.decode(lat)

    want = jt.generate_multiview_world(params, jdecode, jp, t5, condition_latent=jcl, **kw)
    steps, record = [], {}
    got = tt.generate_multiview_world(model, tp, t5, condition_latent=tcl,
                                      on_step=lambda *a: steps.append(a), record=record, **kw)
    assert len(steps) == 3 and all(cfg for _, cfg, _ in steps)
    Tl = tp.state_shape[1] // 3
    lat = record["latent"].numpy()
    np.testing.assert_allclose(lat, np.concatenate(jlat, axis=2), atol=1e-4, rtol=0)
    if tcl is not None:  # every view's first latent frame follows the seed image
        for v in range(3):
            assert np.abs(lat[:, :, v * Tl] - tcl.numpy()[:, :, 0]).max() < 0.05
    assert len(got) == len(want) == 3 and len(record["decode_seconds"]) == 3
    for g, w in zip(got, want):
        assert g.shape == (tp.num_video_frames, tp.height, tp.width, 3)
        _assert_frames_close(g, w)


def _argv(tmp_path, name, *extra):
    return ["--model_preset", name, "--num_steps", "2", "--guidance", "7",
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--video_save_folder",
            str(tmp_path / "out"), "--prompt_left", "a left view", *extra]


@pytest.mark.parametrize("mode", ["text2world", "video2world"])
def test_cli_matches_jax(tmp_path, monkeypatch, mode):
    """Both CLIs load the same DiT from <checkpoint_dir>/gen3c_tpu/<preset>.npz
    and share the tokenizer; the views they save agree."""
    name = "cosmos_t2w_mv_tiny" if mode == "text2world" else "cosmos_v2w_mv_tiny"
    params, model, jp, tp = _pair(name)
    os.makedirs(tmp_path / "ckpt" / "gen3c_tpu")
    save_params_npz(str(tmp_path / "ckpt" / "gen3c_tpu" / f"{name}.npz"), params)
    argv = _argv(tmp_path, "cosmos_t2w_mv_tiny", "--mode", mode)
    if mode == "video2world":
        _image(tmp_path / "seed.png", jp.height, jp.width, 3)
        argv += ["--input_image_path", str(tmp_path / "seed.png")]
    jm = _jax_tokenizer()
    monkeypatch.setattr(jfactory, "build_tokenizer", lambda *a, **kw: (
        types.SimpleNamespace(encode=jm.encode, decode=jm.decode), None))
    saved = []
    monkeypatch.setattr(jio, "save_video",
                        lambda video, fps, path, *a, **kw: saved.append(np.asarray(video)) or path)
    jt.demo(jt.create_parser().parse_args(argv))
    built = tt.build_model(tp, "cpu", checkpoint_dir=str(tmp_path / "ckpt"))
    built.tokenizer = model.tokenizer
    record = {}
    paths = tt.demo(tt.create_parser().parse_args(argv + ["--device", "cpu"]), built=built,
                    record=record)
    assert len(paths) == len(saved) == 3
    assert all(os.path.exists(p) or os.path.isdir(os.path.splitext(p)[0]) for p in paths)
    assert [s["cfg"] for s in record["steps"]] == [True, True]
    for got, want in zip(record["videos"], saved):
        _assert_frames_close(got, want)


def test_cli_runs_on_the_cpu_with_seeded_weights(tmp_path):
    """``python -m gen3c_tpu_torch.pipelines.text2world_multiview`` on the
    tiny preset with no checkpoint: seeded weights, one video a view."""
    paths = tt.main(_argv(tmp_path, "cosmos_t2w_mv_tiny", "--device", "cpu"))
    assert [os.path.basename(os.path.splitext(p)[0]) for p in paths] == [
        "multiview_front", "multiview_left", "multiview_right"]


def test_guidance_interval_that_leaves_a_step_out_is_refused():
    """gen3c_tpu fails inside its first condition-only step (the 2-row
    frame_repeat against batch 1); the port refuses before any forward."""
    params, model, jp, tp = _pair("cosmos_t2w_mv_tiny")
    t5 = np.zeros((1, 3 * 512, 1024), np.float32)
    kw = dict(guidance=7.0, num_steps=4, guidance_interval=(0.5, 10.0))
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        jt.generate_multiview_world(params, _jax_tokenizer().decode, jp, t5, **kw)
    calls = []
    orig = model.net.forward
    model.net.forward = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        with pytest.raises(ValueError, match="guidance_interval"):
            tt.generate_multiview_world(model, tp, t5, **kw)
    finally:
        del model.net.forward
    assert calls == []
    # an interval that holds every step's sigma is the plain loop
    tt.generate_multiview_world(model, tp, t5, guidance=7.0, num_steps=2,
                                guidance_interval=(0.0, 1e4))


def test_cli_defaults_to_the_card():
    args = tt.create_parser().parse_args([])
    assert args.device == "cuda" and args.model_preset == "cosmos_t2w_mv_7b"
    assert args.disable_prompt_encoder


# ------------------------------ training ------------------------------


def _mv_batch(seed, B=2, V=3, T=2, H=4, W=6, M=4):
    rng = np.random.default_rng(seed)
    return {"x0": rng.standard_normal((B, 16, V * T, H, W)).astype(np.float32),
            "crossattn_emb": rng.standard_normal((B, V * M, 1024)).astype(np.float32),
            "extra_channels": rng.standard_normal((B, 1, V * T, H, W)).astype(np.float32)}


def _jax_draws(rng, x0_shape, n_views):
    """gen3c_tpu train_step's draws (video_extend, first_random_n_max 1)."""
    k_sigma, k_noise, _, k_ind, k_aug_s, k_aug_n = jax.random.split(rng, 6)
    Bx, _, VT = x0_shape[:3]
    return tts.StepDraws(
        sigma=torch.from_numpy(np.array(jlosses.sample_sigma(k_sigma, Bx))),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, x0_shape, jnp.float32))),
        indicator=torch.from_numpy(np.array(jlosses.sample_condition_indicator(
            k_ind, Bx, VT // n_views, n_min=0, n_max=1, n_views=n_views))),
        augment_sigma=torch.from_numpy(np.array(jlosses.sample_sigma(k_aug_s, Bx))),
        augment_noise=torch.from_numpy(np.array(
            jax.random.normal(k_aug_n, x0_shape, jnp.float32))))


def test_multiview_loss_and_grads_match_jax():
    """The EDM loss through gen3c_tpu's ``_net`` (its multiview branch,
    whole-net remat) and the port's (per-block remat), video-extend
    conditioning with the per-view indicator; every gradient by name (the
    learnable extra position slots, which the port's net lacks, get none
    in JAX)."""
    jp = jt.MV_V2W_TINY
    params = _jparams(jp.dit, seed=2)
    net = _port_net(tt.MV_V2W_TINY.dit, params).requires_grad_(True)
    batch = _mv_batch(1)
    d = _jax_draws(jax.random.PRNGKey(3), batch["x0"].shape, 3)
    ind = d.indicator.numpy()
    assert ind.shape == (2, 1, 6, 1, 1) and np.array_equal(ind[:, :, :2], ind[:, :, 2:4])
    extra = np.concatenate([np.broadcast_to(ind, (2, 1, 6, 4, 6)), batch["extra_channels"][:, 1:]],
                           axis=1).astype(np.float32)

    def jloss(p):
        return jlosses.edm_loss(
            jts._net, (p, jp.dit, True, None), jnp.asarray(batch["x0"]),
            jnp.asarray(d.sigma.numpy()), jnp.asarray(d.noise.numpy()),
            jnp.asarray(batch["crossattn_emb"]), jnp.asarray(extra),
            condition_video_indicator=jnp.asarray(ind),
            augment_sigma=jnp.asarray(d.augment_sigma.numpy() * 4.0),
            augment_noise=jnp.asarray(d.augment_noise.numpy()))

    (want, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    loss, grads, _ = tts.loss_and_grads(
        net, {k: torch.from_numpy(v) for k, v in batch.items()}, None, tt.MV_V2W_TINY.dit,
        remat=True, video_extend=True, first_random_n_max=1, draws=d)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    jg = jax.tree.map(np.asarray, jgrads)
    assert all(np.abs(v).max() == 0 for v in jg["extra_pos_emb"].values())
    want_grads = multiview_state_from_jax(jg)
    assert set(grads) == set(want_grads)
    for n, w in want_grads.items():
        err = (grads[n].double() - w.double()).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (n, err)
    assert grads["view_embeddings.weight"].abs().max() > 0
    assert grads["repeat_frame_embedding.weight"].abs().max() == 0  # no frame_repeat in training


def test_multiview_train_step_matches_jax():
    """Two jitted gen3c_tpu train_steps (whole-net remat) against the
    port's (per-block remat): loss and grad-norm per step, then the params
    by name (warmup 1: the first update has lr 0, the second moves them)."""
    jp = jt.MV_V2W_TINY
    params = _jparams(jp.dit, seed=4)
    net = _port_net(tt.MV_V2W_TINY.dit, params)
    kw = dict(remat=True, video_extend=True, first_random_n_max=1)
    jopt = jts.make_optimizer(lr=LR, grad_clip=0.5, warmup_steps=1)
    jstate = jts.init_train_state(params, jopt)
    jstep = jax.jit(partial(jts.train_step, cfg=jp.dit, optimizer=jopt, **kw))
    opt = tts.make_optimizer(lr=LR, grad_clip=0.5, warmup_steps=1)
    state = tts.init_train_state(net, opt)
    for i in range(2):
        batch = _mv_batch(7 + i)
        rng = jax.random.PRNGKey(11 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        state, m = tts.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  None, tt.MV_V2W_TINY.dit, opt,
                                  draws=_jax_draws(rng, batch["x0"].shape, 3), **kw)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = train_params_from_jax(jax.tree.map(np.asarray, jstate.params))
    before = multiview_state_from_jax(jax.tree.map(np.asarray, params))
    assert max((want[n] - before[n]).abs().max().item() for n in want) > 0.5 * LR
    for n, p in net.named_parameters():
        assert (p.detach() - want[n]).abs().max().item() <= 0.05 * LR, n


# ------------------------------ datasets ------------------------------


@pytest.fixture(scope="module")
def gen3c_pair():
    """gen3c_tiny in both packages on the same VAE (the datasets' encoder)."""
    jm = _jax_tokenizer()
    tm, preset = tfactory.build_gen3c_model("gen3c_tiny", device="cpu", seed=0)
    tm.tokenizer.vae.load_state_dict(
        vae_state_from_jax({k: np.asarray(v) for k, v in jm.tokenizer.params.items()}))
    return jm, tm, preset


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("num_condition_t,batch_size", [(0, 2), (1, 1)])
def test_video_clip_dataset_matches_jax(tmp_path, gen3c_pair, num_condition_t, batch_size):
    jm, tm, preset = gen3c_pair
    h, w, chunk = preset.height, preset.width, preset.chunk_size
    rng = np.random.RandomState(0)
    np.savez(tmp_path / "vid0.npz", video=(rng.rand(chunk + 3, 3, h, w) * 2 - 1).astype(np.float32))
    np.savez(tmp_path / "vid1.npz",  # 0-255, frames last
             video=(rng.rand(chunk + 1, h, w, 3) * 255).astype(np.float32))
    np.save(tmp_path / "vid0.t5.npy", rng.rand(512, 1024).astype(np.float32))
    jit = iter(jds.VideoClipDataset(str(tmp_path), jm, batch_size, num_condition_t=num_condition_t))
    tit = iter(tds.VideoClipDataset(str(tmp_path), tm, batch_size, num_condition_t=num_condition_t))
    for _ in range(3):
        want, got = next(jit), next(tit)
        _close(got, want)
    C, T, Hl, Wl = preset.state_shape
    assert got["extra_channels"].shape == (batch_size, 1 if num_condition_t else 0, T, Hl, Wl)


def test_multiview_clip_dataset_matches_jax(tmp_path, gen3c_pair):
    """Views stacked on latent T; with a .t5.npy the context is the views'
    prompts, without one (1, 512, 1024) zeros: at V = 3 neither package's
    multiview forward takes that (test_context_that_does_not_split...)."""
    jm, tm, preset = gen3c_pair
    h, w, chunk = preset.height, preset.width, preset.chunk_size
    rng = np.random.RandomState(0)
    V = 3
    np.savez(tmp_path / "mv0.npz",
             videos=(rng.rand(V, chunk + 2, 3, h, w) * 2 - 1).astype(np.float32))
    for with_t5 in (True, False):
        if with_t5:
            np.save(tmp_path / "mv0.t5.npy", rng.rand(V * 512, 1024).astype(np.float32))
        elif os.path.exists(tmp_path / "mv0.t5.npy"):
            os.remove(tmp_path / "mv0.t5.npy")
        want = next(iter(jds.MultiviewClipDataset(str(tmp_path), jm, n_views=V)))
        got = next(iter(tds.MultiviewClipDataset(str(tmp_path), tm, n_views=V)))
        _close(got, want)
        C, T, Hl, Wl = preset.state_shape
        assert got["x0"].shape == (1, C, V * T, Hl, Wl)
        assert got["crossattn_emb"].shape == ((1, V * 512, 1024) if with_t5 else (1, 512, 1024))
