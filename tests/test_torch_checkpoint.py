"""Checkpoint loading (utils/checkpoint.py, models/convert.py, the factory)
against gen3c_tpu's on the CPU, and the single-image slice end to end.

Every checkpoint form ``build_gen3c_model`` reads is written from seeded
weights by the JAX package's own writers (``save_params_npz``,
``quantize_dit_params_numpy``; ``vae.npz`` as scripts/convert_checkpoints.py
writes it, ``np.savez`` of the reference names), or, for the reference's
torch forms, by torch: a ``model.pt`` with the {"model", "ema"} wrappers,
"-"-mangled EMA keys, TransformerEngine ``_extra_state`` entries (a BytesIO,
so ``weights_only`` refuses the file and the full pickle is read), a
``logvar`` head and RoPE buffers; and a TorchScript tokenizer traced from
the port's tiny VAE with a ``mean_std.pt``. Both packages load each file;
the loaded weights must be bit-equal and the outputs equal within the
port's fp32 tolerances (DiT rtol / atol 1e-4, VAE atol 1e-4, W8A8 DiT max
1e-2 / mean 3e-4: tests/test_torch_dit.py, test_torch_vae.py,
test_torch_quantize.py).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gen3c_tpu.models.quantize as jq
import gen3c_tpu_torch.models.quantize as tq
from gen3c_tpu.models import dit as jdit
from gen3c_tpu.models import vae as jvae
from gen3c_tpu.models.convert import convert_logvar_state_dict as jax_logvar
from gen3c_tpu.pipelines import factory as jfactory
from gen3c_tpu.utils import checkpoint as jckpt
from gen3c_tpu_torch.bridge import dit_state_from_jax
from gen3c_tpu_torch.models import convert
from gen3c_tpu_torch.pipelines import factory as tfactory
from gen3c_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_pipeline import _assert_frames_close, shared_scale_map  # noqa: F401

torch.set_num_threads(2)

PRESET = jfactory.GEN3C_TINY_PRESET


@pytest.fixture(scope="module")
def weights():
    """(DiT tree, VAE flat params), numpy: gen3c_tpu's tiny init with the
    zero-init gates randomised and the VAE's biases and norms perturbed."""
    tree = jax.tree.map(np.asarray, jdit.randomize_degenerate_inits(
        jdit.init_dit_params(jax.random.PRNGKey(0), PRESET.dit, jnp.float32)))
    rng = np.random.default_rng(0)
    vae = {k: np.asarray(v) + (0.05 * rng.standard_normal(v.shape).astype(np.float32)
                               if k.endswith(("bias", "norm.weight")) else 0)
           for k, v in jvae.init_vae_params(jax.random.PRNGKey(1), PRESET.vae).items()}
    return tree, {k: v.astype(np.float32) for k, v in vae.items()}


def _builds(ckpt_dir, quantize=False):
    """Both factories on one checkpoint directory (JAX in fp32, as the
    port's tiny preset keeps its weights)."""
    jmodel, _ = jfactory.build_gen3c_model("gen3c_tiny", checkpoint_dir=ckpt_dir, seed=0,
                                           param_dtype=jnp.float32, quantize=quantize)
    tmodel, _ = tfactory.build_gen3c_model("gen3c_tiny", device="cpu", seed=0,
                                           checkpoint_dir=ckpt_dir, quantize=quantize)
    return jmodel, tmodel


def _assert_dit_bits(jtree, net):
    want = dit_state_from_jax(jax.tree.map(np.asarray, jtree))
    got = net.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _dit_outputs(jtree, net):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, PRESET.dit.in_channels, 3, 12, 20)).astype(np.float32)
    t = rng.uniform(-2, 1, (2,)).astype(np.float32)
    ctx = rng.standard_normal((2, 512, 1024)).astype(np.float32)
    want = np.asarray(jax.jit(jdit.dit_forward, static_argnames=("cfg", "fps"))(
        jax.tree.map(jnp.asarray, jtree), PRESET.dit, jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(ctx), fps=24.0))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), fps=24.0)
    assert np.abs(want).max() > 1e-2
    return got.numpy(), want


def _reference_checkpoint(tree, legacy_patch=False, ema_offset=0.25):
    """A reference-layout model.pt dict from a JAX tree."""
    sd = {f"net.{k}": v for k, v in dit_state_from_jax(tree).items()}
    if legacy_patch:  # the Conv3d patch embedding of the training net
        w = sd.pop("net.x_embedder.proj.1.weight")
        sd["net.x_embedder.proj.weight"] = w.reshape(w.shape[0], -1, 1, 2, 2)
    model = dict(sd)
    model["net.blocks.block0.blocks.0.block.attn._extra_state"] = io.BytesIO(b"fp8 meta")
    model["net.pos_embedder.seq"] = torch.arange(128.0)
    rng = np.random.default_rng(1)
    model["logvar.0.freqs"] = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    model["logvar.0.phases"] = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    model["logvar.1.weight"] = torch.from_numpy(rng.standard_normal((1, 128)).astype(np.float32))
    ema = {k.replace(".", "-"): v + ema_offset for k, v in sd.items()}
    return {"model": model, "ema": ema}


@pytest.mark.parametrize("legacy_patch", [False, True])
def test_model_pt_loads_bit_equal(weights, tmp_path, legacy_patch):
    tree, _ = weights
    path = tmp_path / "GEN3C-Cosmos-7B" / "model.pt"
    path.parent.mkdir()
    ckpt = _reference_checkpoint(tree, legacy_patch)
    torch.save(ckpt, path)
    with pytest.raises(Exception):  # the BytesIO needs the full pickle
        torch.load(path, weights_only=True)
    jmodel, tmodel = _builds(str(tmp_path))
    _assert_dit_bits(jmodel.dit_params, tmodel.net)
    _assert_dit_bits(tree, tmodel.net)  # the weights saved, not the EMA
    got, want = _dit_outputs(jmodel.dit_params, tmodel.net)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the EMA weights, de-mangled, as JAX's use_ema
    jema = jckpt.load_torch_dit_checkpoint(str(path), PRESET.dit, dtype=jnp.float32, use_ema=True)
    tema = convert.dit_state_for_net(tckpt.load_torch_dit_checkpoint(str(path), use_ema=True),
                                     tmodel.net.state_dict().keys())
    for k, v in dit_state_from_jax(jax.tree.map(np.asarray, jema)).items():
        assert torch.equal(tema[k].float(), v), k
    # the logvar head both converters extract
    jl = jax_logvar(ckpt["model"])
    tl = convert.convert_logvar_state_dict(ckpt["model"])
    for k in ("freqs", "phases", "w"):
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
    assert convert.convert_logvar_state_dict({"net.x": torch.zeros(1)}) is None


def test_model_pt_stray_key_raises_in_both(weights, tmp_path):
    tree, _ = weights
    path = tmp_path / "GEN3C-Cosmos-7B" / "model.pt"
    path.parent.mkdir()
    ckpt = _reference_checkpoint(tree)
    ckpt["model"]["net.blocks.block0.blocks.0.block.attn.to_z.0.weight"] = torch.zeros(2, 2)
    torch.save(ckpt, path)
    with pytest.raises(ValueError, match="unconsumed checkpoint keys"):
        jckpt.load_torch_dit_checkpoint(str(path), PRESET.dit, dtype=jnp.float32)
    with pytest.raises(ValueError, match="unconsumed checkpoint keys.*to_z"):
        tfactory.build_gen3c_model("gen3c_tiny", device="cpu", checkpoint_dir=str(tmp_path))
    # a missing parameter raises too
    del ckpt["model"]["net.blocks.block0.blocks.0.block.attn.to_z.0.weight"]
    del ckpt["model"]["net.final_layer.linear.weight"]
    torch.save(ckpt, path)
    with pytest.raises(RuntimeError, match="final_layer.linear.weight"):
        tfactory.build_gen3c_model("gen3c_tiny", device="cpu", checkpoint_dir=str(tmp_path))


def test_convert_dit_state_dict_matches_jax(weights):
    """The port's convert_dit_state_dict builds JAX's tree from the reference
    names (what save_params_npz writes as dit.npz)."""
    from gen3c_tpu.models.convert import convert_dit_state_dict as jax_convert

    tree, _ = weights
    sd = _reference_checkpoint(tree, legacy_patch=True)["model"]
    want = jax.tree_util.tree_leaves_with_path(jax_convert(
        {k: np.asarray(v) for k, v in sd.items() if not isinstance(v, io.BytesIO)},
        PRESET.dit, strict=True))
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.convert_dit_state_dict(sd, PRESET.dit, strict=True)))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(leaf), err_msg=str(path))
    with pytest.raises(ValueError, match="unconsumed"):
        convert.convert_dit_state_dict({**sd, "net.stray": torch.zeros(1)}, PRESET.dit,
                                       strict=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dit_npz_loads_bit_equal_and_saves_the_same_file(weights, tmp_path, dtype):
    tree, _ = weights
    jtree = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), tree)
    jckpt.save_params_npz(str(tmp_path / "gen3c_tpu" / "dit.npz"), jtree)
    jmodel, tmodel = _builds(str(tmp_path))
    _assert_dit_bits(jmodel.dit_params, tmodel.net)
    got, want = _dit_outputs(jmodel.dit_params, tmodel.net)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the port's writer: the same names, dtypes and bytes as JAX's
    ttree = convert.convert_dit_state_dict(
        {k: v.to(getattr(torch, dtype)) for k, v in tmodel.net.state_dict().items()},
        PRESET.dit, dtype=getattr(torch, dtype))
    tckpt.save_params_npz(str(tmp_path / "port.npz"), ttree)
    ours, theirs = np.load(tmp_path / "port.npz"), np.load(tmp_path / "gen3c_tpu" / "dit.npz")
    assert ours.files == theirs.files
    for name in theirs.files:
        assert ours[name].dtype == theirs[name].dtype, name
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    # and the template-driven loader
    like = jax.tree.map(torch.from_numpy, tree)
    loaded = tckpt.load_params_npz(str(tmp_path / "port.npz"), like, torch.float32)
    for (path, leaf), (_, want_leaf) in zip(jax.tree_util.tree_leaves_with_path(loaded),
                                            jax.tree_util.tree_leaves_with_path(jmodel.dit_params)):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want_leaf), err_msg=str(path))


def test_prequantized_w8a8_npz_loads_bit_equal(weights, tmp_path, monkeypatch):
    monkeypatch.setattr(jq, "_MIN_SIZE", 1)
    monkeypatch.setattr(tq, "_MIN_SIZE", 1)
    tree, _ = weights
    qtree = jq.quantize_dit_params_numpy(tree, act_quant=True)
    assert "q8" in qtree["blocks"][0]["mlp"]["fc1"]
    jckpt.save_params_npz(str(tmp_path / "gen3c_tpu" / "dit_w8a8.npz"), qtree)
    jmodel, tmodel = _builds(str(tmp_path), quantize="w8a8")
    fc1 = tmodel.net.blocks["block0"].blocks[2].block.layer1
    assert isinstance(fc1, tq.QuantLinear) and fc1.act_quant and fc1.weight.dtype == torch.int8
    _assert_dit_bits(jmodel.dit_params, tmodel.net)
    got, want = _dit_outputs(jmodel.dit_params, tmodel.net)
    err = np.abs(got - want)
    assert err.max() <= 1e-2 and err.mean() <= 3e-4, (err.max(), err.mean())


def test_vae_npz_loads_bit_equal(weights, tmp_path):
    _, vae = weights
    (tmp_path / "gen3c_tpu").mkdir()
    np.savez(tmp_path / "gen3c_tpu" / "vae.npz", **vae)
    jmodel, tmodel = _builds(str(tmp_path))
    got = tmodel.tokenizer.vae.state_dict()
    assert set(got) == set(jmodel.tokenizer.params)
    for k, v in jmodel.tokenizer.params.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


class _Part(torch.nn.Module):
    """One half of the tokenizer as a TorchScript archive holds it: the
    reference's submodules under their own names (and a wavelet buffer with
    no parameter, as the reference's patcher keeps one)."""

    def __init__(self, vae, names, encode):
        super().__init__()
        for name in names:
            self.add_module(name, getattr(vae, name))
        self.patcher = torch.nn.Module()
        self.patcher.register_buffer("wavelets", torch.ones(2))
        self.vae, self.encode = [vae], encode

    def forward(self, x):
        vae = self.vae[0]
        return vae.encode(x) if self.encode else vae.decode(x)


def test_torchscript_tokenizer_loads_bit_equal(weights, tmp_path):
    """encoder.jit / decoder.jit traced from the port's tiny VAE with the
    shared weights, and mean_std.pt: the weights bit-equal, the latent
    statistics cut to the chunk's latent frames, encode and decode as
    JAX's."""
    from gen3c_tpu_torch.bridge import vae_state_from_jax
    from gen3c_tpu_torch.models.vae import CausalVAE

    _, vae_params = weights
    vae = CausalVAE(tfactory.GEN3C_TINY_PRESET.vae)
    vae.load_state_dict(vae_state_from_jax(vae_params))
    d = tmp_path / "Cosmos-Tokenize1-CV8x8x8-720p"
    d.mkdir()
    children = [n for n, _ in vae.named_children()]
    enc_names = [n for n in children if "decoder" not in n and n != "post_quant_conv"]
    video = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (1, 3, 9, 96, 160)).astype(np.float32))
    with torch.no_grad():
        enc = torch.jit.trace(_Part(vae, enc_names, True), video, check_trace=False)
        latent = vae.encode(video)
        dec = torch.jit.trace(_Part(vae, [n for n in children if n not in enc_names], False),
                              latent, check_trace=False)
    torch.jit.save(enc, str(d / "encoder.jit"))
    torch.jit.save(dec, str(d / "decoder.jit"))
    rng = np.random.default_rng(3)
    mean = torch.from_numpy(rng.standard_normal(16 * 3).astype(np.float32))
    std = torch.from_numpy(rng.uniform(0.5, 2.0, 16 * 3).astype(np.float32))
    torch.save((mean, std), d / "mean_std.pt")
    assert any("wavelets" in k for k in torch.jit.load(str(d / "encoder.jit")).state_dict())

    jmodel, tmodel = _builds(str(tmp_path))
    got = tmodel.tokenizer.vae.state_dict()
    assert set(got) == set(jmodel.tokenizer.params) == set(vae_params)
    for k, v in jmodel.tokenizer.params.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), vae_params[k], err_msg=k)
    for mine, theirs in ((tmodel.tokenizer.latent_mean, jmodel.tokenizer.latent_mean),
                         (tmodel.tokenizer.latent_std, jmodel.tokenizer.latent_std)):
        assert tuple(mine.shape) == (1, 16, 2, 1, 1)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    want = np.asarray(jmodel.tokenizer.encode(jnp.asarray(video.numpy())))
    mine = tmodel.tokenizer.encode(video)
    np.testing.assert_allclose(mine.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tmodel.tokenizer.decode(mine).numpy(),
                               np.asarray(jmodel.tokenizer.decode(jnp.asarray(want))),
                               atol=1e-4, rtol=0)


def test_npz_tree_roundtrip_keeps_bf16_bits(tmp_path):
    """The "::bf16" entries come back as bf16 tensors with the stored bits,
    every other leaf as the saved numpy array; lists and dicts rebuilt."""
    bits = torch.from_numpy(np.array([0x3F80, 0xFF80, 0x7FC1, 0x0001, 0x8000],
                                     np.uint16).view(np.int16))
    tree = {"a": [bits.view(torch.bfloat16), {"q8": torch.arange(6, dtype=torch.int8)}],
            "b": np.float32([1.5, -2.0])}
    tckpt.save_params_npz(str(tmp_path / "t.npz"), tree)
    flat = jckpt.load_flat_npz(str(tmp_path / "t.npz"))  # JAX's reader on the port's file
    assert sorted(flat) == ["['a']/[0]", "['a']/[1]/['q8']", "['b']"]
    back = tckpt.load_params_npz_tree(str(tmp_path / "t.npz"))
    assert back["a"][0].dtype == torch.bfloat16
    assert torch.equal(back["a"][0].view(torch.int16), bits)
    np.testing.assert_array_equal(back["a"][1]["q8"], np.arange(6, dtype=np.int8))
    np.testing.assert_array_equal(back["b"], tree["b"])
    np.testing.assert_array_equal(np.asarray(flat["['a']/[0]"]).view(np.uint16),
                                  bits.numpy().view(np.uint16))


def test_no_checkpoint_is_a_warned_random_init(tmp_path, caplog):
    import logging

    from gen3c_tpu_torch.utils import log

    logger = log.get_logger()
    logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING, logger=logger.name):
            tfactory.build_gen3c_model("gen3c_tiny", device="cpu", checkpoint_dir=str(tmp_path))
    finally:
        logger.propagate = False
    text = caplog.text
    assert "No DiT checkpoint found; RANDOM init" in text and "No VAE checkpoint found" in text
    caplog.clear()
    jckpt.save_params_npz(str(tmp_path / "gen3c_tpu" / "dit.npz"), jax.tree.map(
        np.asarray, jdit.init_dit_params(jax.random.PRNGKey(0), PRESET.dit, jnp.float32)))
    logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING, logger=logger.name):
            tfactory.build_gen3c_model("gen3c_tiny", device="cpu", checkpoint_dir=str(tmp_path))
    finally:
        logger.propagate = False
    assert "No DiT checkpoint" not in caplog.text and "No VAE checkpoint found" in caplog.text


def test_two_chunk_cli_from_checkpoints_with_moge_and_t5_matches_jax(
        weights, tmp_path, monkeypatch, shared_scale_map):
    """The slice as a whole: gen3c_single_image, 17 frames (two chunks) of
    the tiny preset, both CLIs loading the DiT and VAE from one
    --checkpoint_dir (dit.npz, vae.npz), their depth from a tiny MoGe
    (GEN3C_MOGE_CHECKPOINT: the JAX CLI's auto, the port's moge_jax) for
    the seed frame and between the chunks, and the prompts from a tiny
    T5 (d_model 1024) in <checkpoint_dir>/google-t5/t5-11b (the port's
    --enable_prompt_encoder; JAX's encoder handed the same directory).

    As in test_torch_pipeline's chain, the non-rigid depth fit is shared,
    the port's second chunk starts from JAX's last frame, and the MoGe
    focal / shift search is the stand-in of test_torch_moge (its choice
    is ill-conditioned on an untrained head)."""
    import huggingface_hub.constants
    import transformers.utils.hub

    from gen3c_tpu.aux import moge as jmoge
    from gen3c_tpu.models import t5 as jt5
    from gen3c_tpu.pipelines import gen3c_single_image as jcli
    from gen3c_tpu.pipelines.chunked import run_chunked_generation as jax_chunked
    from gen3c_tpu_torch.aux import moge as tmoge
    from gen3c_tpu_torch.pipelines import gen3c_single_image as tcli
    from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline
    from gen3c_tpu_torch.models.t5 import T5TextEncoder
    from tests.test_torch_moge import _fixed_recovery
    from tests.test_torch_t5 import _hf_model, _write_local_t5

    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(transformers.utils.hub, "_is_offline_mode", True)
    fits = shared_scale_map
    tree, vae = weights
    ckpt = tmp_path / "ckpt"
    jckpt.save_params_npz(str(ckpt / "gen3c_tpu" / "dit.npz"), tree)
    np.savez(ckpt / "gen3c_tpu" / "vae.npz", **vae)
    t5_dir, _ = _write_local_t5(str(ckpt), _hf_model(d_model=1024))
    moge_sd = {k: np.asarray(v) for k, v in
               jmoge.init_moge_params(jax.random.PRNGKey(3), jmoge.MOGE_TINY).items()}
    moge_sd["head.out.bias"] = np.array([0.0, 0.0, 2.0, 4.0], np.float32)
    np.savez(tmp_path / "moge.npz", **moge_sd)
    monkeypatch.setenv("GEN3C_MOGE_CHECKPOINT", str(tmp_path / "moge.npz"))
    monkeypatch.setattr(jmoge, "MOGE_VITL", jmoge.MOGE_TINY)
    monkeypatch.setattr(tmoge, "MOGE_VITL", tmoge.MOGE_TINY)
    depth_calls = []
    for mod, xp in ((jmoge, jnp), (tmoge, torch)):
        stand_in = _fixed_recovery(xp)
        monkeypatch.setattr(mod, "recover_focal_shift",
                            lambda p, m, f=stand_in, mod=mod: (depth_calls.append(mod), f(p, m))[1])
    real_build = jfactory.build_gen3c_model
    monkeypatch.setattr(jcli, "build_gen3c_model",
                        lambda *a, **kw: real_build(*a, param_dtype=jnp.float32, **kw))
    monkeypatch.setattr(jt5, "make_t5_encoder",
                        lambda backend: jt5.JaxT5TextEncoder(model_name=t5_dir))
    runs = {}

    def capture(name, inner):
        def run(*args, **kwargs):
            out = inner(*args, **kwargs)
            runs[name] = out[0].copy()
            return out
        return run

    import gen3c_tpu.pipelines.chunked as jchunked
    monkeypatch.setattr(jchunked, "run_chunked_generation", capture("jax", jax_chunked))
    monkeypatch.setattr(tcli, "run_chunked_generation", capture("port", tcli.run_chunked_generation))
    from PIL import Image

    Image.fromarray((np.random.default_rng(7).uniform(size=(96, 160, 3)) * 255)
                    .astype(np.uint8)).save(tmp_path / "in.png")
    argv = ["--input_image_path", str(tmp_path / "in.png"), "--model_preset", "gen3c_tiny",
            "--checkpoint_dir", str(ckpt), "--num_video_frames", "17", "--num_steps", "2",
            "--guidance", "2.0", "--prompt", "a red house on the hill",
            "--negative_prompt", "blue sky", "--enable_prompt_encoder",
            "--video_save_folder", str(tmp_path / "out")]
    jcli.demo(jcli.create_parser().parse_args(argv + ["--depth_source", "auto"]))
    want = runs["jax"]
    assert len(fits) == 1 and depth_calls == [jmoge]  # traced once, jitted

    generate = Gen3cPipeline.generate
    chunk1 = []

    def generate_then_align(self, *args, **kwargs):
        video, prompt = generate(self, *args, **kwargs)
        if not chunk1:
            chunk1.append(video.copy())
            video[-1] = want[8]  # same seed frame for chunk 2
        assert isinstance(self.text_encoder, T5TextEncoder)
        return video, prompt

    monkeypatch.setattr(Gen3cPipeline, "generate", generate_then_align)
    record = {}
    tcli.demo(tcli.create_parser().parse_args(argv + ["--depth_source", "moge_jax",
                                                      "--device", "cpu"]), record=record)
    got = runs["port"]
    assert not fits and depth_calls == [jmoge, tmoge, tmoge]  # the seed frame and chunk 2
    assert got.shape == want.shape == (17, 96, 160, 3)
    assert len(record["pipeline"]) == 2 and len(record["depth"]) == len(record["update"]) == 1
    assert record["pipeline"][0]["encode_prompt"] > 0 and record["seed_depth"] > 0
    _assert_frames_close(chunk1[0], want[:9])
    _assert_frames_close(got[9:], want[9:])

