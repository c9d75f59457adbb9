"""The port's sampler, pipeline, AR chain and CLI against gen3c_tpu on the CPU.

Both packages run the gen3c_tiny preset on the same weights: the JAX
factory's random init in fp32, with the zero-init AdaLN gates and final layer of
the DiT randomized (so the network's output matters), bridged into the
port. Latents are fp32 (atol 1e-4); video frames are compared as uint8,
where a value that lands within rounding of a level boundary may differ
by one, so |delta| <= 1 on at least 99.9% of the values.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.cache import Cache3DBuffer as JaxCache3DBuffer
from gen3c_tpu.diffusion import sampler as jsampler
from gen3c_tpu.models import gen3c as jgen3c
from gen3c_tpu.models.dit import randomize_degenerate_inits
from gen3c_tpu.ops.camera import generate_camera_trajectory as jax_trajectory
from gen3c_tpu.pipelines import factory as jfactory
from gen3c_tpu.pipelines.chunked import run_chunked_generation as jax_chunked
from gen3c_tpu.pipelines.depth import HeuristicDepthEstimator as JaxHeuristic
from gen3c_tpu.pipelines.gen3c_pipeline import Gen3cPipeline as JaxPipeline
from gen3c_tpu_torch.bridge import dit_state_from_jax, vae_state_from_jax
from gen3c_tpu_torch.cache import Cache3DBuffer
from gen3c_tpu_torch.diffusion import sampler as tsampler
from gen3c_tpu_torch.ops.camera import generate_camera_trajectory
from gen3c_tpu_torch.pipelines import factory as tfactory
from gen3c_tpu_torch.pipelines.chunked import run_chunked_generation
from gen3c_tpu_torch.pipelines.depth import HeuristicDepthEstimator
from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_frames_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (diff <= 1).mean() >= 0.999, (diff.max(), (diff > 1).mean())


@pytest.fixture(scope="module")
def models():
    # fp32 parameters, as the port's tiny preset keeps them (the JAX factory
    # defaults to bf16 storage, which rounds e.g. the summed position
    # embeddings)
    jmodel, preset = jfactory.build_gen3c_model("gen3c_tiny", checkpoint_dir=None, seed=0,
                                                param_dtype=jnp.float32)
    jmodel.dit_params = randomize_degenerate_inits(jmodel.dit_params)
    tmodel, _ = tfactory.build_gen3c_model("gen3c_tiny", device="cpu", seed=0)
    tmodel.net.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, jmodel.dit_params)))
    tmodel.tokenizer.vae.load_state_dict(
        vae_state_from_jax({k: np.asarray(v) for k, v in jmodel.tokenizer.params.items()}))
    return jmodel, tmodel, preset


def test_sampler_matches_jax(models):
    jmodel, tmodel, preset = models
    rng = np.random.default_rng(0)
    B = 1
    shape = (B,) + tuple(preset.state_shape)
    _, T, h, w = preset.state_shape
    arrays = dict(
        init_noise=rng.standard_normal(shape),
        augment_noise=rng.standard_normal(shape),
        crossattn_cond=rng.standard_normal((B, 512, 1024)),
        crossattn_uncond=np.zeros((B, 512, 1024)),
        gt_latent=rng.standard_normal(shape),
        condition_video_indicator=np.array([1.0, 0.0]).reshape(1, 1, T, 1, 1),
        condition_video_input_mask=np.broadcast_to(
            np.array([1.0, 0.0]).reshape(1, 1, T, 1, 1), (B, 1, T, h, w)),
        pose_latent_cond=rng.standard_normal((B, 64, T, h, w)),
        pose_latent_uncond=np.zeros((B, 64, T, h, w)),
    )
    arrays = {k: np.ascontiguousarray(v, np.float32) for k, v in arrays.items()}
    want = np.asarray(jsampler.generate_samples(
        jgen3c._dit_net_fn, (jmodel.dit_params, jmodel.dit_cfg),
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        num_steps=3, guidance=2.0))

    def net_fn(x, t, ctx):
        return tmodel.net(x, t, ctx, fps=24.0)

    got = tsampler.generate_samples(net_fn, **{k: torch.from_numpy(v) for k, v in arrays.items()},
                                    num_steps=3, guidance=2.0).numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_pipeline_generate_matches_jax(models):
    jmodel, tmodel, preset = models
    h, w, chunk = preset.height, preset.width, preset.chunk_size
    rng = np.random.default_rng(1)
    image = rng.uniform(-1, 1, (1, 3, 1, h, w)).astype(np.float32)
    warps = rng.uniform(-1, 1, (1, chunk, 2, 3, h, w)).astype(np.float32)
    masks = (rng.uniform(size=(1, chunk, 2, 1, h, w)) > 0.3).astype(np.float32)
    kw = dict(num_steps=3, guidance=2.0, seed=7)
    want, _ = JaxPipeline(model=jmodel, height=h, width=w, **kw).generate(
        "a scene", image, jnp.asarray(warps), jnp.asarray(masks))
    pipe = Gen3cPipeline(model=tmodel, **kw)
    got, prompt = pipe.generate("a scene", image, torch.from_numpy(warps),
                                torch.from_numpy(masks))
    assert prompt == "a scene" and got.shape == (chunk, h, w, 3)
    assert len(pipe.last_timings["denoise_steps"]) == 3
    _assert_frames_close(got, want)


@pytest.fixture
def shared_scale_map(monkeypatch):
    """Hand the port's non-rigid depth fit the JAX fit's output (see
    test_torch_geometry_cache.shared_scale_map: two correct 100-step Adam
    fits of an L1 objective differ by a few lr per pixel)."""
    import gen3c_tpu.ops.camera as jcam_mod
    import gen3c_tpu_torch.ops.camera as tcam_mod

    fits = []
    jax_fit = jcam_mod._nonrigid_scale_map

    def record(*args):
        out = jax_fit(*args)
        fits.append(np.asarray(out))
        return out

    monkeypatch.setattr(jcam_mod, "_nonrigid_scale_map", record)
    monkeypatch.setattr(tcam_mod, "_nonrigid_scale_map",
                        lambda *args: torch.from_numpy(fits.pop(0)))
    return fits


def test_two_chunk_chain_matches_jax(models, shared_scale_map):
    """17 frames = two 9-frame chunks: render, generate, depth of the last
    frame -> update_cache (non-rigid) -> re-render -> generate.

    The second chunk starts from the first chunk's last frame as uint8; a
    one-level flip there would change every later input, so the port's
    chain is given the JAX chain's last frame (after checking the chunks
    agree), and the non-rigid fit is shared (fixture)."""
    jmodel, tmodel, preset = models
    h, w = preset.height, preset.width
    rng = np.random.default_rng(2)
    image = rng.uniform(-1, 1, (1, 3, 1, h, w)).astype(np.float32)
    depth, k, _ = JaxHeuristic()((image[0, :, 0].transpose(1, 2, 0) + 1) / 2)
    w2c0 = np.eye(4, dtype=np.float32)
    common = dict(frame_buffer_max=2, noise_aug_strength=0.0, filter_points_threshold=0.05)
    jcache = JaxCache3DBuffer(input_image=jnp.asarray(image[:, :, 0]),
                              input_depth=jnp.asarray(depth[None, None]),
                              input_w2c=jnp.asarray(w2c0[None]),
                              input_intrinsics=jnp.asarray(k[None]), **common)
    jw, jk = jax_trajectory("left", w2c0, k, 17, 0.3, "center_facing", 1.0)
    kw = dict(num_steps=2, guidance=1.0, seed=3)
    want, _ = jax_chunked(JaxPipeline(model=jmodel, height=h, width=w, **kw), jcache, jw, jk,
                          seed_frames=image, prompt="", update_cache_with_depth=JaxHeuristic())
    assert len(shared_scale_map) == 1  # chunk 2's update ran the non-rigid fit

    tcache = Cache3DBuffer(input_image=torch.from_numpy(image[:, :, 0]),
                           input_depth=torch.from_numpy(depth[None, None]),
                           input_w2c=torch.from_numpy(w2c0[None]),
                           input_intrinsics=torch.from_numpy(k[None]), **common)
    tw, tk = generate_camera_trajectory("left", w2c0, k, 17, 0.3, "center_facing", 1.0)
    pipe = Gen3cPipeline(model=tmodel, **kw)
    generate = pipe.generate

    def generate_then_align(*args, **kwargs):
        video, prompt = generate(*args, **kwargs)
        if video.shape[0] == 9 and not hasattr(pipe, "_chunk1"):
            pipe._chunk1 = video.copy()
            video[-1] = want[8]  # same seed frame for chunk 2
        return video, prompt

    pipe.generate = generate_then_align
    timings = {}
    got, warps = run_chunked_generation(pipe, tcache, tw, tk, seed_frames=image, prompt="",
                                        update_cache_with_depth=HeuristicDepthEstimator(),
                                        timings=timings)
    assert got.shape == (17, h, w, 3) and not shared_scale_map
    assert len(timings["render"]) == 2 and len(timings["update"]) == 1
    _assert_frames_close(pipe._chunk1, want[:9])
    _assert_frames_close(got[9:], want[9:])


def _tiny_image(path):
    from PIL import Image

    Image.fromarray((np.random.default_rng(0).uniform(size=(96, 160, 3)) * 255)
                    .astype(np.uint8)).save(path)


def test_cli_subprocess(tmp_path):
    img = tmp_path / "in.png"
    _tiny_image(img)
    out = subprocess.run(
        [sys.executable, "-m", "gen3c_tpu_torch.pipelines.gen3c_single_image",
         "--device", "cpu", "--model_preset", "gen3c_tiny", "--num_steps", "2",
         "--depth_source", "heuristic", "--num_video_frames", "17",
         "--input_image_path", str(img), "--video_save_folder", str(tmp_path / "out"),
         "--checkpoint_dir", str(tmp_path / "none")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    saved = os.listdir(tmp_path / "out")
    assert saved, out.stdout[-2000:]


def test_cli_saves_avi_without_imageio(tmp_path, monkeypatch):
    """Without imageio the CLI's saver writes the MJPEG AVI that gen3c_tpu's
    save_video writes when ffmpeg is missing, and it reads back."""
    from gen3c_tpu.utils.mjpeg_avi import read_mjpeg_avi
    from gen3c_tpu_torch.pipelines import gen3c_single_image as cli

    monkeypatch.setitem(sys.modules, "imageio", None)  # import imageio -> ImportError
    video = np.random.default_rng(0).integers(0, 255, (3, 16, 24, 3), dtype=np.uint8)
    saver = cli.IncrementalVideoSaver(24)
    saver.update(video[:2])
    path = saver.save(video, str(tmp_path / "v" / "out.mp4"))
    assert path == str(tmp_path / "v" / "out.avi")
    frames = read_mjpeg_avi(path)[0]
    assert len(frames) == 3 and frames[0].shape == (16, 24, 3)


def test_cli_fast_preset_subprocess(tmp_path):
    """--perf_preset fast through the CLI: W8A8 (no linear of the tiny preset
    is large enough to quantize), band window 2, step-cache interval 2 and
    the guidance interval."""
    img = tmp_path / "in.png"
    _tiny_image(img)
    out = subprocess.run(
        [sys.executable, "-m", "gen3c_tpu_torch.pipelines.gen3c_single_image",
         "--device", "cpu", "--model_preset", "gen3c_tiny", "--num_steps", "8",
         "--perf_preset", "fast", "--depth_source", "heuristic", "--num_video_frames", "9",
         "--input_image_path", str(img), "--video_save_folder", str(tmp_path / "out"),
         "--checkpoint_dir", str(tmp_path / "none")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert os.listdir(tmp_path / "out")
    log = out.stdout + out.stderr
    assert "quantizing DiT weights to int8 (w8a8)" in log
    assert "c*" in log  # a cached condition-only step in the step log


@pytest.mark.parametrize("flag", [["--step_cache_block_span", "1", "2", "--step_cache_interval", "2"],
                                  ["--step_cache_span_dtype", "int8", "--step_cache_block_span",
                                   "0", "1", "--step_cache_interval", "2"],
                                  ["--solver", "res2ab"], ["--solver", "dpm2m"]],
                         ids=["span", "span-int8", "res2ab", "dpm2m"])
def test_cli_sampler_flags_match_jax(flag, tmp_path, monkeypatch, models):
    """Span caching (bf16 and int8 carries) and the multistep solvers
    through the single-image CLI: one 9-frame chunk of gen3c_tiny in 6
    steps (a skipped step at 3 under span caching), on the CPU, against
    gen3c_tpu's CLI on the same weights, the span reaching each package's
    model through its factory's cache_block_span / cache_span_dtype."""
    import copy
    import dataclasses

    from PIL import Image

    import gen3c_tpu.pipelines.chunked as jchunked
    from gen3c_tpu.pipelines import gen3c_single_image as jcli
    from gen3c_tpu_torch.pipelines import gen3c_single_image as tcli

    jmodel, tmodel, preset = models
    Image.fromarray((np.random.default_rng(8).uniform(size=(preset.height, preset.width, 3))
                     * 255).astype(np.uint8)).save(tmp_path / "in.png")
    argv = ["--input_image_path", str(tmp_path / "in.png"), "--model_preset", "gen3c_tiny",
            "--checkpoint_dir", str(tmp_path / "none"), "--num_video_frames", "9",
            "--num_steps", "6", "--guidance", "2", "--depth_source", "heuristic",
            "--video_save_folder", str(tmp_path / "out"), *flag]
    built = {}

    def jbuild(*a, cache_block_span=None, cache_span_dtype="bf16", **kw):
        cfg = dataclasses.replace(jmodel.dit_cfg, cache_span_dtype=cache_span_dtype,
                                  cache_block_span=tuple(cache_block_span)
                                  if cache_block_span else None)
        return dataclasses.replace(jmodel, dit_cfg=cfg), preset

    def tbuild(*a, cache_block_span=None, cache_span_dtype="bf16", **kw):
        net = copy.copy(tmodel.net)
        net.cfg = dataclasses.replace(tmodel.net.cfg, cache_span_dtype=cache_span_dtype,
                                      cache_block_span=tuple(cache_block_span)
                                      if cache_block_span else None)
        built["cfg"] = net.cfg
        return dataclasses.replace(tmodel, net=net), preset

    monkeypatch.setattr(jcli, "build_gen3c_model", jbuild)
    monkeypatch.setattr(tfactory, "build_gen3c_model", tbuild)
    runs = {}
    for name, module in (("jax", jchunked), ("port", sys.modules[tcli.__name__])):
        inner = module.run_chunked_generation

        def wrapped(*args, _inner=inner, _name=name, **kwargs):
            out = _inner(*args, **kwargs)
            runs[_name] = (out[0].copy(), args[0])
            return out

        monkeypatch.setattr(module, "run_chunked_generation", wrapped)
    jcli.demo(jcli.create_parser().parse_args(argv))
    tcli.demo(tcli.create_parser().parse_args(argv + ["--device", "cpu"]))
    pipeline = runs["port"][1]
    steps = [s["refresh"] for s in pipeline.last_timings["denoise_steps"]]
    if "--step_cache_block_span" in flag:
        assert built["cfg"].cache_block_span == tuple(int(v) for v in flag[flag.index(
            "--step_cache_block_span") + 1:][:2])
        assert steps == [True, True, True, False, True, True]
    else:
        assert pipeline.solver == flag[1] and all(steps)
    _assert_frames_close(runs["port"][0], runs["jax"][0])


@pytest.mark.parametrize("flag", [["--parallel", "cp2tp2"], ["--parallel", "cfg2tp2"],
                                  ["--enable_prompt_encoder", "--t5_backend", "torch"],
                                  ["--enable_prompt_encoder"], ["--parallel", "tp"],
                                  ["--parallel", "cp2tp2sp"], ["--parallel", "cfg2cp2tp2"]])
def test_cli_unported_flags_raise(flag, tmp_path):
    """The flags of paths that were not ported before: the prompt encoder
    without the t5-11b files raises an error naming them
    (tests/test_torch_t5.py has it load); the tensor-parallel strategies
    reach build_gen3c_model, which validates them over 4 devices as
    gen3c_tpu's factory does and then needs torchrun's 4 processes
    (tests/test_torch_tp.py runs them)."""
    from gen3c_tpu_torch.pipelines import gen3c_single_image as cli

    if flag[0] == "--enable_prompt_encoder":
        args = cli.create_parser().parse_args(
            ["--input_image_path", "x.png", *flag, "--device", "cpu", "--model_preset",
             "gen3c_tiny", "--checkpoint_dir", str(tmp_path)])
        with pytest.raises(FileNotFoundError, match="google-t5/t5-11b"):
            cli.demo(args)
        return
    args = cli.create_parser().parse_args(["--input_image_path", "x.png", *flag, "--device",
                                           "cpu", "--model_preset", "gen3c_tiny",
                                           "--num_gpus", "4"])
    want = "needs 8 devices" if flag[1] == "cfg2cp2tp2" else "torchrun --nproc_per_node 4"
    with pytest.raises(ValueError, match=want):
        cli.demo(args)


@pytest.mark.parametrize("flags", [[], ["--perf_preset", "fast"],
                                   ["--perf_preset", "fast", "--quantize_int8"],
                                   ["--perf_preset", "fast", "--step_cache_threshold", "0.1",
                                    "--attn_temporal_window", "1"],
                                   ["--perf_preset", "fast", "--step_cache_interval", "3",
                                    "--guidance_interval", "0.5", "20"],
                                   ["--perf_preset", "exact", "--cfg_rescale", "0.7"]])
def test_perf_preset_expands_as_jax(flags):
    """The port's apply_perf_preset sets the knobs JAX's sets, and the CLI
    accepts every one of them."""
    from gen3c_tpu.pipelines import gen3c_single_image as jcli
    from gen3c_tpu_torch.pipelines import gen3c_single_image as cli

    argv = ["--input_image_path", "x.png", *flags]
    ours, theirs = cli.create_parser().parse_args(argv), jcli.create_parser().parse_args(argv)
    tfactory.apply_perf_preset(ours)
    jfactory.apply_perf_preset(theirs)
    for key in ("quantize_w8a8", "quantize_int8", "attn_temporal_window", "step_cache_interval",
                "step_cache_threshold", "guidance_interval", "cfg_rescale", "perf_preset"):
        assert getattr(ours, key) == getattr(theirs, key), key


def test_port_never_imports_jax():
    """Every module of the port imports, and its paths run (generation, a
    train step, the Trainer, a LoRA step with the band, the training CLI on
    a packaged clip, the dynamic and multiview CLIs with foreground
    masking, checkpoints written and loaded, the T5 stack, the single-image
    AR chain with MoGe depth, the serving model, the debug server and the
    native host libraries, a two-rank context-parallel run under torchrun,
    the ODE solvers, span caching and a multistep denoise, text2world, the
    world interpolator, the tokenizer CLI, the quality curve and the block
    ranking), without importing jax, jaxlib or any gen3c_tpu module."""
    code = r"""
import importlib, pkgutil, sys
import numpy as np, torch
torch.set_num_threads(2)  # as this file's own process: the suite runs beside it
import gen3c_tpu_torch
for m in pkgutil.walk_packages(gen3c_tpu_torch.__path__, "gen3c_tpu_torch."):
    importlib.import_module(m.name)
from gen3c_tpu_torch.pipelines.factory import build_gen3c_model
from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline
model, p = build_gen3c_model("gen3c_tiny", device="cpu", seed=0)
rng = np.random.default_rng(0)
video, _ = Gen3cPipeline(model=model, num_steps=2).generate(
    "", rng.uniform(-1, 1, (1, 3, 1, p.height, p.width)).astype(np.float32),
    torch.zeros(1, p.chunk_size, 1, 3, p.height, p.width),
    torch.ones(1, p.chunk_size, 1, 1, p.height, p.width))
assert video.shape == (p.chunk_size, p.height, p.width, 3)
# training: two train_steps, then one Trainer step with its checkpoint
import tempfile
from gen3c_tpu_torch.training.train import build_net
from gen3c_tpu_torch.training.train_step import init_train_state, make_optimizer, train_step
from gen3c_tpu_torch.training.trainer import Trainer, TrainerConfig, synthetic_latent_dataset
data = synthetic_latent_dataset(1, 16, 2, 8, 8)
opt = make_optimizer(lr=1e-3, warmup_steps=1)
state = init_train_state(build_net(p.dit, "cpu", 0), opt)
gen = torch.Generator().manual_seed(0)
for _ in range(2):
    state, metrics = train_step(state, next(data), gen, p.dit, opt, remat=True)
assert state.step == 2 and np.isfinite(float(metrics["loss"]))
with tempfile.TemporaryDirectory() as job:
    cfg = TrainerConfig(job_dir=job, max_iter=1, warmup_steps=1, prefetch_batches=0)
    assert Trainer(cfg, p.dit, build_net(p.dit, "cpu", 0)).train(data).step == 1
# LoRA: one lora_train_step over a frozen base with the band and remat
import dataclasses
from gen3c_tpu_torch.training.lora import init_lora_params, lora_leaves, lora_train_step
band_cfg = dataclasses.replace(p.dit, attn_temporal_window=0)
base = build_net(band_cfg, "cpu", 0)
lora = init_lora_params(gen, base, rank=2)
opt_state = opt.init(lora_leaves(lora))
lora, opt_state, metrics = lora_train_step(lora, opt_state, base, next(data), gen, band_cfg, opt,
                                           remat=True)
assert np.isfinite(float(metrics["loss"]))
# the training CLI on a packaged clip (--data_root)
from gen3c_tpu_torch.ops.camera import generate_camera_trajectory
from gen3c_tpu_torch.pipelines.depth import default_intrinsics
from gen3c_tpu_torch.training import train
with tempfile.TemporaryDirectory() as root:
    F, h, w = p.chunk_size, p.height, p.width
    w2c, ks = generate_camera_trajectory("left", np.eye(4, dtype=np.float32),
                                         default_intrinsics(h, w), F, 0.3, "center_facing", 1.0)
    np.savez(f"{root}/clip.npz", image=rng.uniform(-1, 1, (F, 3, h, w)).astype(np.float32),
             depth=np.full((F, 1, h, w), 2.0, np.float32),
             w2c=np.asarray(w2c, np.float32).reshape(F, 4, 4),
             intrinsics=np.asarray(ks, np.float32).reshape(F, 3, 3))
    cli = train.main(["--data_root", root, "--device", "cpu", "experiment=gen3c_tiny",
                      "dit.attn_temporal_window=1", "trainer.max_iter=1", "trainer.warmup_steps=1",
                      f"trainer.job_dir={root}/job"])
    assert cli.state.step == 1
# the dynamic and multiview CLIs, foreground-masked, on a clip with a nearer box
from gen3c_tpu_torch.pipelines import gen3c_dynamic, gen3c_multiview
with tempfile.TemporaryDirectory() as root:
    F, h, w = p.chunk_size, p.height, p.width
    depth = np.full((F, 1, h, w), 2.0, np.float32)
    depth[:, :, h // 3:2 * h // 3, w // 3:2 * w // 3] = 1.0
    image = rng.uniform(-1, 1, (F, 3, h, w)).astype(np.float32)
    k = np.repeat(default_intrinsics(h, w)[None], F, 0)
    w2c = np.asarray(w2c, np.float32).reshape(F, 4, 4)
    np.savez(f"{root}/clip.npz", image=image, depth=depth, intrinsics=k,
             w2c=np.repeat(np.eye(4, dtype=np.float32)[None], F, 0))
    np.savez(f"{root}/mv.npz", images_key_frames=image[:3], depth_key_frames=depth[:3],
             K_key_frames=k[:3], w2cs_key_frames=w2c[:3], w2cs_all=w2c, Ks_all=k)
    common = ["--device", "cpu", "--model_preset", "gen3c_tiny", "--num_steps", "1",
              "--num_video_frames", str(F), "--foreground_masking", "--video_save_folder", root,
              "--checkpoint_dir", f"{root}/none"]
    gen3c_dynamic.demo(gen3c_dynamic.create_parser().parse_args(
        ["--input_video_path", f"{root}/clip.npz", "--trajectory", "left"] + common))
    record = {}
    gen3c_multiview.demo(gen3c_multiview.create_parser().parse_args(
        ["--npz_path", f"{root}/mv.npz", "--frame_buffer_max", "2"] + common), record=record)
    assert len(record["selections"]) == 1 and len(record["selections"][0]) == 2
# checkpoints: the tiny net written as dit.npz and as a wrapped model.pt, each
# loaded back by the factory; the T5 stack; MoGe depth from an npz through the
# single-image CLI's AR chain (two chunks)
import os
from gen3c_tpu_torch.models.convert import convert_dit_state_dict
from gen3c_tpu_torch.utils.checkpoint import save_params_npz
from gen3c_tpu_torch.pipelines import gen3c_single_image
with tempfile.TemporaryDirectory() as root:
    state = model.net.state_dict()
    save_params_npz(f"{root}/npz/gen3c_tpu/dit.npz", convert_dit_state_dict(state, p.dit))
    os.makedirs(f"{root}/pt/GEN3C-Cosmos-7B")
    torch.save({"model": {f"net.{k}": v for k, v in state.items()}},
               f"{root}/pt/GEN3C-Cosmos-7B/model.pt")
    for d in ("npz", "pt"):
        loaded, _ = build_gen3c_model("gen3c_tiny", device="cpu", checkpoint_dir=f"{root}/{d}")
        assert all(torch.equal(v, state[k]) for k, v in loaded.net.state_dict().items())
    from gen3c_tpu_torch.models.t5 import T5Config, T5Encoder
    enc = T5Encoder(T5Config(vocab_size=20, d_model=16, num_layers=1, num_heads=2, d_kv=4,
                             d_ff=8, dtype=torch.float32)).init_random(gen)
    assert torch.isfinite(enc(torch.zeros(1, 5, dtype=torch.long), torch.ones(1, 5))).all()
    from gen3c_tpu_torch.aux import moge
    sd = {k: v.numpy() for k, v in moge.init_moge_params(gen, moge.MOGE_TINY).items()}
    sd["head.out.bias"] = np.array([0.0, 0.0, 2.0, 4.0], np.float32)
    np.savez(f"{root}/moge.npz", **sd)
    os.environ["GEN3C_MOGE_CHECKPOINT"] = f"{root}/moge.npz"
    moge.MOGE_VITL = moge.MOGE_TINY
    from PIL import Image
    Image.fromarray((rng.uniform(size=(p.height, p.width, 3)) * 255).astype(np.uint8)).save(
        f"{root}/in.png")
    record = {}
    gen3c_single_image.demo(gen3c_single_image.create_parser().parse_args(
        ["--input_image_path", f"{root}/in.png", "--depth_source", "moge_jax", "--device", "cpu",
         "--model_preset", "gen3c_tiny", "--num_steps", "1", "--num_video_frames",
         str(2 * p.chunk_size - 1), "--video_save_folder", root, "--checkpoint_dir",
         f"{root}/npz"]), record=record)
    assert len(record["depth"]) == 1 and record["seed_depth"] > 0
# serving: the tiny persistent model seeded and run over two chunks with a
# preview, the debug server over HTTP, the native host libraries
import threading, urllib.request
from gen3c_tpu_torch.native import camera_path, point_raster
from gen3c_tpu_torch.serving.api_types import InferenceRequest, SeedingRequest
from gen3c_tpu_torch.serving.models import DebugInferenceModel, Gen3cPersistentModel
from gen3c_tpu_torch.serving.server import serve
served = Gen3cPersistentModel("gen3c_tiny", checkpoint_dir=None, num_steps=1,
                              depth_source="heuristic", device="cpu")
cams = lambda n: dict(cameras_to_world=np.tile(np.eye(4, dtype=np.float32)[:3], (n, 1, 1)),
                      focal_lengths=np.full((n, 2), 100.0, np.float32),
                      principal_points=np.full((n, 2), 0.5, np.float32))
served.seed_model(SeedingRequest(request_id="s", images=np.zeros((1, p.height, p.width, 3),
                                                                 np.uint8), **cams(1)))
n = 2 * p.chunk_size - 1
req = lambda: InferenceRequest(request_id="i", resolutions=np.tile([[p.width, p.height]], (n, 1)),
                               **cams(n))
assert served.run_inference(req()).images.shape == (n, p.height, p.width, 3)
assert served.render_preview(req()).images.shape == (n, p.height, p.width, 3)
server, service = serve(host="127.0.0.1", port=0, model=DebugInferenceModel())
threading.Thread(target=server.serve_forever, daemon=True).start()
with urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/metadata") as r:
    assert r.status == 200
server.shutdown(); service.shutdown()
path = camera_path.CameraPath()
path.add_keyframe_from_c2w(np.eye(4, dtype=np.float32)[:3])
assert path.sample(3)[0].shape == (3, 3, 4) and point_raster.available()
# a context-parallel run: two ranks (torchrun, gloo), ring attention, each
# rank checking its own modules
import os, subprocess
rank_code = '''
import sys, numpy as np, torch
from gen3c_tpu_torch.pipelines.factory import build_gen3c_model
from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline
model, p = build_gen3c_model("gen3c_tiny", device="cpu", seed=0, num_devices=2, cp_attn="ring")
assert model.groups.cp.size == 2
video, _ = Gen3cPipeline(model=model, num_steps=1).generate(
    "", np.zeros((1, 3, 1, p.height, p.width), np.float32),
    torch.zeros(1, p.chunk_size, 1, 3, p.height, p.width),
    torch.ones(1, p.chunk_size, 1, 1, p.height, p.width))
foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gen3c_tpu"))
assert not foreign, foreign[:8]
print("rank jax-free")
'''
with tempfile.TemporaryDirectory() as root:
    open(f"{root}/rank.py", "w").write(rank_code)
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", f"{root}/rank.py"],
                         env=dict(os.environ, PYTHONPATH=os.getcwd()), capture_output=True,
                         text=True, timeout=200)
    assert out.returncode == 0 and out.stdout.count("rank jax-free") == 2, out.stderr[-2000:]
# the slice-14 modules: the ODE solvers, a multistep and a span-cached
# denoise, text2world, the interpolator, the tokenizer CLI, the quality
# curve and the block ranking
from gen3c_tpu_torch.diffusion.solvers import SOLVERS, sample_ode
for solver in SOLVERS:
    assert torch.isfinite(sample_ode(lambda x, s: torch.tanh(x), torch.ones(1, 2, 1, 2, 2),
                                     num_steps=3, solver=solver)).all()
span_model, _ = build_gen3c_model("gen3c_tiny", device="cpu", seed=0, cache_block_span=(0, 1),
                                  cache_span_dtype="int8")
for kw in (dict(step_cache_interval=2, num_steps=6), dict(solver="res2ab", num_steps=3)):
    video, _ = Gen3cPipeline(model=span_model, **kw).generate(
        "", np.zeros((1, 3, 1, p.height, p.width), np.float32),
        torch.zeros(1, p.chunk_size, 1, 3, p.height, p.width),
        torch.ones(1, p.chunk_size, 1, 1, p.height, p.width))
import argparse, imageio
from gen3c_tpu_torch.pipelines import text2world, tokenizer_cli, world_interpolator
t2w, tp = build_gen3c_model(text2world.COSMOS_V2W_TINY, device="cpu", seed=0)
assert text2world.generate_world(t2w, tp, np.zeros((1, 512, 1024), np.float32), num_steps=2,
                                 solver="dpm2m").shape == (tp.chunk_size, tp.height, tp.width, 3)
ends = np.zeros((1, 3, 1, tp.height, tp.width), np.float32)
world_interpolator._interpolate_pair(t2w, tp, ends, ends, argparse.Namespace(
    num_steps=2, guidance=7.0, guidance_interval=None, solver="res2ab"), seed=1)
from gen3c_tpu_torch.diffusion.quality import approximation_quality_curve
assert len(approximation_quality_curve(num_steps=3, lat_t=4, lat_hw=4, device="cpu")) == 10
from gen3c_tpu_torch.scripts import rank_block_contributions
rank_block_contributions.main(["--device", "cpu", "--num_sigmas", "1"])
with tempfile.TemporaryDirectory() as root:
    imageio.mimsave(f"{root}/in.gif", list(np.zeros((9, 32, 32, 3), np.uint8)))
    tokenizer_cli.main(["--input", f"{root}/in.gif", "--output", f"{root}/o.mp4",
                        "--vae_preset", "tiny", "--chunk_duration", "9", "--device", "cpu"])
foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gen3c_tpu"))
assert not foreign, foreign[:8]
print("jax-free")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("jax-free")
