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


@pytest.mark.parametrize("flag", [["--quantize_w8a8"], ["--step_cache_interval", "2"],
                                  ["--attn_temporal_window", "2"], ["--solver", "dpm2m"],
                                  ["--num_devices", "2"], ["--foreground_masking"],
                                  ["--enable_prompt_encoder"], ["--perf_preset", "fast"],
                                  ["--guidance_interval", "1", "9"], ["--cfg_rescale", "0.5"]])
def test_cli_unported_flags_raise(flag):
    from gen3c_tpu_torch.pipelines import gen3c_single_image as cli

    args = cli.create_parser().parse_args(["--input_image_path", "x.png", *flag])
    with pytest.raises(NotImplementedError, match=flag[0]):
        cli.check_ported(args)


def test_port_never_imports_jax():
    code = r"""
import importlib, pkgutil, sys
import numpy as np, torch
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
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("jax-free")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("jax-free")
