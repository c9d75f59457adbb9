"""The port's sampling options against gen3c_tpu on the CPU.

guidance_interval_steps must agree exactly. generate_samples with
fixed-interval and adaptive step caching, the guidance interval and CFG
rescale is run by both packages on the same numpy inputs with the same
small analytic network (the sampler's control flow is under test, not the
DiT): fp32 latents at atol 1e-5 (elementwise fp32 math on both sides; the
means and stds of the drift and the rescale sum in another order). Both
must refuse the same combinations.

The slice as a whole: the tiny preset, with _MIN_SIZE lowered in both
packages so that W8A8 reaches every linear, generates two chunks with the
``--perf_preset fast`` knobs (W8A8, band window 2, step-cache interval 2,
guidance interval 1.75..81) in 8 steps; chunk 1 must agree as uint8 within
1 level on >= 99.9% of values (the test_torch_pipeline criterion).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gen3c_tpu.models.quantize as jq
import gen3c_tpu_torch.models.quantize as tq
from gen3c_tpu.cache import Cache3DBuffer as JaxCache3DBuffer
from gen3c_tpu.diffusion import sampler as jsampler
from gen3c_tpu.diffusion.scheduler import EDMEulerSchedule as JaxSchedule
from gen3c_tpu.models.dit import randomize_degenerate_inits
from gen3c_tpu.ops.camera import generate_camera_trajectory as jax_trajectory
from gen3c_tpu.pipelines import factory as jfactory
from gen3c_tpu.pipelines.chunked import run_chunked_generation as jax_chunked
from gen3c_tpu.pipelines.depth import HeuristicDepthEstimator as JaxHeuristic
from gen3c_tpu.pipelines.gen3c_pipeline import Gen3cPipeline as JaxPipeline
from gen3c_tpu_torch.bridge import dit_state_from_jax, vae_state_from_jax
from gen3c_tpu_torch.cache import Cache3DBuffer
from gen3c_tpu_torch.diffusion import sampler as tsampler
from gen3c_tpu_torch.diffusion.scheduler import EDMEulerSchedule
from gen3c_tpu_torch.ops.camera import generate_camera_trajectory
from gen3c_tpu_torch.pipelines import factory as tfactory
from gen3c_tpu_torch.pipelines.chunked import run_chunked_generation
from gen3c_tpu_torch.pipelines.depth import HeuristicDepthEstimator
from gen3c_tpu_torch.pipelines.gen3c_pipeline import Gen3cPipeline

torch.set_num_threads(2)

B, C, T, H, W, P = 1, 16, 3, 6, 8, 8


@pytest.mark.parametrize("interval", [(1.75, 81.0), (0.5, 20.0), (0.0, 1e4), (100.0, 200.0),
                                      (3.0, 3.0), (0.002, 0.05)])
def test_guidance_interval_steps_match_jax(interval):
    for n in range(4, 36):
        assert (tsampler.guidance_interval_steps(EDMEulerSchedule(), n, interval)
                == jsampler.guidance_interval_steps(JaxSchedule(), n, interval)), n
    assert tsampler.guidance_interval_steps(EDMEulerSchedule(), 8, (1.75, 81.0)) == (0, 4)


def _jax_net(w, x, t, ctx):
    """A small network with the DiT's interface: (N, C+1+P, T, H, W) in,
    (N, C, T, H, W) out; cond and uncond differ through ctx and the pose."""
    s = t[:, None, None, None, None]
    h = jnp.tanh(w * x[:, :C] + 0.3 * x[:, C + 1:C + 1 + C // 2].repeat(2, axis=1))
    return h * (1.0 + 0.1 * s) + 0.05 * ctx.mean(axis=(1, 2))[:, None, None, None, None]


def _torch_net(x, t, ctx, w=0.7):
    s = t[:, None, None, None, None]
    h = torch.tanh(w * x[:, :C] + 0.3 * x[:, C + 1:C + 1 + C // 2].repeat_interleave(2, dim=1))
    return h * (1.0 + 0.1 * s) + 0.05 * ctx.mean(dim=(1, 2))[:, None, None, None, None]


def _sampler_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, C, T, H, W)
    arrays = dict(
        init_noise=rng.standard_normal(shape),
        augment_noise=rng.standard_normal(shape),
        crossattn_cond=rng.standard_normal((B, 16, 32)),
        crossattn_uncond=np.zeros((B, 16, 32)),
        gt_latent=rng.standard_normal(shape),
        condition_video_indicator=np.array([1.0, 0.0, 0.0]).reshape(1, 1, T, 1, 1),
        condition_video_input_mask=np.broadcast_to(
            np.array([1.0, 0.0, 0.0]).reshape(1, 1, T, 1, 1), (B, 1, T, H, W)),
        pose_latent_cond=rng.standard_normal((B, P, T, H, W)),
        pose_latent_uncond=np.zeros((B, P, T, H, W)),
    )
    return {k: np.ascontiguousarray(v, np.float32) for k, v in arrays.items()}


_OPTIONS = [
    dict(step_cache_interval=2),
    dict(step_cache_interval=3, guidance_interval=(1.75, 81.0)),
    dict(step_cache_interval=2, guidance_interval=(0.5, 5.0)),  # CFG range starts late
    dict(guidance_interval=(1.75, 81.0)),
    dict(guidance_interval=(0.5, 20.0), cfg_rescale=0.7),
    dict(cfg_rescale=0.5),
    dict(step_cache_threshold=0.05),
    dict(step_cache_threshold=0.3),
    dict(step_cache_threshold=0.2, guidance_interval=(0.0, 1e4)),  # the whole schedule
    dict(step_cache_interval=2, guidance_interval=(1.75, 81.0), cfg_rescale=0.3),
]


@pytest.mark.parametrize("opts", _OPTIONS, ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_generate_samples_options_match_jax(opts):
    arrays = _sampler_inputs()
    kw = dict(num_steps=10, guidance=2.0)
    want = np.asarray(jsampler.generate_samples(
        _jax_net, jnp.float32(0.7), **{k: jnp.asarray(v) for k, v in arrays.items()},
        **kw, **opts))
    steps = []
    got = tsampler.generate_samples(
        _torch_net, **{k: torch.from_numpy(v) for k, v in arrays.items()}, **kw, **opts,
        on_step=lambda i, cfg, refresh: steps.append((cfg, refresh))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert len(steps) == 10
    caching = opts.get("step_cache_interval", 1) > 1 or opts.get("step_cache_threshold", 0) > 0
    refreshed = [r for _, r in steps]
    assert all(refreshed) != caching  # the cache skipped some steps iff it was on
    if "guidance_interval" in opts and opts["guidance_interval"] != (0.0, 1e4):
        assert not all(c for c, _ in steps)  # some steps ran condition-only


def test_fixed_interval_pattern_of_the_fast_preset():
    """8 steps, interval 2, guidance interval 1.75..81: CFG on steps 0-3,
    the network on steps {0, 1, 2, 4, 6, 7}."""
    arrays = {k: torch.from_numpy(v) for k, v in _sampler_inputs().items()}
    steps = []
    tsampler.generate_samples(_torch_net, **arrays, num_steps=8, step_cache_interval=2,
                              guidance_interval=(1.75, 81.0),
                              on_step=lambda i, cfg, refresh: steps.append((cfg, refresh)))
    assert [c for c, _ in steps] == [True] * 4 + [False] * 4
    assert [i for i, (_, r) in enumerate(steps) if r] == [0, 1, 2, 4, 6, 7]


@pytest.mark.parametrize("opts", [dict(step_cache_threshold=0.1, guidance_interval=(1.75, 81.0)),
                                  dict(guidance_interval=(5.0, 1.0)),
                                  dict(guidance_interval=(-1.0, 1.0))])
def test_generate_samples_raise_where_jax_raises(opts):
    arrays = _sampler_inputs()
    with pytest.raises(ValueError):
        jsampler.generate_samples(_jax_net, jnp.float32(0.7),
                                  **{k: jnp.asarray(v) for k, v in arrays.items()},
                                  num_steps=8, **opts)
    with pytest.raises(ValueError):
        tsampler.generate_samples(_torch_net, **{k: torch.from_numpy(v) for k, v in arrays.items()},
                                  num_steps=8, **opts)


# ------------------------------ the slice ------------------------------


def test_fast_preset_two_chunks_match_jax(monkeypatch):
    monkeypatch.setattr(jq, "_MIN_SIZE", 1)
    monkeypatch.setattr(tq, "_MIN_SIZE", 1)
    args = argparse.Namespace(perf_preset="fast", quantize_w8a8=False, quantize_int8=False,
                              attn_temporal_window=None, step_cache_interval=1,
                              step_cache_threshold=0.0, guidance_interval=None)
    tfactory.apply_perf_preset(args)
    assert args.quantize_w8a8 and args.attn_temporal_window == 2
    knobs = dict(step_cache_interval=args.step_cache_interval,
                 guidance_interval=tuple(args.guidance_interval))

    # the same fp32 weights on both sides, then each package quantizes them
    jmodel, preset = jfactory.build_gen3c_model(
        "gen3c_tiny", checkpoint_dir=None, seed=0, param_dtype=jnp.float32,
        attn_temporal_window=args.attn_temporal_window)
    jmodel.dit_params = randomize_degenerate_inits(jmodel.dit_params)
    tmodel, _ = tfactory.build_gen3c_model("gen3c_tiny", device="cpu", seed=0,
                                           attn_temporal_window=args.attn_temporal_window)
    tmodel.net.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, jmodel.dit_params)))
    tmodel.tokenizer.vae.load_state_dict(
        vae_state_from_jax({k: np.asarray(v) for k, v in jmodel.tokenizer.params.items()}))
    jmodel.dit_params = jq.quantize_dit_params_inplace(jmodel.dit_params, act_quant=True)
    tq.quantize_dit_(tmodel.net, act_quant=True)
    assert "q8" in jmodel.dit_params["blocks"][0]["fa"]["q"]
    assert tmodel.net.cfg.attn_temporal_window == jmodel.dit_cfg.attn_temporal_window == 2

    h, w = preset.height, preset.width
    rng = np.random.default_rng(4)
    image = rng.uniform(-1, 1, (1, 3, 1, h, w)).astype(np.float32)
    depth, k, _ = JaxHeuristic()((image[0, :, 0].transpose(1, 2, 0) + 1) / 2)
    w2c0 = np.eye(4, dtype=np.float32)
    common = dict(frame_buffer_max=2, noise_aug_strength=0.0, filter_points_threshold=0.05)
    kw = dict(num_steps=8, guidance=1.0, seed=3, **knobs)

    jcache = JaxCache3DBuffer(input_image=jnp.asarray(image[:, :, 0]),
                              input_depth=jnp.asarray(depth[None, None]),
                              input_w2c=jnp.asarray(w2c0[None]),
                              input_intrinsics=jnp.asarray(k[None]), **common)
    jw, jk = jax_trajectory("left", w2c0, k, 17, 0.3, "center_facing", 1.0)
    want, _ = jax_chunked(JaxPipeline(model=jmodel, height=h, width=w, **kw), jcache, jw, jk,
                          seed_frames=image, prompt="", update_cache_with_depth=JaxHeuristic())

    tcache = Cache3DBuffer(input_image=torch.from_numpy(image[:, :, 0]),
                           input_depth=torch.from_numpy(depth[None, None]),
                           input_w2c=torch.from_numpy(w2c0[None]),
                           input_intrinsics=torch.from_numpy(k[None]), **common)
    tw, tk = generate_camera_trajectory("left", w2c0, k, 17, 0.3, "center_facing", 1.0)
    pipe = Gen3cPipeline(model=tmodel, **kw)
    got, _ = run_chunked_generation(pipe, tcache, tw, tk, seed_frames=image, prompt="",
                                    update_cache_with_depth=HeuristicDepthEstimator())
    assert got.shape == want.shape == (17, h, w, 3)
    kinds = [(s["cfg"], s["refresh"]) for s in pipe.last_timings["denoise_steps"]]
    assert kinds == [(True, True)] * 3 + [(True, False), (False, True), (False, False),
                                          (False, True), (False, True)]
    diff = np.abs(got[:9].astype(np.int16) - want[:9].astype(np.int16))
    assert (diff <= 1).mean() >= 0.999, (diff.max(), (diff > 1).mean())
