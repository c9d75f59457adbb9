"""Span caching (Delta-DiT) in the port against gen3c_tpu on the CPU.

GeneralDIT's span forwards (``return_span_delta``: the delta the span's
blocks add; ``span_delta``: the skip path that re-applies it) and its
``return_block_residuals`` hook are held to ``dit_forward`` on the tiny DiT
(3 blocks, the JAX init with its zero gates randomized, bridged). The
sampler's span loop runs through ``Gen3CModel.generate_samples`` on the
tiny preset against JAX's ``_dit_net_fn_span_*`` loop, and under context
parallelism on two spawned gloo CPU ranks (``torch_cp_ranks``) against
JAX's cp shard_map and the port's single process.

Tolerances: fp32 forwards rtol/atol 1e-4 (tests/test_torch_dit.py); the
int8 carry's codes are JAX's exactly when both quantize the same delta
(XLA compiles absmax / 127 to a multiply by the fp32 reciprocal, and so
does the port), and otherwise within one code on at most 1e-3 of the
tokens' values; the bf16 DiT against op-by-op JAX, max 3e-2 and mean 3e-3
(tests/test_torch_dit.py's bf16 bound), the bf16 delta's max one bf16 ulp
of its token streams (2^-5); sampler latents atol 1e-4
(tests/test_torch_pipeline.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cp_ranks
from gen3c_tpu.diffusion import sampler as jsampler
from gen3c_tpu.models import dit as jdit
from gen3c_tpu.parallel.cp import cp_generate_samples as jax_cp_generate_samples
from gen3c_tpu.parallel.mesh import make_mesh
from gen3c_tpu.pipelines import factory as jfactory
from gen3c_tpu.pipelines.factory import GEN3C_TINY_PRESET as JAX_TINY
from gen3c_tpu_torch.bridge import dit_state_from_jax
from gen3c_tpu_torch.diffusion import sampler as tsampler
from gen3c_tpu_torch.models import dit as tdit
from gen3c_tpu_torch.models.gen3c import dit_net_fns
from gen3c_tpu_torch.parallel.mesh import Axis
from gen3c_tpu_torch.pipelines import factory as tfactory
from gen3c_tpu_torch.pipelines.factory import GEN3C_TINY_PRESET

torch.set_num_threads(2)

NUM_BLOCKS = 3


def _pair(dtype=jnp.float32, **over):
    jcfg = dataclasses.replace(JAX_TINY.dit, num_blocks=NUM_BLOCKS, dtype=dtype, **over)
    params = jdit.randomize_degenerate_inits(
        jdit.init_dit_params(jax.random.PRNGKey(0), jcfg, dtype))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    net = tdit.GeneralDIT(dataclasses.replace(GEN3C_TINY_PRESET.dit, num_blocks=NUM_BLOCKS,
                                              dtype=tdtype, **over))
    net.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return params, jcfg, net


def _inputs(seed=0, B=2, T=3, H=8, W=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, JAX_TINY.dit.in_channels, T, H, W)).astype(np.float32)
    t = rng.uniform(-2, 1, (B,)).astype(np.float32)
    ctx = rng.standard_normal((B, 16, 1024)).astype(np.float32)
    return x, t, ctx


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("span", [(1, 2), (0, 3), (0, 1), (2, 2)], ids=str)
def test_span_forwards_match_jax(span):
    params, jcfg, net = _pair(cache_block_span=span, cache_span_dtype="fp32")
    x, t, ctx = _inputs()
    want_out, want_delta = jax.jit(lambda p: jdit.dit_forward(
        p, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), fps=24.0,
        return_span_delta=True))(params)
    with torch.no_grad():
        out, delta = net(*_t(x, t, ctx), fps=24.0, return_span_delta=True)
        plain = net(*_t(x, t, ctx), fps=24.0)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(delta.numpy(), want_delta, rtol=1e-4, atol=1e-4)
    assert torch.equal(out, plain)  # the refresh forward is the plain one
    if span[0] == span[1]:
        assert not delta.any()
    else:
        assert delta.abs().mean() > 1e-3
    # the skip path on JAX's delta, a different latent
    x2 = _inputs(seed=1)[0]
    want_skip = jax.jit(lambda p, d: jdit.dit_forward(
        p, jcfg, jnp.asarray(x2), jnp.asarray(t), jnp.asarray(ctx), fps=24.0,
        span_delta=d))(params, want_delta)
    with torch.no_grad():
        skip = net(*_t(x2, t, ctx), fps=24.0, span_delta=torch.tensor(np.asarray(want_delta)))
    np.testing.assert_allclose(skip.numpy(), want_skip, rtol=1e-4, atol=1e-4)


def test_int8_carry_matches_jax():
    span = (1, 2)
    params, jcfg, net = _pair(cache_block_span=span, cache_span_dtype="int8")
    jcfg32 = dataclasses.replace(jcfg, cache_span_dtype="fp32")
    x, t, ctx = _inputs()
    run = jax.jit(lambda p, c: jdit.dit_forward(p, c, jnp.asarray(x), jnp.asarray(t),
                                               jnp.asarray(ctx), fps=24.0,
                                               return_span_delta=True), static_argnums=1)
    _, (jcodes, jscales) = run(params, jcfg)
    _, jdelta = run(params, jcfg32)
    jcodes, jscales = np.asarray(jcodes), np.asarray(jscales)
    assert jcodes.dtype == np.int8 and jscales.shape == jcodes.shape[:-1] + (1,)
    # the quantizer on JAX's own delta: JAX's codes and scales exactly
    codes, scales = tdit.quantize_span_delta(torch.from_numpy(np.array(jdelta)))
    np.testing.assert_array_equal(scales.numpy(), jscales)
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    # the refresh forward's carry
    with torch.no_grad():
        _, (c, s) = net(*_t(x, t, ctx), fps=24.0, return_span_delta=True)
    assert c.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), jscales, rtol=1e-4, atol=1e-7)
    off = np.abs(c.numpy().astype(np.int16) - jcodes)
    assert off.max() <= 1 and (off > 0).mean() <= 1e-3, (off.max(), (off > 0).mean())
    # the skip path on JAX's int8 carry
    want = jax.jit(lambda p, d: jdit.dit_forward(
        p, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), fps=24.0,
        span_delta=d))(params, (jnp.asarray(jcodes), jnp.asarray(jscales)))
    with torch.no_grad():
        got = net(*_t(x, t, ctx), fps=24.0, span_delta=_t(jcodes, jscales))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_empty_span_int8_carry_is_zero():
    _, _, net = _pair(cache_block_span=(2, 2), cache_span_dtype="int8")
    with torch.no_grad():
        _, (codes, scales) = net(*_t(*_inputs()), fps=24.0, return_span_delta=True)
    assert codes.dtype == torch.int8 and not codes.any() and not scales.any()


def test_bf16_carry_matches_jax():
    """The bf16 DiT keeps the delta in the token dtype (dit.py:1067): the
    difference of two bf16 token tensors, added back in bf16."""
    params, jcfg, net = _pair(jnp.bfloat16, cache_block_span=(1, 2), cache_span_dtype="bf16")
    x, t, ctx = _inputs(seed=5)
    with jax.disable_jit():
        want_out, want_delta = jdit.dit_forward(params, jcfg, jnp.asarray(x), jnp.asarray(t),
                                                jnp.asarray(ctx), fps=24.0,
                                                return_span_delta=True)
        want_skip = jdit.dit_forward(params, jcfg, jnp.asarray(x), jnp.asarray(t),
                                     jnp.asarray(ctx), fps=24.0, span_delta=want_delta)
    with torch.no_grad():
        out, delta = net(*_t(x, t, ctx), fps=24.0, return_span_delta=True)
        skip = net(*_t(x, t, ctx), fps=24.0, span_delta=torch.from_numpy(
            np.asarray(want_delta.astype(jnp.float32))).to(torch.bfloat16))
    assert delta.dtype == torch.bfloat16
    # the delta is a difference of two bf16 token streams whose values here
    # reach 4-8, where one bf16 ulp is 2^-5: its max bound is that ulp
    for got, want, max_err in ((out, want_out, 3e-2), (delta, want_delta, 2 ** -5),
                               (skip, want_skip, 3e-2)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.float().numpy() - want)
        assert np.abs(want).mean() > 0.05
        assert err.max() <= max_err and err.mean() <= 3e-3, (err.max(), err.mean())


def test_span_arguments_need_a_span():
    _, _, net = _pair()
    with pytest.raises(ValueError, match="cache_block_span"):
        net(*_t(*_inputs()), fps=24.0, return_span_delta=True)


def test_block_residuals_match_jax():
    params, jcfg, net = _pair()
    x, t, ctx = _inputs(seed=2, B=1)
    _, want = jax.jit(lambda p: jdit.dit_forward(
        p, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), fps=24.0,
        return_block_residuals=True))(params)
    with torch.no_grad():
        out, got = net(*_t(x, t, ctx), fps=24.0, return_block_residuals=True)
    assert got.shape == (NUM_BLOCKS,) and out.shape[1] == 16
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


# ------------------------------ the sampler ------------------------------


@pytest.fixture(scope="module")
def tiny_models():
    """The tiny preset, JAX's fp32 weights bridged, per span dtype."""
    def build(dtype):
        kw = dict(cache_block_span=(1, 2), cache_span_dtype=dtype)
        jm, preset = jfactory.build_gen3c_model("gen3c_tiny", checkpoint_dir=None, seed=0,
                                                param_dtype=jnp.float32, **kw)
        jm.dit_params = jdit.randomize_degenerate_inits(jm.dit_params)
        tm, _ = tfactory.build_gen3c_model("gen3c_tiny", device="cpu", seed=0, **kw)
        tm.net.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, jm.dit_params)))
        return jm, tm, preset

    return {d: build(d) for d in ("bf16", "int8")}


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_span_sampler_matches_jax(tiny_models, dtype):
    jm, tm, preset = tiny_models[dtype]
    assert tm.net.cfg.cache_block_span == (1, 2) and tm.net.cfg.cache_span_dtype == dtype
    C, T, h, w = preset.state_shape
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((1, 512, 1024)).astype(np.float32)
    cond = rng.standard_normal((1, C, 1, h, w)).astype(np.float32)
    pose = rng.standard_normal((1, 64, T, h, w)).astype(np.float32)
    kw = dict(num_condition_t=1, guidance=2.0, num_steps=6, seed=4, step_cache_interval=2)
    want = np.asarray(jm.generate_samples(jnp.asarray(emb), jnp.asarray(cond),
                                          pose_latent=jnp.asarray(pose), **kw))
    steps = []
    got = tm.generate_samples(*_t(emb, cond, pose), **kw,
                              on_step=lambda i, c, r: steps.append(r)).numpy()
    assert steps == [True, True, True, False, True, True]  # the skip at step 3
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the span changed the trajectory against whole-output caching
    tm.net.cfg = dataclasses.replace(tm.net.cfg, cache_block_span=None)
    try:
        whole = tm.generate_samples(*_t(emb, cond, pose), **kw).numpy()
    finally:
        tm.net.cfg = dataclasses.replace(tm.net.cfg, cache_block_span=(1, 2))
    assert np.abs(whole - got).max() > 1e-3


def test_span_with_threshold_raises_as_jax(tiny_models):
    jm, tm, preset = tiny_models["bf16"]
    C, T, h, w = preset.state_shape
    args = (np.zeros((1, 512, 1024), np.float32), np.zeros((1, C, 1, h, w), np.float32),
            np.zeros((1, 64, T, h, w), np.float32))
    kw = dict(num_steps=4, step_cache_interval=2, step_cache_threshold=0.1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        jm.generate_samples(jnp.asarray(args[0]), jnp.asarray(args[1]),
                            pose_latent=jnp.asarray(args[2]), **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tm.generate_samples(*_t(*args), **kw)


@pytest.mark.parametrize("span", [(1, 0), (0, 3), (-1, 1)], ids=str)
def test_factory_range_check_as_jax(span):
    with pytest.raises(ValueError, match="out of range"):
        jfactory.build_gen3c_model("gen3c_tiny", checkpoint_dir=None, cache_block_span=span)
    with pytest.raises(ValueError, match="out of range"):
        tfactory.build_gen3c_model("gen3c_tiny", device="cpu", cache_block_span=span)


def _loop_inputs():
    rng = np.random.default_rng(0)
    B, C, T, H, W = 1, 16, 2, 4, 4
    ind = np.array([1.0, 0.0]).reshape(1, 1, T, 1, 1)
    arrays = dict(
        init_noise=rng.standard_normal((B, C, T, H, W)),
        augment_noise=rng.standard_normal((B, C, T, H, W)),
        crossattn_cond=rng.standard_normal((B, 8, 1024)), crossattn_uncond=np.zeros((B, 8, 1024)),
        gt_latent=rng.standard_normal((B, C, T, H, W)), condition_video_indicator=ind,
        condition_video_input_mask=np.broadcast_to(ind, (B, 1, T, H, W)),
        pose_latent_cond=rng.standard_normal((B, 64, T, H, W)),
        pose_latent_uncond=np.zeros((B, 64, T, H, W)))
    return {k: np.ascontiguousarray(v, np.float32) for k, v in arrays.items()}


@pytest.mark.parametrize("opts", [
    dict(step_cache_interval=1), dict(step_cache_interval=2, step_cache_threshold=0.1),
    dict(step_cache_interval=2, guidance_interval=(1.75, 81.0)),
], ids=["interval1", "threshold", "guidance-interval"])
def test_span_loop_raises_where_jax_raises(opts):
    params, jcfg, net = _pair(cache_block_span=(1, 2), cache_span_dtype="fp32")
    arrays = _loop_inputs()

    def jnet(p, x, t, c):
        return jdit.dit_forward(p, jcfg, x, t, c, fps=24.0, return_span_delta=True)

    def jskip(p, x, t, c, d):
        return jdit.dit_forward(p, jcfg, x, t, c, fps=24.0, span_delta=d)

    with pytest.raises(ValueError):
        jsampler.generate_samples(jnet, params, **{k: jnp.asarray(v) for k, v in arrays.items()},
                                  num_steps=6, net_fn_skip=jskip, **opts)
    net_fn, skip = dit_net_fns(net, True)
    with pytest.raises(ValueError):
        tsampler.generate_samples(net_fn, **{k: torch.from_numpy(v) for k, v in arrays.items()},
                                  num_steps=6, net_fn_skip=skip, **opts)


def test_span_loop_refuses_the_cfg_axis():
    """As sampler.py:368-373: span caching does not compose with CFG
    parallelism (refused before any collective)."""
    _, _, net = _pair(cache_block_span=(1, 2))
    net_fn, skip = dit_net_fns(net, True)
    with pytest.raises(ValueError, match="cfg_axis"):
        tsampler.generate_samples(net_fn, **{k: torch.from_numpy(v)
                                             for k, v in _loop_inputs().items()},
                                  num_steps=6, step_cache_interval=2, net_fn_skip=skip,
                                  cfg=Axis(None, 0, 2))


# ------------------------------ context parallelism ------------------------------

DIT_KW = dict(in_channels=81, model_channels=64, num_blocks=2, num_heads=4, adaln_lora_dim=8,
              rope_t_extrapolation_ratio=2.0)


@pytest.fixture(scope="module")
def ranks():
    pool = torch_cp_ranks.Ranks(2)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def cp_params():
    jcfg = jdit.DiTConfig(dtype=jnp.float32, **DIT_KW)
    p = jdit.randomize_degenerate_inits(jdit.init_dit_params(jax.random.PRNGKey(0), jcfg,
                                                             jnp.float32))
    state = {k: v.numpy() for k, v in dit_state_from_jax(jax.tree.map(np.asarray, p)).items()}
    return p, state


def _cp_arrays(Tl=4, H=8, W=16):
    rng = np.random.RandomState(0)
    indicator = np.zeros((1, 1, Tl, 1, 1), np.float32)
    indicator[:, :, :1] = 1.0
    arrays = dict(
        init_noise=rng.randn(1, 16, Tl, H, W), augment_noise=rng.randn(1, 16, Tl, H, W),
        crossattn_cond=rng.randn(1, 8, 1024), crossattn_uncond=np.zeros((1, 8, 1024)),
        gt_latent=rng.randn(1, 16, Tl, H, W), condition_video_indicator=indicator,
        condition_video_input_mask=np.broadcast_to(indicator, (1, 1, Tl, H, W)),
        pose_latent_cond=rng.randn(1, 64, Tl, H, W), pose_latent_uncond=np.zeros((1, 64, Tl, H, W)))
    return {k: np.ascontiguousarray(v, np.float32) for k, v in arrays.items()}


@pytest.mark.parametrize("dtype,impl", [("fp32", "ulysses"), ("int8", "ring")])
def test_cp_span_matches_jax_and_single_process(ranks, cp_params, dtype, impl):
    """cp 2 on two gloo ranks: each rank carries its tokens' shard of the
    delta (gen3c_tpu/parallel/cp.py:139-166)."""
    arrays = _cp_arrays()
    span = dict(cache_block_span=(0, 1), cache_span_dtype=dtype, cp_attn_impl=impl)
    opts = dict(num_steps=6, guidance=1.5, step_cache_interval=2)
    ranks.submit("sample", cfg=1, cp=2, dit_kw=dict(DIT_KW, **span), state=cp_params[1],
                 arrays=arrays, opts=opts)
    mesh = make_mesh(dp=1, cfg=1, cp=2, tp=1, devices=jax.devices()[:2])
    want = np.asarray(jax_cp_generate_samples(
        mesh, cp_params[0], jdit.DiTConfig(dtype=jnp.float32, **DIT_KW, **span),
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **opts))
    net = tdit.GeneralDIT(tdit.DiTConfig(dtype=torch.float32, **DIT_KW, **span))
    net.load_state_dict({k: torch.from_numpy(v) for k, v in cp_params[1].items()})
    net_fn, skip = dit_net_fns(net, True)
    steps = []
    single = tsampler.generate_samples(net_fn, **{k: torch.from_numpy(v)
                                                  for k, v in arrays.items()},
                                       net_fn_skip=skip, on_step=lambda i, c, r: steps.append(r),
                                       **opts).numpy()
    got = ranks.collect()
    assert steps == [True, True, True, False, True, True]
    np.testing.assert_array_equal(got[0], got[1])
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got[0], want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[0], single, rtol=1e-4, atol=1e-4)


# ------------------------------ the span ranking ------------------------------


def test_rank_block_contributions_matches_jax(monkeypatch, capsys):
    """scripts/rank_block_contributions.py (JAX, its defaults: gen3c_tiny,
    bf16-stored weights, randomize_degenerate_inits) against the port's
    block_contributions and best_span on the same weights, bridged: the
    per-block residuals rtol 1e-4, the same span. Then the port's CLI on
    its own seeded init."""
    import importlib.util
    import json
    import os
    import sys

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "rank_block_contributions.py")
    spec = importlib.util.spec_from_file_location("jax_rank_blocks", path)
    jscript = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jscript)
    monkeypatch.setattr(sys, "argv", ["rank_block_contributions.py", "--span_width", "1"])
    jscript.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    from gen3c_tpu_torch.scripts import rank_block_contributions as trank

    jm, preset = jfactory.build_gen3c_model("gen3c_tiny", checkpoint_dir=None, seed=0)
    params = jdit.randomize_degenerate_inits(jm.dit_params)
    tm, _ = tfactory.build_gen3c_model("gen3c_tiny", device="cpu", seed=0)
    tm.net.load_state_dict(dit_state_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), params)))
    per_block = trank.block_contributions(tm.net, preset.state_shape, num_sigmas=4, seed=0)
    np.testing.assert_allclose(per_block, want["per_block"], rtol=1e-4, atol=1e-5)
    assert list(trank.best_span(per_block, 1)[:2]) == want["span"]
    got = trank.main(["--device", "cpu", "--num_sigmas", "2"])
    assert len(got["per_block"]) == 2 and got["span"] in ([0, 1], [1, 2])
    assert all(v > 0 for v in got["per_block"])
