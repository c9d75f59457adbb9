"""The port's ODE solvers and the sampler's multistep solvers against gen3c_tpu.

``diffusion.solvers.sample_ode`` runs every one of its seven solvers with a
small analytic denoiser on numpy-seeded noise in both packages; both step
functions are held on degenerate lanes (t = 0, s1 == s). The sampler's
dpm2m and res2ab finishes run in the plain loop, with guidance-interval
segments and with CFG rescale, against gen3c_tpu's generate_samples with
the same analytic network (tests/test_torch_sampler_options.py's), and
under a 2-rank CFG axis (two spawned gloo CPU ranks, ``torch_cp_ranks``)
with the tiny DiT against JAX's cfg shard_map.

Tolerances: fp32 on both sides with the same elementwise operations, atol
1e-5 (XLA may contract or reorder a product, 1 ulp at a time); the CFG axis
case with the DiT, rtol/atol 1e-4 as tests/test_torch_parallel.py holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cp_ranks
from gen3c_tpu.diffusion import sampler as jsampler
from gen3c_tpu.diffusion import solvers as jsolvers
from gen3c_tpu.diffusion.scheduler import EDMEulerSchedule as JaxSchedule
from gen3c_tpu.models import dit as jdit
from gen3c_tpu.parallel.cp import cp_generate_samples as jax_cp_generate_samples
from gen3c_tpu.parallel.mesh import make_mesh
from gen3c_tpu_torch.bridge import dit_state_from_jax
from gen3c_tpu_torch.diffusion import sampler as tsampler
from gen3c_tpu_torch.diffusion import solvers as tsolvers
from gen3c_tpu_torch.parallel.mesh import Axis

torch.set_num_threads(2)

B, C, T, H, W, P = 1, 16, 3, 6, 8, 8
ATOL = 1e-5


def _jax_x0(x, sigma):
    return jnp.tanh(0.7 * x) * (2.0 / (1.0 + 0.1 * sigma)) + 0.3 * jnp.sin(x)


def _torch_x0(x, sigma):
    return torch.tanh(0.7 * x) * (2.0 / (1.0 + 0.1 * sigma)) + 0.3 * torch.sin(x)


@pytest.mark.parametrize("solver", tsolvers.SOLVERS)
def test_sample_ode_matches_jax(solver):
    assert tsolvers.SOLVERS == jsolvers.SOLVERS
    noise = np.random.RandomState(3).standard_normal((1, 4, 3, 5, 6)).astype(np.float32)
    want = np.asarray(jsolvers.sample_ode(_jax_x0, jnp.asarray(noise), num_steps=8,
                                          solver=solver))
    got = tsolvers.sample_ode(_torch_x0, torch.from_numpy(noise), num_steps=8,
                              solver=solver).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_sample_ode_refuses_an_unknown_solver():
    with pytest.raises(ValueError, match="unknown solver"):
        tsolvers.sample_ode(_torch_x0, torch.zeros(1, 2, 1, 2, 2), num_steps=2, solver="dpm3")


# (t, s, s1): the last step (t = 0), the first (s1 == s), both, and a regular one
_LANES = [(0.0, 2.0, 3.0), (1.0, 2.0, 2.0), (0.0, 2.0, 2.0), (0.7, 1.3, 2.9)]


@pytest.mark.parametrize("step", ["dpm2m_x0_step", "res_x0_rk2_step"])
@pytest.mark.parametrize("lane", _LANES, ids=lambda v: "-".join(map(str, v)))
def test_step_functions_on_degenerate_lanes(step, lane):
    """Both step functions stay finite where the sampler's branch would not
    take them, and agree with JAX's there and on a regular step."""
    rng = np.random.RandomState(5)
    x_s, x0_s, x0_s1 = (rng.standard_normal((2, 3, 4)).astype(np.float32) for _ in range(3))
    t, s, s1 = lane
    want = np.asarray(getattr(jsolvers, step)(
        jnp.asarray(x_s), jnp.float32(t), jnp.float32(s), jnp.asarray(x0_s), jnp.float32(s1),
        jnp.asarray(x0_s1)))
    got = getattr(tsolvers, step)(torch.from_numpy(x_s), t, s, torch.from_numpy(x0_s), s1,
                                  torch.from_numpy(x0_s1)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ------------------------------ the sampler ------------------------------


def _jax_net(w, x, t, ctx):
    """tests/test_torch_sampler_options.py's analytic network."""
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
    ind = np.array([1.0, 0.0, 0.0]).reshape(1, 1, T, 1, 1)
    arrays = dict(
        init_noise=rng.standard_normal(shape), augment_noise=rng.standard_normal(shape),
        crossattn_cond=rng.standard_normal((B, 16, 32)), crossattn_uncond=np.zeros((B, 16, 32)),
        gt_latent=rng.standard_normal(shape), condition_video_indicator=ind,
        condition_video_input_mask=np.broadcast_to(ind, (B, 1, T, H, W)),
        pose_latent_cond=rng.standard_normal((B, P, T, H, W)),
        pose_latent_uncond=np.zeros((B, P, T, H, W)),
    )
    return {k: np.ascontiguousarray(v, np.float32) for k, v in arrays.items()}


_OPTIONS = [
    dict(),
    dict(guidance_interval=(1.75, 81.0)),
    dict(guidance_interval=(0.5, 5.0)),  # CFG starts late: cond-only, CFG, cond-only
    dict(cfg_rescale=0.7),
    dict(guidance_interval=(0.5, 20.0), cfg_rescale=0.5),
]


@pytest.mark.parametrize("solver", ["dpm2m", "res2ab"])
@pytest.mark.parametrize("opts", _OPTIONS, ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items())
                         or "plain")
def test_generate_samples_multistep_matches_jax(solver, opts):
    arrays = _sampler_inputs()
    kw = dict(num_steps=10, guidance=2.0, solver=solver)
    want = np.asarray(jsampler.generate_samples(
        _jax_net, jnp.float32(0.7), **{k: jnp.asarray(v) for k, v in arrays.items()},
        **kw, **opts))
    steps = []
    got = tsampler.generate_samples(
        _torch_net, **{k: torch.from_numpy(v) for k, v in arrays.items()}, **kw, **opts,
        on_step=lambda i, cfg, refresh: steps.append((cfg, refresh))).numpy()
    euler = tsampler.generate_samples(
        _torch_net, **{k: torch.from_numpy(v) for k, v in arrays.items()},
        **dict(kw, solver="euler"), **opts).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(got - euler).max() > 1e-3  # the multistep rule changed the trajectory
    assert len(steps) == 10 and all(r for _, r in steps)
    if opts.get("guidance_interval"):
        assert not all(c for c, _ in steps)


def test_generate_samples_without_mask_or_pose_matches_jax():
    """text2world's inputs: no input mask and no pose latent (the net sees
    the latent's channels alone)."""
    arrays = _sampler_inputs()
    for k in ("condition_video_input_mask", "pose_latent_cond", "pose_latent_uncond"):
        arrays.pop(k)
    arrays["condition_video_indicator"] = np.zeros((1, 1, T, 1, 1), np.float32)

    def jnet(w, x, t, ctx):
        assert x.shape[1] == C
        return jnp.tanh(w * x) * (1.0 + 0.1 * t[:, None, None, None, None]) \
            + 0.05 * ctx.mean(axis=(1, 2))[:, None, None, None, None]

    def tnet(x, t, ctx):
        assert x.shape[1] == C
        return torch.tanh(0.7 * x) * (1.0 + 0.1 * t[:, None, None, None, None]) \
            + 0.05 * ctx.mean(dim=(1, 2))[:, None, None, None, None]

    for solver in ("euler", "dpm2m"):
        want = np.asarray(jsampler.generate_samples(
            jnet, jnp.float32(0.7), **{k: jnp.asarray(v) for k, v in arrays.items()},
            num_steps=6, guidance=3.0, solver=solver))
        got = tsampler.generate_samples(tnet, **{k: torch.from_numpy(v) for k, v in arrays.items()},
                                        num_steps=6, guidance=3.0, solver=solver).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _skip(x, t, ctx, delta):
    return x[:, :C]


@pytest.mark.parametrize("opts", [
    dict(solver="heun"), dict(solver="dpm2m", step_cache_interval=2),
    dict(solver="res2ab", step_cache_threshold=0.1),
    dict(solver="dpm2m", net_fn_skip=True, step_cache_interval=2),
    dict(solver="res2ab", net_fn_skip=True),
    dict(solver="dpm2m", guidance_interval=(5.0, 1.0)),
])
def test_multistep_raises_where_jax_raises(opts):
    arrays = _sampler_inputs()
    jopts = dict(opts, net_fn_skip=_skip) if opts.get("net_fn_skip") else opts
    with pytest.raises(ValueError):
        jsampler.generate_samples(_jax_net, jnp.float32(0.7),
                                  **{k: jnp.asarray(v) for k, v in arrays.items()},
                                  num_steps=8, **jopts)
    with pytest.raises(ValueError):
        tsampler.generate_samples(_torch_net, **{k: torch.from_numpy(v) for k, v in arrays.items()},
                                  num_steps=8, **jopts)


def test_multistep_under_the_cfg_axis_raises_with_caching():
    """JAX's cfg-axis multistep path refuses step caching (sampler.py:425);
    the check comes before any collective, so an axis object is enough."""
    arrays = {k: torch.from_numpy(v) for k, v in _sampler_inputs().items()}
    with pytest.raises(ValueError, match="multistep"):
        tsampler.generate_samples(_torch_net, **arrays, num_steps=8, solver="res2ab",
                                  step_cache_interval=2, cfg=Axis(None, 0, 2))


# ------------------------------ the CFG axis ------------------------------

DIT_KW = dict(in_channels=81, model_channels=64, num_blocks=2, num_heads=4, adaln_lora_dim=8,
              rope_t_extrapolation_ratio=2.0)
JCFG = jdit.DiTConfig(dtype=jnp.float32, **DIT_KW)


@pytest.fixture(scope="module")
def ranks():
    pool = torch_cp_ranks.Ranks(2)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def params():
    p = jdit.randomize_degenerate_inits(
        jdit.init_dit_params(jax.random.PRNGKey(0), JCFG, jnp.float32))
    state = {k: v.numpy() for k, v in dit_state_from_jax(jax.tree.map(np.asarray, p)).items()}
    return p, state


def _dit_arrays(Tl=4, H=8, W=16):
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


@pytest.mark.parametrize("solver,steps,first_cfg_step", [("dpm2m", 5, None), ("res2ab", 6, 3)])
def test_multistep_under_the_cfg_axis_matches_jax(ranks, params, solver, steps, first_cfg_step):
    """cfg2 on two gloo ranks: each rank runs its half of the pair, the
    all-reduce combines them and the multistep rule reads the combined
    output (sampler.py:435-476), in the CFG segment and the condition-only
    ones; against JAX's cfg shard_map and the port's single process."""
    arrays = _dit_arrays()
    opts = dict(num_steps=steps, guidance=1.5, solver=solver)
    if first_cfg_step is not None:
        sig = np.asarray(JaxSchedule().sigmas(steps))
        opts["guidance_interval"] = (float(sig[first_cfg_step]), float(sig[0]) + 1.0)
    ranks.submit("sample", cfg=2, cp=1, dit_kw=DIT_KW, state=params[1], arrays=arrays, opts=opts)
    mesh = make_mesh(dp=1, cfg=2, cp=1, tp=1, devices=jax.devices()[:2])
    want = np.asarray(jax_cp_generate_samples(
        mesh, params[0], JCFG, **{k: jnp.asarray(v) for k, v in arrays.items()}, **opts))
    from gen3c_tpu_torch.models import dit as tdit

    net = tdit.GeneralDIT(tdit.DiTConfig(dtype=torch.float32, **DIT_KW))
    net.load_state_dict({k: torch.from_numpy(v) for k, v in params[1].items()})
    single = tsampler.generate_samples(lambda x, t, c: net(x, t, c, fps=24.0),
                                       **{k: torch.from_numpy(v) for k, v in arrays.items()},
                                       **opts).numpy()
    got = ranks.collect()
    np.testing.assert_array_equal(got[0], got[1])
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got[0], want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[0], single, rtol=1e-4, atol=1e-4)
