"""The port's context- and CFG-parallel denoising against gen3c_tpu on the CPU.

The port runs one process per rank: four spawned CPU ranks joined by gloo
(``torch_cp_ranks``), shared by every test of this file. JAX runs in this
process on the host devices that conftest.py sets up, under
``jax.shard_map``, as tests/test_parallel.py runs it. Both sides get the
same numpy inputs and, for the DiT, the same fp32 weights (gen3c_tpu's
init with the zero-init gates randomized, bridged into the port).

Tolerances: the three self-attention strategies in fp32, atol 1e-5 (the
same sums in another order); the DiT forward and the sampler, rtol/atol
1e-4, as tests/test_parallel.py holds JAX's own parallel runs to its single
device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_cp_ranks
from gen3c_tpu.diffusion.scheduler import EDMEulerSchedule as JaxSchedule
from gen3c_tpu.models import dit as jdit
from gen3c_tpu.parallel.cp import cp_generate_samples as jax_cp_generate_samples
from gen3c_tpu.parallel.mesh import make_mesh
from gen3c_tpu_torch.bridge import dit_state_from_jax
from gen3c_tpu_torch.diffusion import sampler as tsampler
from gen3c_tpu_torch.models import dit as tdit
from gen3c_tpu_torch.parallel import mesh as tmesh
from gen3c_tpu_torch.pipelines import factory as tfactory

torch.set_num_threads(2)

WORLD = 4
# tests/test_parallel.py's tiny DiT
DIT_KW = dict(in_channels=81, model_channels=64, num_blocks=2, num_heads=4, adaln_lora_dim=8,
              rope_t_extrapolation_ratio=2.0)
JCFG = jdit.DiTConfig(dtype=jnp.float32, **DIT_KW)
HW = 8  # tokens per frame of the attention cases
BAND = (HW, 1, 1)


@pytest.fixture(scope="module")
def ranks():
    pool = torch_cp_ranks.Ranks(WORLD)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def params():
    p = jdit.randomize_degenerate_inits(
        jdit.init_dit_params(jax.random.PRNGKey(0), JCFG, jnp.float32))
    state = {k: v.numpy() for k, v in dit_state_from_jax(jax.tree.map(np.asarray, p)).items()}
    return p, state


def _port_net(state, **over):
    net = tdit.GeneralDIT(tdit.DiTConfig(dtype=torch.float32, **DIT_KW, **over))
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return net


def _shards(results, cp):
    """The output shards of the first replica's ranks, in cp-rank order."""
    first = results[:cp]
    assert [r["cp_rank"] for r in first] == list(range(cp))
    return [r["out"] for r in first]


# ------------------------- the three strategies -------------------------


def _jax_cp_attention(q, k, v, cp, impl, band):
    mesh = make_mesh(dp=1, cp=cp, tp=1, devices=jax.devices()[:cp])

    def body(q, k, v):
        if impl == "ulysses":
            return jdit._ulysses_attention(q, k, v, "cp", temporal_band=band)
        if impl == "ring":
            return jdit._ring_attention(q, k, v, "cp", temporal_band=band)
        k = jax.lax.all_gather(k, "cp", axis=1, tiled=True)
        v = jax.lax.all_gather(v, "cp", axis=1, tiled=True)
        return jdit.attention_op(q, k, v)

    seq = P(None, "cp")
    mapped = jax.shard_map(body, mesh=mesh, in_specs=(seq, seq, seq), out_specs=seq,
                           check_vma=False)
    return np.asarray(mapped(*(jnp.asarray(t) for t in (q, k, v))))


def _visible_pairs(q_rank, kv_rank, frames, band):
    """Whether a query shard and a KV shard hold a visible (query frame,
    key frame) pair, counted pair by pair."""
    _, window, prefix = band
    return any(kf < prefix or abs(qf - kf) <= window
               for qf in range(q_rank * frames, (q_rank + 1) * frames)
               for kf in range(kv_rank * frames, (kv_rank + 1) * frames))


# the all-gather strategy refuses a band (test_allgather_refuses_the_band)
_ATTENTION_CASES = [(impl, cp, band) for impl in ("ulysses", "ring", "allgather") for cp in (2, 4)
                    for band in (None, BAND) if impl != "allgather" or band is None]


@pytest.mark.parametrize("impl,cp,band", _ATTENTION_CASES,
                         ids=[f"{i}-cp{c}-{'band' if b else 'full'}" for i, c, b in _ATTENTION_CASES])
def test_cp_self_attention_matches_jax(ranks, impl, cp, band):
    rng = np.random.default_rng(cp)
    B, L, H, D = 2, 8 * HW, 4, 16  # 8 frames: 4 or 2 per shard
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3))
    ranks.submit("attention", cp=cp, impl=impl, q=q, k=k, v=v, band=band)
    want = _jax_cp_attention(q, k, v, cp, impl, band)
    results = ranks.collect()
    got = np.concatenate(_shards(results, cp), axis=1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if impl == "ring":
        frames = L // cp // HW
        for r in results[:cp]:
            skipped = sum(not _visible_pairs(r["cp_rank"], s, frames, band) for s in range(cp)
                          ) if band is not None else 0
            assert r["ring_steps"] == {"folded": cp - skipped, "skipped": skipped}
        if band is not None and cp == 4:
            assert sum(r["ring_steps"]["skipped"] for r in results[:cp]) > 0


def test_allgather_refuses_the_band(params):
    """As dit.py:737-751: the all-gather strategy cannot place a band, in
    either package; an unknown strategy raises too."""
    x = torch.zeros((1, 2 * HW, 4, 16))
    with pytest.raises(ValueError, match="requires cp_attn_impl='ulysses'"):
        tdit.cp_self_attention(x, x, x, tmesh.Axis(None, 0, 2), "allgather", BAND)
    with pytest.raises(ValueError, match="unknown cp_attn_impl"):
        tdit.cp_self_attention(x, x, x, tmesh.Axis(None, 0, 2), "rings")
    cfg_b = dataclasses.replace(JCFG, attn_temporal_window=1)
    mesh = make_mesh(dp=1, cp=2, tp=1, devices=jax.devices()[:2])

    def body(x, t, ctx):
        return jdit.dit_forward(params[0], cfg_b, x, t, ctx, fps=24.0, cp_axis="cp")

    seq = P(None, None, "cp")
    mapped = jax.shard_map(body, mesh=mesh, in_specs=(seq, P(), P()), out_specs=seq,
                           check_vma=False)
    with pytest.raises(ValueError, match="requires cp_attn_impl='ulysses'"):
        mapped(jnp.zeros((1, 81, 2, 8, 16)), jnp.zeros((1,)), jnp.zeros((1, 8, 1024)))


# ------------------------- the DiT under a cp axis -------------------------


def test_position_tables_slice_as_jax(params):
    """A rank's RoPE table and extra position embedding are rows of the
    tables of the whole T * cp grid, as dit.py:929-946 slices them."""
    net = _port_net(params[1])
    Tp, Hp, Wp, cp = 2, 4, 8, 3
    L = Tp * Hp * Wp
    jc, js = jdit.rope_3d_table(JCFG, Tp * cp, Hp, Wp, fps=24.0)
    jextra = np.asarray(jdit.build_extra_pos_emb(params[0], Tp * cp, Hp, Wp))
    for rank in range(cp):
        cos, sin = net.rope(Tp, Hp, Wp, 24.0, torch.device("cpu"), rank, cp)
        np.testing.assert_array_equal(cos.numpy(), np.asarray(jc)[rank * L:(rank + 1) * L])
        np.testing.assert_array_equal(sin.numpy(), np.asarray(js)[rank * L:(rank + 1) * L])
        extra = net.extra_pos_embedder(Tp * cp, Hp, Wp)[rank * Tp:(rank + 1) * Tp]
        np.testing.assert_allclose(extra.detach().numpy(), jextra[rank * Tp:(rank + 1) * Tp],
                                   atol=1e-6, rtol=0)
    # the cache keeps one table per rank
    assert not torch.equal(net.rope(Tp, Hp, Wp, 24.0, "cpu", 0, 2)[0],
                           net.rope(Tp, Hp, Wp, 24.0, "cpu", 1, 2)[0])


_FORWARD_CASES = [("ulysses", None), ("ring", None), ("allgather", None), ("ulysses", 1),
                  ("ring", 1)]


@pytest.mark.parametrize("impl,window", _FORWARD_CASES,
                         ids=[f"{i}-w{w}" for i, w in _FORWARD_CASES])
def test_cp_forward_matches_jax(ranks, params, impl, window):
    """GeneralDIT.forward on each rank's latent-T shard (cp = 2) against
    JAX's dit_forward on the whole latent (test_parallel.py:238, :630, :673:
    JAX's own shard_map forward equals it to 1e-4)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 81, 4, 8, 16)).astype(np.float32)
    t = np.asarray([0.4], np.float32)
    ctx = rng.standard_normal((1, 8, 1024)).astype(np.float32)
    kw = dict(DIT_KW, cp_attn_impl=impl, attn_temporal_window=window)
    ranks.submit("forward", cp=2, dit_kw=kw, state=params[1], x=x, t=t, ctx=ctx)
    cfg = dataclasses.replace(JCFG, attn_temporal_window=window)
    want = np.asarray(jax.jit(jdit.dit_forward, static_argnames=("cfg", "fps"))(
        params[0], cfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), fps=24.0))
    got = np.concatenate(_shards(ranks.collect(), 2), axis=2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if window is not None:  # the band is live on these weights
        full = np.asarray(jdit.dit_forward(params[0], JCFG, jnp.asarray(x), jnp.asarray(t),
                                           jnp.asarray(ctx), fps=24.0))
        assert np.abs(want - full).max() > 1e-6


# ------------------------------ the sampler ------------------------------


def _sample_arrays(Tl=4, H=8, W=16):
    """tests/test_parallel.py's _sample_args, from a numpy seed."""
    rng = np.random.RandomState(0)
    indicator = np.zeros((1, 1, Tl, 1, 1), np.float32)
    indicator[:, :, :1] = 1.0
    arrays = dict(
        init_noise=rng.randn(1, 16, Tl, H, W), augment_noise=rng.randn(1, 16, Tl, H, W),
        crossattn_cond=rng.randn(1, 8, 1024), crossattn_uncond=np.zeros((1, 8, 1024)),
        gt_latent=rng.randn(1, 16, Tl, H, W), condition_video_indicator=indicator,
        condition_video_input_mask=np.zeros((1, 1, Tl, H, W)),
        pose_latent_cond=rng.randn(1, 64, Tl, H, W), pose_latent_uncond=np.zeros((1, 64, Tl, H, W)))
    return {k: np.ascontiguousarray(v, np.float32) for k, v in arrays.items()}


def _interval(steps, first_cfg_step):
    """A guidance interval that runs CFG on the steps before
    first_cfg_step's sigma (tests/test_parallel.py:86-87, :172-173)."""
    sig = np.asarray(JaxSchedule().sigmas(steps))
    return (float(sig[first_cfg_step]), float(sig[0]) + 1.0)


# (name, cfg, cp, cp_attn, steps, options)
_SAMPLER_CASES = [
    ("cp2-ulysses", 1, 2, "ulysses", 3, dict(guidance=1.5)),
    ("cp2-ring-rescale", 1, 2, "ring", 3, dict(guidance=1.5, cfg_rescale=0.5)),
    ("cp2-allgather-adaptive", 1, 2, "allgather", 6, dict(guidance=1.5, step_cache_threshold=0.1)),
    ("cfg2-interval-rescale", 2, 1, "allgather", 3,
     dict(guidance=1.5, guidance_interval=_interval(3, 1), cfg_rescale=0.7)),
    ("cfg2cp2-ulysses-interval-cache", 2, 2, "ulysses", 6,
     dict(guidance=1.5, guidance_interval=_interval(6, 3), step_cache_interval=2)),
    # CFG on steps 0-2 of 8, refreshes on 0, 1, 2, 4, 6, 7: the condition-only
    # step 3 reads the cache, which under the cfg axis holds step 2's
    # combined output (sampler.py:494-531), where one process keeps the raw
    # cond half; so this case is held to JAX's cfg axis alone
    ("cfg2-cond-only-cached", 2, 1, "allgather", 8,
     dict(guidance=1.5, guidance_interval=_interval(8, 2), step_cache_interval=2)),
]


@pytest.mark.parametrize("name,cfg,cp,impl,steps,opts", _SAMPLER_CASES,
                         ids=[c[0] for c in _SAMPLER_CASES])
def test_cp_generate_samples_matches_jax(ranks, params, name, cfg, cp, impl, steps, opts):
    """parallel.cp.cp_generate_samples on the ranks against JAX's
    cp_generate_samples on the same layout, and (but for the case that
    JAX's cfg axis itself runs otherwise) against the port's single
    process; every rank returns the whole latent."""
    arrays = _sample_arrays()
    kw = dict(DIT_KW, cp_attn_impl=impl)
    ranks.submit("sample", cfg=cfg, cp=cp, dit_kw=kw, state=params[1], arrays=arrays,
                 opts=dict(num_steps=steps, **opts))
    mesh = make_mesh(dp=1, cfg=cfg, cp=cp, tp=1, devices=jax.devices()[:cfg * cp])
    want = np.asarray(jax_cp_generate_samples(
        mesh, params[0], dataclasses.replace(JCFG, cp_attn_impl=impl), num_steps=steps,
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **opts))
    net = _port_net(params[1])
    single = tsampler.generate_samples(
        lambda x, t, c: net(x, t, c, fps=24.0),
        **{k: torch.from_numpy(v) for k, v in arrays.items()}, num_steps=steps, **opts).numpy()
    got = ranks.collect()
    assert np.abs(want).max() > 0.5
    for r in got:
        np.testing.assert_array_equal(r, got[0])
    np.testing.assert_allclose(got[0], want, rtol=1e-4, atol=1e-4)
    if name == "cfg2-cond-only-cached":
        assert np.abs(got[0] - single).max() > 1e-3  # the cached outputs differ
    else:
        np.testing.assert_allclose(got[0], single, rtol=1e-4, atol=1e-4)


def test_cfg_parallel_refuses_adaptive_caching():
    """As test_parallel.py:196: the cfg axis composes with the plain and
    fixed-interval-cached loops only; refused before any collective."""
    arrays = {k: torch.from_numpy(v) for k, v in _sample_arrays().items()}
    with pytest.raises(ValueError, match="cfg_axis"):
        tsampler.generate_samples(lambda x, t, c: x[:, :16], **arrays, num_steps=3,
                                  step_cache_threshold=0.05, cfg=tmesh.Axis(None, 0, 2))


# ------------------------------ strategies ------------------------------


@pytest.mark.parametrize("parallel,want", [("cp", (1, None, 1, False)), ("cfg2", (2, 1, 1, False)),
                                           ("cfg2cp4", (2, 4, 1, False))])
def test_parse_parallel(parallel, want):
    assert tfactory.parse_parallel(parallel) == want


def test_strategy_validation_as_jax():
    """test_parallel.py:481: an unknown strategy raises at any device count;
    a job whose size is not num_devices, a band over the all-gather
    strategy, an unknown cp_attn and a mesh larger than the job raise too
    (the tensor-parallel strategies: tests/test_torch_tp.py)."""
    from gen3c_tpu.pipelines.factory import build_gen3c_model as jax_build

    for n in (1, 4):
        with pytest.raises(ValueError, match="unknown parallel strategy"):
            jax_build("gen3c_tiny", num_devices=n, parallel="nonsense")
        with pytest.raises(ValueError, match="unknown parallel strategy"):
            tfactory.build_gen3c_model("gen3c_tiny", device="cpu", num_devices=n,
                                       parallel="nonsense")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        tfactory.build_gen3c_model("gen3c_tiny", device="cpu", num_devices=2)
    with pytest.raises(ValueError, match="requires cp_attn='ulysses' or 'ring'"):
        tfactory.build_gen3c_model("gen3c_tiny", device="cpu", num_devices=2,
                                   attn_temporal_window=1)
    with pytest.raises(ValueError, match="unknown cp_attn"):
        tfactory.build_gen3c_model("gen3c_tiny", device="cpu", cp_attn="rings")
    with pytest.raises(ValueError, match="dp\\*cfg\\*cp\\*tp = 4 ranks, but the world size is 1"):
        tmesh.make_groups(tp=2, cp=2)
    with pytest.raises(ValueError, match="world size is 1"):
        tmesh.make_groups(cp=2)
    assert tmesh.make_groups() == tmesh.Groups() and not tmesh.Groups().parallel
    assert tmesh.maybe_distributed_init("gloo", "cpu") is False  # no torchrun environment
