"""Band training (``attn_temporal_window``) of the port against gen3c_tpu on the CPU.

On the CPU, gen3c_tpu's attention_op takes its dense-mask XLA branch
(dit.py:511-517) for the temporal band, and the port's ``kernels.attention``
its plain versions (``attention_forward_reference`` and, as the backward,
``attention_backward_reference``: K4-band's plain version). The tiny
preset's DiT (fp32, gates and final linear randomized) is bridged into the
port, and the port is handed JAX's random draws.

Tolerances (fp32 on both sides, sums in another order):
  * the plain band backward against jax.vjp: max |delta| <= 1e-5 of the
    gradient's max |.|;
  * train steps: loss and grad-norm rtol 1e-4, params within 0.05 * lr
    (as tests/test_torch_training.py, for the same reason: Adam's first
    steps turn the sign of a ~0 gradient into a full +-lr step);
  * LoRA steps: loss rtol 1e-4, adapters within 0.05 * lr;
  * a window covering every frame: bitwise the full-attention step, as
    tests/test_sparse_attention.py asserts for gen3c_tpu.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.models import dit as jdit
from gen3c_tpu.pipelines.factory import GEN3C_TINY_PRESET as JAX_TINY
from gen3c_tpu.training import lora as jlora
from gen3c_tpu.training import losses as jlosses
from gen3c_tpu.training import train_step as jts
from gen3c_tpu_torch import kernels
from gen3c_tpu_torch.bridge import dit_state_from_jax, lora_state_from_jax
from gen3c_tpu_torch.kernels.reference import (
    attention_backward_reference,
    attention_forward_reference,
)
from gen3c_tpu_torch.models.dit import GeneralDIT
from gen3c_tpu_torch.pipelines.factory import GEN3C_TINY_PRESET
from gen3c_tpu_torch.training import lora as tlora
from gen3c_tpu_torch.training import train_step as tts

torch.set_num_threads(2)
B, T, H, W = 1, 4, 8, 12  # 4 latent frames of 4 x 6 = 24 tokens
LR = 1e-3


def _cfgs(window):
    return (dataclasses.replace(JAX_TINY.dit, attn_temporal_window=window),
            dataclasses.replace(GEN3C_TINY_PRESET.dit, attn_temporal_window=window))


@pytest.fixture(scope="module")
def jparams():
    return jdit.randomize_degenerate_inits(
        jdit.init_dit_params(jax.random.PRNGKey(0), JAX_TINY.dit))


def _port_net(jtree, cfg):
    net = GeneralDIT(cfg)
    net.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, jtree)), strict=True)
    return net


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"x0": rng.standard_normal((B, 16, T, H, W)).astype(np.float32),
            "crossattn_emb": rng.standard_normal((B, 16, 1024)).astype(np.float32),
            "extra_channels": rng.standard_normal(
                (B, JAX_TINY.dit.in_channels - 16, T, H, W)).astype(np.float32)}


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("l,band", [(60, (12, 0, 2)), (60, (10, 2, 0)), (61, (9, 1, 3)),
                                    (48, (16, 1, 1)), (50, (7, 3, 1))])
def test_band_backward_reference_matches_jax_vjp(l, band):
    """K4-band's plain version against jax.vjp of attention_op with the
    band, at ragged frames (tokens per frame not dividing L) and prefixes
    0 to 3."""
    rng = np.random.default_rng(l + band[0])
    q, k, v, do = (rng.standard_normal((2, l, 3, 16)).astype(np.float32) for _ in range(4))
    out_j, vjp = jax.vjp(lambda a, b_, c: jdit.attention_op(a, b_, c, temporal_band=band),
                         *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    out, lse = attention_forward_reference(tq, tk, tv, band)
    _close(out, out_j, 1e-5, "out")
    for name, g, w in zip("qkv", attention_backward_reference(tq, tk, tv, out, tdo, lse, band),
                          want):
        _close(g, w, 1e-5, "d" + name)


def _jax_draws(rng, shape):
    """gen3c_tpu train_step's sigma and noise (its six-way key split)."""
    k_sigma, k_noise = jax.random.split(rng, 6)[:2]
    return tts.StepDraws(
        sigma=torch.from_numpy(np.array(jlosses.sample_sigma(k_sigma, shape[0]))),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))))


@pytest.mark.parametrize("window", [0, 1])
def test_band_train_steps_match_jax(jparams, window):
    """Two full-state train_steps (warmup 1: lr 0, then lr) under the band,
    against jax.jit(train_step): loss and grad-norm per step, then params;
    the band is what the attention ran (the plain band backward, no K4)."""
    jcfg, tcfg = _cfgs(window)
    jopt = jts.make_optimizer(lr=LR, warmup_steps=1)
    jstate = jts.init_train_state(jparams, jopt)
    jstep = jax.jit(partial(jts.train_step, cfg=jcfg, optimizer=jopt))
    opt = tts.make_optimizer(lr=LR, warmup_steps=1)
    net = _port_net(jparams, tcfg)
    state = tts.init_train_state(net, opt)
    for i in range(2):
        batch = _batch(30 + i)
        rng = jax.random.PRNGKey(300 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        state, m = tts.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
                                  tcfg, opt, draws=_jax_draws(rng, batch["x0"].shape))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = dit_state_from_jax(jax.tree.map(np.asarray, jstate.params))
    for n, p in net.named_parameters():
        err = (p.detach() - want[n]).abs().max().item()
        assert err <= 0.05 * LR, (n, err)


def test_band_full_window_is_the_full_attention_step(jparams):
    """A window over every frame: the same loss, gradient norm and updated
    params, bit for bit, as full attention (tests/test_sparse_attention.py's
    check of gen3c_tpu, on the port)."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(40).items()}
    draws = tts.draw_step(torch.Generator().manual_seed(41), batch["x0"].shape, False, False)
    results = []
    for window in (None, T - 1, T + 3):
        _, tcfg = _cfgs(window)
        opt = tts.make_optimizer(lr=LR, warmup_steps=1)
        state = tts.init_train_state(_port_net(jparams, tcfg), opt)
        for _ in range(2):
            state, m = tts.train_step(state, batch, None, tcfg, opt, draws=draws, remat=True)
        results.append((m, state.named_params()))
    (m0, p0) = results[0]
    for m, p in results[1:]:
        assert torch.equal(m["loss"], m0["loss"]) and torch.equal(m["grad_norm"], m0["grad_norm"])
        assert all(torch.equal(p[n], p0[n]) for n in p0)
    _, narrow = _cfgs(0)  # a narrow window is another step
    opt = tts.make_optimizer(lr=LR, warmup_steps=1)
    _, m = tts.train_step(tts.init_train_state(_port_net(jparams, narrow), opt), batch, None,
                          narrow, opt, draws=draws)
    assert float(m["loss"]) != float(m0["loss"])


def test_band_attention_backward_is_the_plain_band_backward():
    """With a band and a gradient to track, kernels.attention on the CPU is
    the autograd Function whose backward is attention_backward_reference
    with the band (K4-band's plain version), launching no kernel."""
    rng = np.random.default_rng(5)
    band = (10, 1, 1)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 45, 2, 8)).astype(np.float32))
                   for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(kernels.launch_counts)
    out = kernels.attention(*leaves, band=band)
    got = torch.autograd.grad(out, leaves, do)
    assert kernels.launch_counts == before
    ref_out, lse = attention_forward_reference(q, k, v, band)
    assert torch.equal(out.detach(), ref_out)
    for g, w in zip(got, attention_backward_reference(q, k, v, ref_out, do, lse, band)):
        assert torch.equal(g, w)


def test_lora_band_steps_match_jax(jparams):
    """LoRA over the frozen base with the band (window 1, prefix 1): three
    steps of gen3c_tpu's jitted lora_train_step against the port's, with
    remat on the port's side (it changes no bit)."""
    jcfg, tcfg = _cfgs(1)
    jopt = jts.make_optimizer(lr=LR, warmup_steps=2)
    jl = jlora.init_lora_params(jax.random.PRNGKey(1), jparams, rank=4)
    jstate = jopt.init(jl)
    jstep = jax.jit(partial(jlora.lora_train_step, cfg=jcfg, optimizer=jopt))
    net = _port_net(jparams, tcfg)
    tl = lora_state_from_jax(jax.tree.map(np.asarray, jl))
    opt = tts.make_optimizer(lr=LR, warmup_steps=2)
    state = opt.init(tlora.lora_leaves(tl))
    for i in range(3):
        batch = _batch(50 + i)
        rng = jax.random.PRNGKey(500 + i)
        jl, jstate, jm = jstep(jl, jstate, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                               rng)
        k_sigma, k_noise = jax.random.split(rng)
        draws = tts.StepDraws(
            sigma=torch.from_numpy(np.array(jlosses.sample_sigma(k_sigma, B))),
            noise=torch.from_numpy(np.array(jax.random.normal(k_noise, batch["x0"].shape))))
        tl, state, m = tlora.lora_train_step(tl, state, net,
                                             {k: torch.from_numpy(v) for k, v in batch.items()},
                                             None, tcfg, opt, remat=True, draws=draws)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    want = lora_state_from_jax(jax.tree.map(np.asarray, jl))
    assert max(ab["b"].abs().max().item() for ab in want.values()) > LR
    for p, ab in want.items():
        for key in "ab":
            err = (tl[p][key].detach() - ab[key]).abs().max().item()
            assert err <= 0.05 * LR, (p, key, err)
