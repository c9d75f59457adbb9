"""The port's tokenizer training against gen3c_tpu's on the CPU.

A tiny causal VAE (8 channels, attention at 8 x 8) with JAX's seeded
weights (``bridge.vae_state_from_jax``, the identity), a seeded random
VGG16 for LPIPS and numpy videos go into both. fp32 on both sides: each
loss term to rtol 1e-4, the loss's gradient to 1e-3 of each leaf's
largest element (the L1 terms' signs flip where input and reconstruction
all but agree; the VAE's convolutions sum in other orders; JAX jitted), and
two AdamW steps (lr 1e-3) to atol 1e-5 on 99% of the weights (AdamW turns a
noise-floor gradient into a step of about lr of either sign); on plain
tensors the optimizer is optax.adamw's arithmetic to 1e-7. The CLI's saved
npz loads into JAX's ``init_vae_params`` tree.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gen3c_tpu.models import vae as jvae
from gen3c_tpu.training import lpips as jl
from gen3c_tpu.training import tokenizer_train as jt
from gen3c_tpu.utils.checkpoint import load_params_npz
from gen3c_tpu_torch.bridge import vae_state_from_jax
from gen3c_tpu_torch.models import vae as tvae
from gen3c_tpu_torch.training import lpips as tl
from gen3c_tpu_torch.training import tokenizer_train as tt
from gen3c_tpu_torch.training.train_step import AdamW

torch.set_num_threads(2)

JCFG = jvae.VAEConfig(channels=8, channels_mult=(2, 4, 4), num_res_blocks=1,
                      attn_resolutions=(8,), resolution=32, patch_size=4, latent_channels=4,
                      z_channels=4)
TCFG = tvae.VAEConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)
                         if f.name != "dtype"})
SCHEDULES = {"l1": ((2, 5), (0.5, 1.0, 2.0)), "grad": ((3,), (0.0,)),
             "perceptual": ((1,), (1.0, 0.25)), "consistency": ((4,), (1.0, 0.5))}


@pytest.fixture(scope="module")
def models():
    jp = jvae.init_vae_params(jax.random.PRNGKey(0), JCFG)
    tp = {n: t.clone().requires_grad_(True)
          for n, t in vae_state_from_jax({k: np.asarray(v) for k, v in jp.items()}).items()}
    rng = np.random.RandomState(1)
    sd = {}
    for idx, cin, cout in jl.VGG16_CONVS:
        sd[f"features.{idx}.weight"] = (rng.randn(cout, cin, 3, 3) * (2.0 / (cin * 9)) ** 0.5
                                        ).astype(np.float32)
        sd[f"features.{idx}.bias"] = np.zeros(cout, np.float32)
    return jp, tp, jl.convert_vgg16_state_dict(sd), tl.convert_vgg16_state_dict(sd)


def _video(seed=2, t=17):
    return (np.random.RandomState(seed).rand(1, 3, t, 32, 32) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("it", [0, 1, 2, 3, 4, 5, 7, 100])
def test_piecewise_weight_matches_jax(it):
    for b, v in (((2, 5), (0.5, 1.0, 2.0)), ((3,), (0.0,)), ((1, 4), (1.0, 0.25))):
        assert float(tt.piecewise_weight(it, b, v)) == float(jt.piecewise_weight(
            jnp.asarray(it), b, v))


def test_consistency_windows_match_jax():
    v = _video(3)
    want = jt.video_consistency_windows(jnp.asarray(v), 9, 4)
    got = tt.video_consistency_windows(torch.from_numpy(v), 9, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tt.video_consistency_windows(torch.from_numpy(v), 18, 1)


_COMMON = dict(w_consistency=0.5, consistency_frames=9, consistency_step=8, w_gram=0.1,
               w_flow=0.5, schedules=SCHEDULES)


@pytest.fixture(scope="module")
def jax_loss_and_grads(models):
    """The JAX side, jitted once with the iteration traced (op by op it
    takes minutes)."""
    jp, _, jlp, _ = models
    return jax.jit(lambda p, v, it: jax.value_and_grad(
        lambda q: jt.tokenizer_loss(q, JCFG, v, iteration=it, lpips_params=jlp, **_COMMON),
        has_aux=True)(p))


@pytest.mark.parametrize("iteration", [0, 4])
def test_every_term_and_grads_match_jax(models, jax_loss_and_grads, iteration):
    """Each leaf's gradient to 1e-3 of the larger of its largest element and
    1e-2 of the whole gradient's (the attention's k bias has a zero true
    gradient: softmax ignores a per-row shift; both sides give ~1e-7)."""
    jp, tp, jlp, tlp = models
    video = _video()
    (jloss, jm), jg = jax_loss_and_grads(jp, jnp.asarray(video), jnp.asarray(iteration))
    tm, tg = tt.tokenizer_loss_and_grads(tp, TCFG, torch.from_numpy(video), iteration=iteration,
                                         lpips_params=tlp, **_COMMON)
    assert set(tm) == set(jm) == {"l1", "mse", "grad", "temporal", "perceptual", "gram", "flow",
                                  "consistency", "loss"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    assert set(tg) == set(jg)
    top = max(float(np.abs(np.asarray(g)).max()) for g in jg.values())
    for k in jg:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(tg[k].numpy(), want, rtol=1e-2,
                                   atol=1e-3 * max(np.abs(want).max(), 1e-2 * top), err_msg=k)


def test_two_adamw_steps_match_optax(models):
    """The CLI's topology, JAX's step jitted as its CLI jits it. AdamW
    divides each gradient element by its own scale, so an element whose
    gradient sits at the noise floor (the mid block's attention key biases
    have a zero true gradient: a softmax ignores a per-row shift) steps by
    about lr with either sign on either side: 99% of the weights agree to
    atol 1e-5, and none is further apart than two steps of 2 lr."""
    _, _, jlp, tlp = models
    jcfg = dataclasses.replace(JCFG, attn_resolutions=())
    tcfg = dataclasses.replace(TCFG, attn_resolutions=())
    jp = jvae.init_vae_params(jax.random.PRNGKey(1), jcfg)
    tp = {n: t.clone().requires_grad_(True)
          for n, t in vae_state_from_jax({k: np.asarray(v) for k, v in jp.items()}).items()}
    opt_j = optax.adamw(1e-3)
    state_j = opt_j.init(jp)
    opt_t = AdamW(1e-3)
    state_t = opt_t.init(tp)
    kw = dict(w_flow=0.5, w_gram=0.1)
    step_j = jax.jit(lambda p, o, v, it: jt.tokenizer_train_step(
        p, o, v, jcfg, opt_j, iteration=it, lpips_params=jlp, **kw))
    for i, seed in ((1, 4), (2, 5)):
        video = _video(seed, t=9)
        jp, state_j, jm = step_j(jp, state_j, jnp.asarray(video), jnp.asarray(i))
        tp, state_t, tm = tt.tokenizer_train_step(tp, state_t, torch.from_numpy(video), tcfg,
                                                  opt_t, iteration=i, lpips_params=tlp, **kw)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    got = np.concatenate([tp[k].detach().numpy().ravel() for k in sorted(jp)])
    want = np.concatenate([np.asarray(jp[k]).ravel() for k in sorted(jp)])
    off = np.abs(got - want) > 1e-5 + 1e-4 * np.abs(want)
    assert off.mean() < 0.01, off.mean()
    assert np.abs(got - want).max() < 2 * 2 * 1e-3 * 1.01


def test_adamw_matches_optax_on_plain_tensors():
    rng = np.random.RandomState(6)
    p = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    jopt = optax.adamw(3e-3)
    js = jopt.init(p)
    jparams = {k: jnp.asarray(v) for k, v in p.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    topt = AdamW(3e-3)
    ts = topt.init(tparams)
    for step in range(3):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
        upd, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jparams)
        jparams = optax.apply_updates(jparams, upd)
        topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tparams)
    for k in p:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), atol=1e-7,
                                   rtol=1e-6)


def test_cli_trains_saves_and_loads_into_jax(tmp_path):
    save = str(tmp_path / "tok.npz")
    record = {}
    params = tt.main(["--synthetic", "--max_iter", "2", "--log_every", "1", "--frames", "9",
                      "--resolution", "32", "--channels", "16", "--perceptual", "lpips",
                      "--w_flow", "1", "--flow_estimator", "raft", "--flow_iters", "2",
                      "--save", save, "--device", "cpu"], record=record)
    assert [s["step"] for s in record["steps"]] == [1, 2]
    assert all(np.isfinite(s["loss"]) and "flow" in s and "perceptual" in s
               for s in record["steps"])
    cfg = jvae.VAEConfig(channels=16, channels_mult=(2, 4, 4), num_res_blocks=1,
                         attn_resolutions=(), resolution=32, patch_size=4, latent_channels=4,
                         z_channels=4)
    like = jvae.init_vae_params(jax.random.PRNGKey(0), cfg)
    loaded = load_params_npz(save, like)
    assert set(loaded) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(loaded[k]), v.detach().numpy())


def test_cli_data_root_clips(tmp_path):
    clip = (np.random.RandomState(7).rand(12, 32, 32, 3) * 255).astype(np.uint8)
    root = tmp_path / "clips"
    os.makedirs(root)
    np.savez(root / "a.npz", video=clip)
    record = {}
    tt.main(["--data_root", str(root), "--max_iter", "1", "--frames", "9", "--resolution", "32",
             "--channels", "16", "--device", "cpu"], record=record)
    assert np.isfinite(record["steps"][0]["loss"])
    with pytest.raises(SystemExit):
        tt.main(["--synthetic", "--frames", "10", "--device", "cpu"])
