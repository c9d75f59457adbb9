"""The action-conditioned DiT of the port against gen3c_tpu on the CPU.

gen3c_tpu's ``video2world_action_tiny`` parameters (``init_action_dit_params``,
fp32, the zero AdaLN gates and the final linear randomized) go through
``bridge.action_state_from_jax`` into the port's ``ActionDiT``. Tolerances
(fp32 both sides, sums in another order): the forward atol 1e-5; the EDM
loss rtol 1e-5 and each gradient leaf within 1e-4 of its largest |value|;
two train steps' loss and grad-norm rtol 1e-4 and the params within
0.05 * lr (as tests/test_torch_training.py).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.models import dit as jdit
from gen3c_tpu.models import dit_action as jact
from gen3c_tpu.training import losses as jlosses
from gen3c_tpu.training import train_step as jts
from gen3c_tpu.utils import registry as jreg
from gen3c_tpu_torch.bridge import action_state_from_jax, train_params_from_jax
from gen3c_tpu_torch.models import convert as tconvert
from gen3c_tpu_torch.models.dit import GeneralDIT
from gen3c_tpu_torch.models.dit_action import ActionDiT, ActionDiTConfig
from gen3c_tpu_torch.models.dit_multiview import MultiviewDiTConfig
from gen3c_tpu_torch.training import train
from gen3c_tpu_torch.training import train_step as tts
from gen3c_tpu_torch.utils import registry as treg

torch.set_num_threads(2)
LR = 1e-3
JCFG = jreg.get("experiment", "video2world_action_tiny").dit
TCFG = treg.get_experiment("video2world_action_tiny").dit
B, T, H, W = 2, 2, 8, 12


@pytest.fixture(scope="module")
def jparams():
    return jdit.randomize_degenerate_inits(
        jact.init_action_dit_params(jax.random.PRNGKey(0), JCFG))


def _port(tree) -> ActionDiT:
    with torch.device("meta"):
        net = ActionDiT(TCFG)
    net = net.to_empty(device="cpu")
    net.load_state_dict(action_state_from_jax(jax.tree.map(np.asarray, tree)))
    return net


def _inputs(seed, action_ndim=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 17, T, H, W)).astype(np.float32)
    t = np.array([0.4, 2.0], np.float32)
    ctx = rng.standard_normal((B, 16, 1024)).astype(np.float32)
    a_shape = (B, 3, 7) if action_ndim == 3 else (B, 7)
    return x, t, ctx, rng.standard_normal(a_shape).astype(np.float32)


@pytest.mark.parametrize("action_ndim", [3, 2])
def test_action_forward_matches_jax(jparams, action_ndim):
    x, t, ctx, action = _inputs(1, action_ndim)
    want = np.asarray(jdit.dit_forward(jparams, JCFG, jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(ctx), fps=24.0, action=jnp.asarray(action)))
    net = _port(jparams)
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), fps=24.0,
                  action=torch.from_numpy(action)).numpy()
        plain = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                    fps=24.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got - plain).max() > 1e-3  # the action reaches the output
    if action_ndim == 3:  # only the first frame's action is read
        later = action.copy()
        later[:, 1:] += 5.0
        with torch.no_grad():
            again = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                        fps=24.0, action=torch.from_numpy(later)).numpy()
        assert np.array_equal(again, got)


def test_action_embedder_b_d_is_never_applied(jparams):
    """Any B_D weights give the same bits (port), and JAX's gradient
    through B_D is zero, as the port's."""
    x, t, ctx, action = _inputs(2)
    net = _port(jparams)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    with torch.no_grad():
        before = net(*args, fps=24.0, action=torch.from_numpy(action))
        for p in net.action_embedder_B_D.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(3)))
        after = net(*args, fps=24.0, action=torch.from_numpy(action))
    assert torch.equal(before, after)

    def f(p):
        return jnp.sum(jdit.dit_forward(p, JCFG, jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(ctx), fps=24.0,
                                        action=jnp.asarray(action)) ** 2)

    g = jax.grad(f)(jparams)
    assert all(float(jnp.abs(v).max()) == 0 for v in jax.tree.leaves(g["action_embedder_B_D"]))
    assert any(float(jnp.abs(v).max()) > 0 for v in jax.tree.leaves(g["action_embedder_B_3D"]))
    net.requires_grad_(True)
    (net(*args, fps=24.0, action=torch.from_numpy(action)) ** 2).sum().backward()
    assert all(p.grad is None or p.grad.abs().max() == 0
               for p in net.action_embedder_B_D.parameters())


def test_general_dit_refuses_an_action():
    net = GeneralDIT(dataclasses.replace(TCFG, num_blocks=1))
    with pytest.raises(ValueError, match="ActionDiT"):
        net(torch.zeros((1, 17, 1, 8, 8)), torch.ones(1), torch.zeros((1, 4, 1024)),
            action=torch.zeros((1, 7)))


def test_action_init_is_linear_default_from_a_generator():
    """fc1 / fc2 weights and biases uniform within 1/sqrt(fan_in), drawn
    from the generator (the same seed, the same bits); the trunk as a
    GeneralDIT of the same seed draws it."""
    cfg = dataclasses.replace(TCFG, num_blocks=1)
    nets = [ActionDiT(cfg).init_random(torch.Generator().manual_seed(4)) for _ in range(2)]
    for name, p in nets[0].named_parameters():
        assert torch.equal(p, dict(nets[1].named_parameters())[name]), name
    base = GeneralDIT(cfg).init_random(torch.Generator().manual_seed(4))
    for name, p in base.named_parameters():
        assert torch.equal(p, dict(nets[0].named_parameters())[name]), name
    for mlp in (nets[0].action_embedder_B_D, nets[0].action_embedder_B_3D):
        for lin in (mlp.fc1, mlp.fc2):
            bound = 1.0 / np.sqrt(lin.in_features)
            for p in (lin.weight, lin.bias):
                assert 0.5 * bound < p.abs().max().item() <= bound


def test_converted_action_embedders_load_into_an_action_dit(jparams):
    """A reference state dict with the action embedders: an ActionDiT loads
    them, a GeneralDIT accounts for them and drops them."""
    sd = {f"net.{k}": v for k, v in _port(jparams).state_dict().items()}
    with torch.device("meta"):
        act, gen = ActionDiT(TCFG), GeneralDIT(TCFG)
    state = tconvert.dit_state_for_net(sd, act.state_dict().keys())
    assert "action_embedder_B_3D.fc1.weight" in state and "action_embedder_B_D.fc2.bias" in state
    act = act.to_empty(device="cpu")
    act.load_state_dict(state)
    plain = tconvert.dit_state_for_net(sd, gen.state_dict().keys())
    assert not any(k.startswith("action_embedder") for k in plain)
    tree = tconvert.convert_dit_state_dict(sd, TCFG, strict=True)
    for name in ("action_embedder_B_D", "action_embedder_B_3D"):
        np.testing.assert_array_equal(tree[name]["fc1"]["w"].numpy(),
                                      np.asarray(jparams[name]["fc1"]["w"]))


# ------------------------------ training ------------------------------


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"x0": rng.standard_normal((B, 16, T, H, W)).astype(np.float32),
            "crossattn_emb": rng.standard_normal((B, 16, 1024)).astype(np.float32),
            "extra_channels": rng.standard_normal((B, 1, T, H, W)).astype(np.float32),
            "action": rng.standard_normal((B, 1, 7)).astype(np.float32)}


def _draws(rng, shape):
    k_sigma, k_noise, _, k_ind, k_aug_s, k_aug_n = jax.random.split(rng, 6)
    return tts.StepDraws(
        sigma=torch.from_numpy(np.array(jlosses.sample_sigma(k_sigma, shape[0]))),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))),
        indicator=torch.from_numpy(np.array(jlosses.sample_condition_indicator(
            k_ind, shape[0], shape[2], n_min=0, n_max=1))),
        augment_sigma=torch.from_numpy(np.array(jlosses.sample_sigma(k_aug_s, shape[0]))),
        augment_noise=torch.from_numpy(np.array(jax.random.normal(k_aug_n, shape, jnp.float32))))


def test_action_loss_and_grads_match_jax(jparams):
    """The EDM loss through gen3c_tpu's ``_net`` with the batch's action and
    the port's loss_and_grads: the loss and every gradient by name."""
    batch = _batch(1)
    d = _draws(jax.random.PRNGKey(5), batch["x0"].shape)
    ind = d.indicator.numpy()
    extra = np.concatenate([np.broadcast_to(ind, (B, 1, T, H, W)),
                            batch["extra_channels"][:, 1:]], axis=1).astype(np.float32)

    def jloss(p):
        return jlosses.edm_loss(
            jts._net, (p, JCFG, False, None, jnp.asarray(batch["action"])),
            jnp.asarray(batch["x0"]), jnp.asarray(d.sigma.numpy()), jnp.asarray(d.noise.numpy()),
            jnp.asarray(batch["crossattn_emb"]), jnp.asarray(extra),
            condition_video_indicator=jnp.asarray(ind),
            augment_sigma=jnp.asarray(d.augment_sigma.numpy() * 4.0),
            augment_noise=jnp.asarray(d.augment_noise.numpy()))

    (want, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    net = _port(jparams).requires_grad_(True)
    loss, grads, _ = tts.loss_and_grads(
        net, {k: torch.from_numpy(v) for k, v in batch.items()}, None, TCFG,
        video_extend=True, first_random_n_max=1, draws=d)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    want_grads = action_state_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want_grads)
    for n, w in want_grads.items():
        err = (grads[n].double() - w.double()).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (n, err)
    assert grads["action_embedder_B_3D.fc1.weight"].abs().max() > 0


def test_action_train_steps_match_jax(jparams):
    """Two jitted gen3c_tpu train_steps on action batches against the
    port's (remat on both): loss and grad-norm per step, then the params."""
    kw = dict(remat=True, video_extend=True, first_random_n_max=1)
    jopt = jts.make_optimizer(lr=LR, grad_clip=0.5, warmup_steps=1)
    jstate = jts.init_train_state(jparams, jopt)
    jstep = jax.jit(partial(jts.train_step, cfg=JCFG, optimizer=jopt, **kw))
    net = _port(jparams)
    opt = tts.make_optimizer(lr=LR, grad_clip=0.5, warmup_steps=1)
    state = tts.init_train_state(net, opt)
    for i in range(2):
        batch = _batch(10 + i)
        rng = jax.random.PRNGKey(20 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        state, m = tts.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  None, TCFG, opt, draws=_draws(rng, batch["x0"].shape), **kw)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = train_params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for n, p in net.named_parameters():
        assert (p.detach() - want[n]).abs().max().item() <= 0.05 * LR, n


def test_multiview_batch_refuses_an_action():
    cfg = treg.get_experiment("cosmos_t2w_mv_tiny").dit
    with pytest.raises(ValueError, match="action"):
        tts.loss_and_grads(None, {"action": torch.zeros((1, 7))}, None, cfg)


# ------------------------------ the experiments ------------------------------


def test_every_jax_experiment_is_registered():
    names = set(jreg.names("experiment"))
    exps = treg.experiments()
    assert names <= set(exps), sorted(names - set(exps))
    for name in names:
        j, t = jreg.get("experiment", name), exps[name]
        assert t.name == j.name and t.state_shape == j.state_shape, name
        for f in ("in_channels", "out_channels", "model_channels", "num_blocks", "num_heads",
                  "rope_t_extrapolation_ratio", "concat_padding_mask"):
            assert getattr(t.dit, f) == getattr(j.dit, f), (name, f)
        assert isinstance(t.dit, ActionDiTConfig) == isinstance(j.dit, jact.ActionDiTConfig)
        assert isinstance(t.dit, MultiviewDiTConfig) == (type(j.dit).__name__
                                                          == "MultiviewDiTConfig")
    assert exps["video2world_action_7b"].dit.action_dim == 7
    assert exps["video2world_instruction_7b"].dit.in_channels == 17


def test_training_cli_action_and_multiview(tmp_path):
    """The training CLI builds an ActionDiT (with actions from RandomState(17)
    in the synthetic stream) and a MultiviewGeneralDIT (16 context tokens
    a view)."""
    for exp, cls in (("video2world_action_tiny", ActionDiT),
                     ("cosmos_v2w_mv_tiny", train.MultiviewGeneralDIT)):
        trainer = train.main(["--synthetic", "--remat", "--device", "cpu", f"experiment={exp}",
                              "trainer.max_iter=2", "trainer.warmup_steps=1",
                              "trainer.video_extend=True", f"trainer.job_dir={tmp_path / exp}"])
        assert type(trainer.state.params) is cls and trainer.state.step == 2
    stream = train.with_actions(iter([{"x0": torch.zeros(1)}] * 2), 2, 7)
    rng = np.random.RandomState(17)
    for b in stream:
        np.testing.assert_array_equal(b["action"].numpy(),
                                      rng.randn(2, 1, 7).astype(np.float32))
