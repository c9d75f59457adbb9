"""The port's training path against gen3c_tpu's on the CPU, at gen3c_tiny.

The JAX tiny-preset parameters (fp32, the blocks' zero-init AdaLN gates and
the final linear randomized, so the gradients upstream of them are not
zero; the final layer's AdaLN stays zero-init) go through
bridge.train_params_from_jax into the port. Random draws cannot match
(jax.random against torch.Generator), so the port is handed JAX's: the
tests draw sigma, noise, dropout keeps, the condition indicator and the
augment noise from the same keys as gen3c_tpu's train_step.

Tolerances (fp32 on both sides, sums in another order):
  * edm_loss value rtol 1e-5; every gradient leaf max |delta| <= 1e-4 of
    the leaf's max |.| (the deepest leaves sum over both blocks' backward);
  * three train_steps: loss and grad-norm rtol 1e-4 per step; params and
    the EMA within 0.05 * lr of JAX's (atol): a gradient entry that is
    ~0 in both may differ in sign, and Adam turns that into a full +-lr
    step (its magnitude, not its sign, is what the first steps keep), so
    the tolerance is set from lr, far below the 1.5 lr the params move;
  * the optimizer alone (clip, AdamW, warmup, MultiSteps) against optax on
    random trees: rtol 1e-5.
"""

import dataclasses
import json
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gen3c_tpu.models import dit as jdit
from gen3c_tpu.pipelines.factory import GEN3C_TINY_PRESET as JAX_TINY
from gen3c_tpu.training import losses as jlosses
from gen3c_tpu.training import train_step as jts
from gen3c_tpu_torch.bridge import train_params_from_jax
from gen3c_tpu_torch.models.dit import GeneralDIT
from gen3c_tpu_torch.pipelines.factory import GEN3C_TINY_PRESET
from gen3c_tpu_torch.training import losses as tlosses
from gen3c_tpu_torch.training import train_step as tts
from gen3c_tpu_torch.training.trainer import Trainer, TrainerConfig, synthetic_latent_dataset

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, H, W = 2, 2, 8, 12  # latent (16, 2, 8, 12): 2 x 4 x 6 = 48 tokens


@pytest.fixture(scope="module")
def jparams():
    return jdit.randomize_degenerate_inits(
        jdit.init_dit_params(jax.random.PRNGKey(0), JAX_TINY.dit))


def _batch(seed, t=T, image=False):
    rng = np.random.default_rng(seed)
    b = {"x0": rng.standard_normal((B, 16, t, H, W)).astype(np.float32),
         "crossattn_emb": rng.standard_normal((B, 16, 1024)).astype(np.float32)}
    if not image:
        b["extra_channels"] = rng.standard_normal((B, JAX_TINY.dit.in_channels - 16, t, H, W)
                                                  ).astype(np.float32)
    return b


def _port_module(tree):
    """The module the port trains, holding ``tree``'s values."""
    net = GeneralDIT(GEN3C_TINY_PRESET.dit)
    module = net
    if "net" in tree:
        module = tts.NetWithLogvar(net, tlosses.LogvarHead())
    module.load_state_dict(train_params_from_jax(jax.tree.map(np.asarray, tree)), strict=True)
    return module


def _jax_draws(rng, x0_shape, video_extend=False, dropout=False, text_rate=0.0, vid_rate=0.0):
    """gen3c_tpu train_step's draws from ``rng`` (train_step.py:160-198),
    as the port's StepDraws."""
    k_sigma, k_noise, k_drop, k_ind, k_aug_s, k_aug_n = jax.random.split(rng, 6)
    Bx, _, Tx = x0_shape[:3]
    d = tts.StepDraws(
        sigma=torch.from_numpy(np.array(jlosses.sample_sigma(k_sigma, Bx))),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, x0_shape, jnp.float32))))
    if dropout:
        k_text, k_vid = jax.random.split(k_drop)
        d.keep_text = torch.from_numpy(np.array(
            jax.random.bernoulli(k_text, 1.0 - text_rate, (Bx,)), np.float32))
        d.keep_vid = torch.tensor(float(jax.random.bernoulli(k_vid, 1.0 - vid_rate, ())))
    if video_extend:
        d.indicator = torch.from_numpy(np.array(jlosses.sample_condition_indicator(
            k_ind, Bx, Tx, n_min=0, n_max=1)))
        d.augment_sigma = torch.from_numpy(np.array(jlosses.sample_sigma(k_aug_s, Bx)))
        d.augment_noise = torch.from_numpy(np.array(
            jax.random.normal(k_aug_n, x0_shape, jnp.float32)))
    return d


def _assert_leaves_close(got: dict, want: dict, rel: float, what: str):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for name, w in want.items():
        g = got[name].detach().double().numpy()
        w = w.double().numpy()
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= rel * scale, (what, name, err, scale)


CASES = {
    "plain": {},
    "video_extend": {"video_extend": True},
    "logvar": {"logvar": True},
    "sum": {"loss_reduce": "sum", "loss_scale": 0.5},
    "image": {"image": True},
}


@pytest.mark.parametrize("case", list(CASES))
def test_edm_loss_and_grads_match_jax(jparams, case):
    opts = CASES[case]
    image = opts.get("image", False)
    logvar = opts.get("logvar", False)
    video_extend = opts.get("video_extend", False)
    batch = _batch(1, t=1 if image else T, image=image)
    x0 = batch["x0"]
    if image:
        extra = np.zeros((B, JAX_TINY.dit.in_channels - 16) + x0.shape[2:], np.float32)
    else:
        extra = batch["extra_channels"]
    draws = _jax_draws(jax.random.PRNGKey(3), x0.shape, video_extend=video_extend)
    params = jparams
    if logvar:
        params = {"net": jparams, "logvar": jlosses.init_logvar_params(jax.random.PRNGKey(5))}
    kw = {"loss_reduce": opts.get("loss_reduce", "mean"), "loss_scale": opts.get("loss_scale", 1.0)}
    if video_extend:
        kw.update(condition_video_indicator=draws.indicator.numpy(),
                  augment_sigma=draws.augment_sigma.numpy() * 4.0,
                  augment_noise=draws.augment_noise.numpy())
        ind = draws.indicator.numpy()
        assert 0 < ind.sum() < ind.size  # a condition region and a free region
    weights = np.array([0.7, 1.3], np.float32)
    loss_mask = (np.random.default_rng(2).uniform(size=(B, 1, x0.shape[2], H, W)) > 0.2
                 ).astype(np.float32)

    def jloss(p):
        net_p = p["net"] if logvar else p
        return jlosses.edm_loss(
            lambda pp, x, t, c: jdit.dit_forward(pp, JAX_TINY.dit, x, t, c, fps=24.0), net_p,
            jnp.asarray(x0), jnp.asarray(draws.sigma.numpy()), jnp.asarray(draws.noise.numpy()),
            jnp.asarray(batch["crossattn_emb"]), jnp.asarray(extra),
            logvar_params=p["logvar"] if logvar else None,
            weights_per_sample=jnp.asarray(weights), loss_mask=jnp.asarray(loss_mask),
            **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})

    (want_loss, want_per), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    module = _port_module(params)
    module.requires_grad_(True)
    net = module.net if logvar else module
    loss, per = tlosses.edm_loss(
        lambda x, t, c: net(x, t, c, fps=24.0), torch.from_numpy(x0), draws.sigma, draws.noise,
        torch.from_numpy(batch["crossattn_emb"]), torch.from_numpy(extra),
        logvar=module.logvar if logvar else None, weights_per_sample=torch.from_numpy(weights),
        loss_mask=torch.from_numpy(loss_mask),
        **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(want_per), rtol=1e-5)
    names = [n for n, _ in module.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(module.parameters()))))
    _assert_leaves_close(grads, train_params_from_jax(jax.tree.map(np.asarray, want_grads)),
                         1e-4, case)


LR = 1e-3


def test_three_train_steps_match_jax(jparams):
    """warmup 2 (lr 0, lr/2, lr), clip at 0.5 (active: grad norms are > 1),
    logvar and video-extend on: loss and grad-norm per step, then params,
    EMA and the step counter."""
    kw = dict(loss_add_logvar=True, video_extend=True, first_random_n_max=1,
              text_dropout_rate=0.3)
    jopt = jts.make_optimizer(lr=LR, grad_clip=0.5, warmup_steps=2)
    params = {"net": jparams, "logvar": jlosses.init_logvar_params(jax.random.PRNGKey(5))}
    module = _port_module(params)
    jstate = jts.init_train_state(params, jopt)
    jstep = jax.jit(partial(jts.train_step, cfg=JAX_TINY.dit, optimizer=jopt, **kw))
    opt = tts.make_optimizer(lr=LR, grad_clip=0.5, warmup_steps=2)
    state = tts.init_train_state(module, opt)
    for i in range(3):
        batch = _batch(10 + i)
        rng = jax.random.PRNGKey(100 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        draws = _jax_draws(rng, batch["x0"].shape, video_extend=True, dropout=True,
                           text_rate=0.3)
        state, m = tts.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  None, GEN3C_TINY_PRESET.dit, opt, draws=draws, **kw)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert float(jm["grad_norm"]) > 0.5  # the clip is active
    assert state.step == int(jstate.step) == 3
    want = train_params_from_jax(jax.tree.map(np.asarray, jstate.params))
    before = train_params_from_jax(jax.tree.map(np.asarray, params))
    moved = max((want[n] - before[n]).abs().max().item() for n in want)
    assert moved > LR  # warmup gave lr/2 then lr: the params moved
    for what, got, ref in (("params", dict(module.named_parameters()), want),
                           ("ema", state.ema_params,
                            train_params_from_jax(jax.tree.map(np.asarray, jstate.ema_params)))):
        for n, w in ref.items():
            err = (got[n].detach() - w).abs().max().item()
            assert err <= 0.05 * LR, (what, n, err)


def _random_tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("accum,clip,warmup", [(1, 1.0, 3), (1, 100.0, 1), (2, 0.7, 2),
                                               (1, 1.0, 0)])
def test_optimizer_matches_optax(accum, clip, warmup):
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    params = _random_tree(0, shapes)
    jopt = jts.make_optimizer(lr=0.01, weight_decay=0.1, grad_clip=clip, warmup_steps=warmup,
                              grad_accum_steps=accum)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    opt = tts.make_optimizer(lr=0.01, weight_decay=0.1, grad_clip=clip, warmup_steps=warmup,
                             grad_accum_steps=accum)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(tp)
    for i in range(5):
        grads = _random_tree(1 + i, shapes)
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, state, tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
    if warmup == 0:  # optax's linear warmup from 0 over 0 steps: lr 0 for ever
        for k in shapes:
            np.testing.assert_array_equal(tp[k].numpy(), params[k])


def test_warmup_schedule_quirk():
    """The first update has lr 0; warmup_steps=0 keeps it 0 for ever
    (optax.linear_schedule(0.0, lr, 0) is the constant 0)."""
    for warmup in (0, 1, 3):
        ours = tts.make_optimizer(lr=0.5, warmup_steps=warmup)
        theirs = optax.linear_schedule(0.0, 0.5, warmup)
        got = [float(ours.schedule(c)) for c in range(6)]
        np.testing.assert_allclose(got, [float(theirs(c)) for c in range(6)], rtol=1e-7)
        assert got[0] == 0.0
    assert [float(tts.make_optimizer(lr=0.5, warmup_steps=0).schedule(c))
            for c in range(3)] == [0.0, 0.0, 0.0]


def test_ema_beta_matches_jax():
    from gen3c_tpu.training.ema import power_ema_beta as jbeta
    from gen3c_tpu_torch.training.ema import power_ema_beta

    for i in (0, 1, 2, 3, 10, 1000):
        np.testing.assert_allclose(float(power_ema_beta(i)), float(jbeta(i)), rtol=1e-6)


class _Recorder:
    def __init__(self, events):
        self.events = events

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: self.events.append(name)
        raise AttributeError(name)


def test_trainer_hooks_save_and_resume(tmp_path):
    """gen3c_tpu's hook order, a save every save_every steps and at the end,
    at most three checkpoints, and a resume that restores the latest step
    and the state bit for bit."""
    from gen3c_tpu_torch.training.callbacks import CallBackGroup

    cfg_dit = GEN3C_TINY_PRESET.dit
    job = str(tmp_path / "job")

    def net():
        return GeneralDIT(cfg_dit).init_random(torch.Generator().manual_seed(0))

    events = []
    cfg = TrainerConfig(job_dir=job, max_iter=4, save_every=1, warmup_steps=1)
    trainer = Trainer(cfg, cfg_dit, net(), callbacks=CallBackGroup([_Recorder(events)]))
    trainer.train(synthetic_latent_dataset(1, 16, 2, 8, 8))
    first = events.index("on_training_step_start")
    assert events[first:first + 10] == [
        "on_training_step_start", "on_before_dataloading", "on_after_dataloading",
        "on_before_forward", "on_before_backward", "on_before_optimizer_step",
        "on_after_forward", "on_after_backward", "on_before_zero_grad", "on_training_step_end"]
    assert events[0] == "on_load_checkpoint_start"
    assert events[-2:] == ["on_train_end", "on_app_end"]
    assert events.count("on_save_checkpoint_start") == 4
    assert trainer.checkpointer.steps() == [2, 3, 4]  # max_to_keep = 3
    assert json.load(open(os.path.join(job, "config.json")))["max_iter"] == 4
    saved = trainer.state.state_dict()

    events.clear()
    cfg2 = dataclasses.replace(cfg, max_iter=6, save_every=0)
    resumed = Trainer(cfg2, cfg_dit, net(), callbacks=CallBackGroup([_Recorder(events)]))
    assert resumed.maybe_resume() == 4
    for n, p in resumed.state.named_params().items():
        assert torch.equal(p, saved["params"][n]), n
    for n, e in resumed.state.ema_params.items():
        assert torch.equal(e, saved["ema"][n]), n
    assert resumed.state.opt_state.count == 4
    state = resumed.train(synthetic_latent_dataset(1, 16, 2, 8, 8))
    assert state.step == 6 and events.count("on_training_step_start") == 2
    assert "on_load_checkpoint_end" in events
    assert resumed.checkpointer.steps() == [3, 4, 6]


def test_callback_hooks_match_gen3c_tpu():
    """The port's callbacks (its own module, so the trainer never imports
    the JAX package) have gen3c_tpu's hook surface, signature for signature."""
    import inspect

    from gen3c_tpu.training import callbacks as jcb
    from gen3c_tpu_torch.training import callbacks as tcb

    def hooks(cls):
        return {n: list(inspect.signature(f).parameters) for n, f in vars(cls).items()
                if n.startswith("on_")}

    assert hooks(tcb.Callback) == hooks(jcb.Callback) and len(hooks(tcb.Callback)) == 21
    events = []
    group = tcb.CallBackGroup([_Recorder(events), _Recorder(events)])
    group.on_training_step_end(None, 1, {})
    assert events == ["on_training_step_end"] * 2


def test_trainer_step_watchdog(tmp_path):
    """trainer.step_timeout_s arms the port's HangWatchdog: a step that ends
    disarms it, train end restores the old handler, and a step whose batch
    never comes raises StepTimeout instead of hanging."""
    import signal
    import time

    from gen3c_tpu_torch.training.callbacks import HangWatchdog, StepTimeout

    prev = signal.getsignal(signal.SIGALRM)
    try:
        cb = HangWatchdog(timeout_s=1)
        cb.on_train_start(None)
        cb.on_training_step_start(None, 1)
        cb.on_training_step_end(None, 1, {})
        assert signal.alarm(0) == 0  # nothing pending after the step's end
        cb.on_train_end(None)
        assert signal.getsignal(signal.SIGALRM) is prev

        def hung():
            time.sleep(30)
            yield {}

        cfg_dit = GEN3C_TINY_PRESET.dit
        cfg = TrainerConfig(job_dir=str(tmp_path / "w"), max_iter=1, warmup_steps=1,
                            step_timeout_s=1, prefetch_batches=0)
        trainer = Trainer(cfg, cfg_dit, GeneralDIT(cfg_dit).init_random(
            torch.Generator().manual_seed(0)))
        t0 = time.monotonic()
        with pytest.raises(StepTimeout):
            trainer.train(hung())
        assert time.monotonic() - t0 < 20
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


def test_trainer_joint_image_video_and_logvar(tmp_path):
    from gen3c_tpu_torch.training.trainer import synthetic_joint_dataset

    cfg_dit = GEN3C_TINY_PRESET.dit
    cfg = TrainerConfig(job_dir=str(tmp_path / "j"), max_iter=2, save_every=0, warmup_steps=1,
                        loss_add_logvar=True, video_extend=True, prefetch_batches=0)
    trainer = Trainer(cfg, cfg_dit, GeneralDIT(cfg_dit).init_random(
        torch.Generator().manual_seed(0)))
    head = dict(trainer.state.params.logvar.named_parameters())
    w0 = head["w"].detach().clone()
    state = trainer.train(synthetic_joint_dataset(1, 16, 2, 8, 8))
    assert state.step == 2
    assert not torch.equal(head["w"].detach(), w0)  # the logvar head trains


def test_cli_overrides_and_resume(tmp_path):
    """The CLI's dotted overrides reach TrainerConfig and the preset, its
    flags set theirs, and a second run resumes the first one's job."""
    from gen3c_tpu_torch.training import train

    job = str(tmp_path / "cli")
    args = ["--synthetic", "--remat", "--device", "cpu", "experiment=gen3c_tiny",
            "trainer.max_iter=2", "trainer.save_every=1", "trainer.warmup_steps=1",
            "trainer.lr=0.002", f"trainer.job_dir={job}", "dit.num_blocks=1"]
    trainer = train.main(args)
    assert trainer.config.remat and trainer.config.lr == 0.002 and trainer.config.max_iter == 2
    assert trainer.dit_cfg.num_blocks == 1 and len(trainer.state.params.blocks) == 1
    assert trainer.state.step == 2
    again = train.main([a.replace("max_iter=2", "max_iter=3") for a in args])
    assert again.state.step == 3 and again.checkpointer.steps() == [1, 2, 3]
    for flags in (["--tp", "2"], ["--fsdp"], ["--sequence_parallel"]):
        with pytest.raises(NotImplementedError, match="ROADMAP item 15[bc]"):
            train.main(["--synthetic", "--device", "cpu", *flags, f"trainer.job_dir={job}2"])
    with pytest.raises(SystemExit):  # --dp is ported: the batch must split over it
        train.main(["--synthetic", "--device", "cpu", "--dp", "2", f"trainer.job_dir={job}2"])
    with pytest.raises(ValueError, match="world size is 1"):  # and it needs the ranks
        train.main(["--synthetic", "--device", "cpu", "--dp", "2", "--batch_size", "2",
                    f"trainer.job_dir={job}2"])
    with pytest.raises(FileNotFoundError):  # --data_root is ported: a missing root raises
        train.main(["--data_root", str(tmp_path / "missing"), "--device", "cpu",
                    f"trainer.job_dir={job}3"])


def test_cli_runs_without_jax(tmp_path):
    code = ("import sys; from gen3c_tpu_torch.training import train; "
            f"train.main(['--synthetic', '--device', 'cpu', 'experiment=gen3c_tiny', "
            "'trainer.max_iter=3', "
            f"'trainer.warmup_steps=1', 'trainer.job_dir={tmp_path / 'nojax'}']); "
            "assert 'jax' not in sys.modules; "
            "assert not [m for m in sys.modules if m.split('.')[0] == 'gen3c_tpu'], "
            "'the JAX package was imported'; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
