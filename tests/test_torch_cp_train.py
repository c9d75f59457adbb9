"""Data-, context- and tensor-parallel DiT training (``train_step.
make_sharded_train_step``, ``Trainer(groups=)``, ``train.py --dp --cp --tp
[--sequence_parallel]``) against JAX's one-device ``train_step`` and the
port's one-rank step, on CPU ranks over gloo.

A pool of 4 spawned ranks (``tests/torch_cp_ranks.py``) runs each (dp, cp)
layout, 2-rank layouts as two replicas. Every rank gets the global batch
and the global draws (JAX's, injected as ``StepDraws``) and takes its
slice; the tiny GEN3C DiT (4 heads, fp32) trains 2 steps with the logvar
head, video-extend conditioning, text dropout, warmup 2 and an active clip
at 0.5, over a (2, 16, 4, 8, 12) latent (B 2 on dp, T 4 on cp; under tp
each rank holds its shards, gathered for the comparison).

Tolerances, fp32: against the port's one-rank step, loss and grad norm
1e-5 relative (the ranks' partial sums are added in another order), and
against JAX's jitted step 1e-4, the port's own one-device bound
(tests/test_torch_training.py: XLA fuses the same sums in other orders).
The parameters after the steps: within 5% of the learning rate, the
bound of test_torch_training.py's three-step test (AdamW divides each
gradient by its own root mean square, so a noise-floor gradient's
rounding moves its element by up to lr either way); against the one-rank
step also 1e-5 of the largest parameter for all but 1% of the elements.
"""

import dataclasses
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gen3c_tpu.models import dit as jdit
from gen3c_tpu.models import dit_action as jact
from gen3c_tpu.pipelines.factory import GEN3C_TINY_PRESET as JAX_TINY
from gen3c_tpu.training import losses as jlosses
from gen3c_tpu.training import train_step as jts
from gen3c_tpu.utils import registry as jreg
from gen3c_tpu_torch.bridge import train_params_from_jax
from gen3c_tpu_torch.parallel.mesh import Axis, Groups
from gen3c_tpu_torch.training import train_step as tts
from tests import torch_cp_ranks
from tests.test_torch_training import _jax_draws

torch.set_num_threads(2)
WORLD = 4
LR = 1e-3
B, T, H, W = 2, 4, 8, 12
KW = dict(loss_add_logvar=True, video_extend=True, first_random_n_max=1, text_dropout_rate=0.3)
OPT = dict(lr=LR, grad_clip=0.5, warmup_steps=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ranks():
    pool = torch_cp_ranks.Ranks(WORLD)
    yield pool
    pool.close()


def _jax_params(kind, logvar):
    if kind == "action":
        cfg = jreg.get("experiment", "video2world_action_tiny").dit
        net = jact.init_action_dit_params(jax.random.PRNGKey(0), cfg)
    else:
        cfg = JAX_TINY.dit
        net = jdit.init_dit_params(jax.random.PRNGKey(0), cfg)
    net = jdit.randomize_degenerate_inits(net)
    params = {"net": net, "logvar": jlosses.init_logvar_params(jax.random.PRNGKey(5))} \
        if logvar else net
    return cfg, params


def _batches(kind, n, image=False):
    out = []
    for i in range(n):
        rng = np.random.default_rng(20 + i)
        t = 1 if image else T
        b = {"x0": rng.standard_normal((B, 16, t, H, W)).astype(np.float32),
             "crossattn_emb": rng.standard_normal((B, 16, 1024)).astype(np.float32)}
        if not image:
            c = 1 if kind == "action" else JAX_TINY.dit.in_channels - 16
            b["extra_channels"] = rng.standard_normal((B, c, t, H, W)).astype(np.float32)
        if kind == "action":
            b["action"] = rng.standard_normal((B, 1, 7)).astype(np.float32)
        out.append(b)
    return out


def _draws(d):
    return {k: None if v is None else v.numpy() for k, v in vars(d).items()}


def _references(kind, kw, image=False, steps=2):
    """JAX's jitted train_step over ``steps`` batches, the draws it took (as
    the port's StepDraws fields), and the port's one-rank steps on them."""
    cfg, params = _jax_params(kind, kw.get("loss_add_logvar", False))
    jopt = jts.make_optimizer(**OPT)
    jstate = jts.init_train_state(params, jopt)
    data_type = "image" if image else "video"
    jstep = jax.jit(partial(jts.train_step, cfg=cfg, optimizer=jopt, data_type=data_type, **kw))
    batches = _batches(kind, steps, image)
    draws, jax_out = [], {"loss": [], "grad_norm": []}
    for i, b in enumerate(batches):
        rng = jax.random.PRNGKey(100 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, rng)
        jax_out["loss"].append(float(jm["loss"]))
        jax_out["grad_norm"].append(float(jm["grad_norm"]))
        d = _jax_draws(rng, b["x0"].shape, video_extend=kw.get("video_extend", False) and not
                       image, dropout="text_dropout_rate" in kw, text_rate=kw.get(
                           "text_dropout_rate", 0.0))
        draws.append(_draws(d))
    jax_out["params"] = {k: v.numpy() for k, v in train_params_from_jax(
        jax.tree.map(np.asarray, jstate.params)).items()}
    state = {k: v.numpy() for k, v in train_params_from_jax(
        jax.tree.map(np.asarray, params)).items()}
    job = dict(kind=kind, state=state, batches=batches, draws=draws, opt_kw=OPT, step_kw=kw,
               data_type=data_type)
    one = torch_cp_ranks.run_train_steps(None, **job)
    return job, jax_out, one


def _assert_matches(results, jax_out, one):
    for r in results:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], one["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(r["sigma_mean"], one["sigma_mean"], rtol=1e-6)
        np.testing.assert_allclose(r["loss"], jax_out["loss"], rtol=1e-4)
        np.testing.assert_allclose(r["grad_norm"], jax_out["grad_norm"], rtol=1e-4)
        assert r["step"] == 2
        for ref in (one["params"], jax_out["params"]):
            for n, w in ref.items():
                assert np.abs(r["params"][n] - w).max() <= 0.05 * LR, n
        got = np.concatenate([r["params"][n].ravel() for n in sorted(one["params"])])
        want = np.concatenate([one["params"][n].ravel() for n in sorted(one["params"])])
        assert (np.abs(got - want) > 1e-5 * np.abs(want).max()).mean() < 0.01
    for r in results[1:]:  # AdamW and the EMA take the same step on every rank
        for n, p in results[0]["params"].items():
            assert np.array_equal(r["params"][n], p), n


@pytest.fixture(scope="module")
def gen3c_refs():
    return _references("gen3c", KW)


@pytest.mark.parametrize("dp,cp", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_sharded_steps_match_jax_and_one_rank(ranks, gen3c_refs, dp, cp):
    job, jax_out, one = gen3c_refs
    results = ranks.run("train", dp=dp, cp=cp, **job)
    assert one["grad_norm"][0] > 0.5  # the clip is active
    places = [(r["dp_rank"], r["cp_rank"]) for r in results[:dp * cp]]
    assert places == [(d, c) for d in range(dp) for c in range(cp)]
    _assert_matches(results, jax_out, one)


# (dp, cp, tp, sequence parallelism)
_TP_LAYOUTS = [(1, 1, 2, False), (1, 1, 2, True), (1, 2, 2, False), (1, 2, 2, True),
               (2, 1, 2, True)]


@pytest.mark.parametrize("dp,cp,tp,sp", _TP_LAYOUTS,
                         ids=[f"dp{d}-cp{c}-tp{t}{'-sp' if s else ''}"
                              for d, c, t, s in _TP_LAYOUTS])
def test_tp_steps_match_jax_and_one_rank(ranks, gen3c_refs, dp, cp, tp, sp):
    """Tensor parallelism (Megatron column / row shards of every q/k/v/out
    and fc1/fc2; with sp the tokens between them too) on its own and beside
    cp and dp: the loss, the grad norm (each shard counted once) and every
    parameter after 2 steps, gathered, as JAX's one-device step and the
    port's one rank. This holds the gradients of the sharded leaves (summed
    over the ranks with the same shard), of q's and k's norm scales (a part
    on each tp rank) and, under sp, of every replicated leaf."""
    job, jax_out, one = gen3c_refs
    job = dict(job, step_kw=dict(job["step_kw"], sequence_parallel=sp))
    results = ranks.run("train", dp=dp, cp=cp, tp=tp, **job)
    n = dp * cp * tp
    places = [(r["dp_rank"], r["cp_rank"], r["tp_rank"]) for r in results[:n]]
    assert places == [(d, c, k) for d in range(dp) for c in range(cp) for k in range(tp)]
    assert len(results[0]["sharded"]) == 2 * (2 * 4 + 2)
    _assert_matches(results, jax_out, one)


@pytest.mark.parametrize("dp,cp", [(2, 1), (2, 2)])
def test_action_on_dp_matches_jax_and_one_rank(ranks, dp, cp):
    """The action experiment: each dp rank's samples take their own actions
    (B, 1, 7) into the AdaLN-LoRA vector."""
    job, jax_out, one = _references("action", {"text_dropout_rate": 0.3})
    _assert_matches(ranks.run("train", dp=dp, cp=cp, **job), jax_out, one)


def test_action_under_tp_matches_jax_and_one_rank(ranks):
    """The action DiT's blocks sharded over tp beside dp (dp 2 x tp 2; its
    action embedders stay replicated, whole on every rank)."""
    job, jax_out, one = _references("action", {"text_dropout_rate": 0.3})
    results = ranks.run("train", dp=2, cp=1, tp=2, **job)
    assert results[0]["sharded"] and not any("action" in n for n in results[0]["sharded"])
    _assert_matches(results, jax_out, one)


def test_image_batch_at_cp2_matches_one_device(ranks):
    """An image batch (T = 1) is split on dp only; its cp ranks repeat it,
    each counting for 1 / cp of the loss (gen3c_tpu :315-321)."""
    kw = {"loss_add_logvar": True, "text_dropout_rate": 0.3}
    job, jax_out, one = _references("gen3c", kw, image=True)
    _assert_matches(ranks.run("train", dp=2, cp=2, **job), jax_out, one)
    _assert_matches(ranks.run("train", dp=1, cp=2, **job), jax_out, one)


def test_sum_reduce_over_the_mesh_matches_one_device(ranks):
    kw = {"loss_reduce": "sum", "loss_scale": 0.5, "text_dropout_rate": 0.3}
    job, jax_out, one = _references("gen3c", kw)
    _assert_matches(ranks.run("train", dp=2, cp=2, **job), jax_out, one)


# the tensor-parallel operators at 2 ranks, the smoke's tp (a 4-rank gradcheck
# takes seconds a case)
_GRADCHECK_CASES = [(op, cp) for op in ("seq_to_heads", "heads_to_seq", "all_gather", "all_reduce",
                                        "all_reduce_mean") for cp in (2, 4)] + [
    (op, 2) for op in ("reduce_scatter", "copy_to_tp", "reduce_from_tp", "gather_to_replicas")]


@pytest.mark.parametrize("op,cp", _GRADCHECK_CASES, ids=[f"{o}-{c}" for o, c in _GRADCHECK_CASES])
def test_collective_gradients_pass_gradcheck(ranks, op, cp):
    assert all(ranks.run("collective_gradcheck", cp=cp, op=op))


def test_refusals(tmp_path):
    """As gen3c_tpu: a band with cp > 1, sequence parallelism for the
    multiview net (train_step.py:287-291); not ported: the multiview net
    under cp. A tp mesh needs its ranks. FSDP is ported: the step takes
    fsdp_axis "dp" (any other axis is refused, as JAX's specs name dp),
    and ``train.py --fsdp`` trains on one device."""
    from gen3c_tpu_torch.models.dit_multiview import MultiviewDiTConfig
    from gen3c_tpu_torch.pipelines.factory import GEN3C_TINY_PRESET
    from gen3c_tpu_torch.parallel.mesh import make_groups
    from gen3c_tpu_torch.training import train

    cfg = GEN3C_TINY_PRESET.dit
    opt = tts.make_optimizer()
    cp2 = Groups(cp=Axis(None, 0, 2), world=Axis(None, 0, 2))
    band = dataclasses.replace(cfg, attn_temporal_window=1)
    with pytest.raises(ValueError, match="attn_temporal_window training requires cp=1"):
        tts.make_sharded_train_step(cp2, band, opt)
    tts.make_sharded_train_step(Groups(dp=Axis(None, 0, 2), world=Axis(None, 0, 2)), band, opt)
    assert callable(tts.make_sharded_train_step(cp2, cfg, opt, fsdp_axis="dp"))
    with pytest.raises(ValueError, match="not 'cp'"):
        tts.make_sharded_train_step(cp2, cfg, opt, fsdp_axis="cp")
    tts.make_sharded_train_step(cp2, cfg, opt, sequence_parallel=True)
    with pytest.raises(ValueError, match="not supported for multiview training"):
        tts.make_sharded_train_step(cp2, MultiviewDiTConfig(), opt, sequence_parallel=True)
    with pytest.raises(ValueError, match="world size is 1"):
        make_groups(dp=2, tp=2)
    x = torch.zeros((2, 16, 2, 8, 8))
    draws = tts.StepDraws(sigma=torch.ones(2), noise=x)
    with pytest.raises(NotImplementedError, match="multiview"):
        tts.shard_step_inputs({"x0": x}, draws, cp2, MultiviewDiTConfig(), "video")
    with pytest.raises(ValueError, match="does not split over dp"):
        tts.shard_step_inputs({"x0": x[:1]}, draws, Groups(dp=Axis(None, 0, 2)), cfg, "video")
    trainer = train.main(["--synthetic", "--device", "cpu", "--fsdp", "trainer.max_iter=1",
                          "trainer.warmup_steps=1", f"trainer.job_dir={tmp_path / 'fsdp'}"])
    assert trainer.config.fsdp and trainer.state.step == 1
    with pytest.raises(ValueError, match="world size is 1"):
        train.main(["--synthetic", "--device", "cpu", "--tp", "2"])


def _cli(job, nproc, *flags):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc)] if nproc > 1 else [sys.executable])
    args = [*launch, "-m", "gen3c_tpu_torch.training.train", "--synthetic", "--device", "cpu",
            "--batch_size", "2", "experiment=gen3c_tiny", "trainer.max_iter=2",
            "trainer.warmup_steps=1", "trainer.save_every=1", "trainer.text_dropout_rate=0.3",
            "trainer.video_extend=True", f"trainer.job_dir={job}", *flags]
    res = subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return torch.load(os.path.join(job, "checkpoints", "step_2.pt"), weights_only=True)


def test_cli_dp_cp_trains_as_one_process(tmp_path):
    """``torchrun --nproc_per_node 4 -m gen3c_tpu_torch.training.train --dp 2
    --cp 2`` (gloo) against the same CLI in one process: the step-2
    checkpoint's parameters, EMA and moments, written by rank 0 alone."""
    one = _cli(str(tmp_path / "one"), 1)
    four = _cli(str(tmp_path / "four"), 4, "--dp", "2", "--cp", "2")
    assert sorted(os.listdir(tmp_path / "four" / "checkpoints")) == ["step_1.pt", "step_2.pt"]
    assert four["step"] == one["step"] == 2
    for part in ("params", "ema", "mu", "nu"):
        for n, w in one[part].items():
            err = (four[part][n] - w).abs().max().item()
            assert err <= 1e-5 * max(w.abs().max().item(), 1.0), (part, n, err)


def test_cli_tp_sp_trains_as_one_process(tmp_path):
    """``torchrun --nproc_per_node 2 -m gen3c_tpu_torch.training.train --tp 2
    --sequence_parallel`` (gloo) against the same CLI in one process: the
    step-2 checkpoint, in the one-device form rank 0 writes after every
    rank gathers its shards."""
    one = _cli(str(tmp_path / "one"), 1)
    two = _cli(str(tmp_path / "two"), 2, "--tp", "2", "--sequence_parallel")
    assert two["step"] == one["step"] == 2
    for part in ("params", "ema", "mu", "nu"):
        for n, w in one[part].items():
            assert two[part][n].shape == w.shape, (part, n)
            err = (two[part][n] - w).abs().max().item()
            assert err <= 1e-5 * max(w.abs().max().item(), 1.0), (part, n, err)


@pytest.mark.parametrize("dp, tp", [(2, 2), (1, 4)])
def test_save_gathers_one_tensor_at_a_time(ranks, dp, tp):
    """Trainer's checkpoint gather (``sharding.gather_to_host``) brings the
    sharded state to the writing rank's host memory a tensor at a time:
    at each all-gather no earlier gathered buffer is alive, so the device
    never holds more than one gathered tensor beside the state; params,
    moments and EMA each gathered once; rank 0's host state equals the
    one-device state it was cut from, bit for bit, in host memory of its
    own; the other ranks keep nothing."""
    out = ranks.run("save_gather", dp=dp, tp=tp)
    for r, o in enumerate(out):
        assert o["alive_at_gather"] == 0, o
        assert o["sharded"] == 2 * (2 * 4 + 2) and o["gathers"] == 4 * o["sharded"], o
        assert o["host_none"] == (r != 0), o
    assert out[0]["equal"] is True and out[0]["on_host"] is True


def test_trainer_checkpoints_cross_tp_sizes(ranks, tmp_path):
    """A checkpoint written at tp 2 (a dp 2 x tp 2 mesh: rank 0 writes the
    gathered state) restores at tp 1, which trains a step and writes its
    own; that one restores at tp 2, every rank slicing its shards back."""
    from gen3c_tpu_torch.training.train import build_net
    from gen3c_tpu_torch.training.trainer import Trainer

    job = str(tmp_path / "job")
    at_tp2 = ranks.run("trainer_run", dp=2, tp=2, job_dir=job, max_iter=2)
    assert [r["step"] for r in at_tp2] == [2] * WORLD and at_tp2[0]["sharded"] == 2 * (2 * 4 + 2)
    cfg = torch_cp_ranks.train_cfg("gen3c")
    one = Trainer(torch_cp_ranks.trainer_config(job, 3), cfg, build_net(cfg, "cpu", 0))
    assert one.maybe_resume() == 2
    for n, p in one.state.params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), at_tp2[0]["params"][n])
    state = one.train(torch_cp_ranks.trainer_data())
    assert state.step == 3 and one.checkpointer.steps() == [1, 2, 3]
    back = ranks.run("trainer_run", dp=2, tp=2, job_dir=job, max_iter=3)
    for r in back:
        assert r["step"] == 3
        for n, p in state.params.named_parameters():
            np.testing.assert_array_equal(r["params"][n], p.detach().numpy())
