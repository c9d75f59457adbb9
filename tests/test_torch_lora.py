"""The port's LoRA fine-tuning and layer control against gen3c_tpu on the CPU.

The JAX tiny-preset DiT (fp32, the blocks' zero-init AdaLN gates and the
final linear randomized) goes through bridge.dit_state_from_jax into the
port, and JAX's adapters through bridge.lora_state_from_jax, so both
packages train the same adapters over the same base. Random draws cannot
match (jax.random against torch.Generator), so the port is handed JAX's
sigma and noise, drawn from the same key split as gen3c_tpu's
``lora_train_step``.

Tolerances:
  * layer-control plans: equal, key for key and value for value;
  * merged weights: fp32 within 1e-6 of the weight's max |.| (the rank-r
    product A @ B sums in another order); bf16 against op-by-op JAX
    (``jax.disable_jit``): equal except where A @ B's last fp32 bit tips a
    bf16 rounding, one bf16 step (2^-7 relative) at most, on <= 0.1% of
    the elements;
  * three lora_train_steps: loss rtol 1e-4 per step, adapters within 0.05
    * lr of JAX's (atol: a gradient entry that is ~0 in both may differ in
    sign, and Adam turns that into a full +-lr step), far below the lr
    they move by;
  * remat: bitwise; the base: bitwise unchanged.
"""

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
from gen3c_tpu.training import peft_control as jpeft
from gen3c_tpu.training import train_step as jts
from gen3c_tpu_torch.bridge import dit_state_from_jax, lora_state_from_jax
from gen3c_tpu_torch.models.dit import GeneralDIT
from gen3c_tpu_torch.pipelines.factory import GEN3C_TINY_PRESET
from gen3c_tpu_torch.training import lora as tlora
from gen3c_tpu_torch.training import peft_control as tpeft
from gen3c_tpu_torch.training import train_step as tts

torch.set_num_threads(2)
B, T, H, W = 1, 2, 8, 12  # latent (16, 2, 8, 12): 48 tokens
LR = 1e-3


@pytest.fixture(scope="module")
def jparams():
    return jdit.randomize_degenerate_inits(
        jdit.init_dit_params(jax.random.PRNGKey(0), JAX_TINY.dit))


def _port_net(jtree, cfg=GEN3C_TINY_PRESET.dit):
    net = GeneralDIT(cfg)
    net.load_state_dict(dit_state_from_jax(jax.tree.map(np.asarray, jtree)), strict=True)
    return net


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"x0": rng.standard_normal((B, 16, T, H, W)).astype(np.float32),
            "crossattn_emb": rng.standard_normal((B, 16, 1024)).astype(np.float32),
            "extra_channels": rng.standard_normal(
                (B, JAX_TINY.dit.in_channels - 16, T, H, W)).astype(np.float32)}


def _jax_draws(rng, shape):
    """gen3c_tpu lora_train_step's sigma and noise (lora.py:114-117)."""
    k_sigma, k_noise = jax.random.split(rng)
    return tts.StepDraws(
        sigma=torch.from_numpy(np.array(jlosses.sample_sigma(k_sigma, shape[0]))),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))))


def _flat_paths(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): leaf
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------ layer control ------------------------------

FIRST_N = r"\b(" + "|".join(str(i) for i in range(2)) + r")\b"
CONFIGS = {
    # the reference's get_fa_ca_qv_lora_config shape (tests/test_lora.py:88)
    "reference_fa_ca_qv": dict(enabled=True, customization_type="LoRA", rank=8, scale=1,
                               edits=[dict(blocks=FIRST_N, rank=8, scale=1,
                                           block_edit=["FA[to_q, to_v]", "CA[to_q, to_v]"])]),
    "per_layer_rank_scale": dict(enabled=True, customization_type="LoRA", rank=8, scale=1.0,
                                 edits=[dict(blocks=r"\b(1)\b",
                                             block_edit=["FA[to_q:4:0.5, to_out]", "MLP[l1]"]),
                                        dict(blocks="final_layer", block_edit=["FL[l1, ada2]"],
                                             rank=2, scale=0.25)]),
    "every_vocabulary_layer": dict(
        enabled="true", customization_type="CustomizationType.LORA", rank=3, scale=0.5,
        edits=[dict(blocks=r"\d+", block_edit=[
            "FA[to_q, to_k, to_v, to_out, ada1, ada2]", "CA[to_q, to_k, to_v, to_out, ada1, ada2]",
            "MLP[l1, l2, ada1:2, ada2:5:0.75]"]),
            dict(blocks="final_layer", block_edit=["FL[l1, ada1, ada2]"])]),
    "final_layer_only": dict(enabled=True, customization_type="LoRA",
                             edits=[dict(blocks="final_layer", block_edit=["FL[l1:6:2.5]"])]),
    "json_string": ('{"enabled": true, "customization_type": "LoRA", "rank": 4, '
                    '"edits": [{"blocks": "\\\\b(0)\\\\b", "block_edit": ["CA[to_k]"]}]}'),
    "disabled": {"enabled": False, "customization_type": "LoRA",
                 "edits": [dict(blocks=r"\d+", block_edit=["FA[to_q]"])]},
    "empty": {},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layer_control_plan_matches_jax(name):
    want = jpeft.parse_layer_control(CONFIGS[name], num_blocks=3)
    got = tpeft.parse_layer_control(CONFIGS[name], num_blocks=3)
    assert got == want
    assert (len(got) > 0) == (name not in ("disabled", "empty"))


BAD = {
    "unknown_subblock": ["XX[to_q]"],
    "unknown_layer": ["FA[to_z]"],
    "mlp_has_no_to_q": ["MLP[to_q]"],
    "malformed": ["FA to_q"],
}


@pytest.mark.parametrize("name", list(BAD))
def test_layer_control_errors_match_jax(name):
    config = dict(enabled=True, customization_type="LoRA", edits=[dict(blocks=r"\d+",
                                                                      block_edit=BAD[name])])
    with pytest.raises(ValueError) as jerr:
        jpeft.parse_layer_control(config, num_blocks=2)
    with pytest.raises(ValueError) as terr:
        tpeft.parse_layer_control(config, num_blocks=2)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("config", [
    dict(enabled=True, edits=[]),  # no customization_type
    dict(enabled=True, customization_type="DoRA", edits=[]),
    dict(enabled=True, customization_type="LoRA",
         edits=[dict(blocks="block_99", block_edit=["FA[to_q]"])]),  # selects no block
])
def test_layer_control_config_errors_match_jax(config):
    with pytest.raises(ValueError) as jerr:
        jpeft.parse_layer_control(config, num_blocks=2)
    with pytest.raises(ValueError) as terr:
        tpeft.parse_layer_control(config, num_blocks=2)
    assert str(terr.value) == str(jerr.value)


def test_port_names_cover_the_vocabulary(jparams):
    """Every path the vocabulary names maps to the port's parameter that
    holds the same JAX leaf (transposed to (out, in))."""
    sd = dit_state_from_jax(jax.tree.map(np.asarray, jparams))
    flat = _flat_paths(jparams)
    paths = list(tpeft.vocabulary_paths(JAX_TINY.dit.num_blocks))
    assert len(paths) == 16 * JAX_TINY.dit.num_blocks + 3 and len(set(paths)) == len(paths)
    for path in paths:
        np.testing.assert_array_equal(sd[tpeft.port_name(path)].numpy(),
                                      np.asarray(flat[path]).T)
    names = {tpeft.port_name(p) for p in paths}
    assert len(names) == len(paths)
    with pytest.raises(KeyError):
        tpeft.port_name("blocks/0/fa/q_norm/scale")


# ------------------------------ adapters ------------------------------


def test_init_targets_attention_only(jparams):
    """DEFAULT_TARGETS: FA and CA q/k/v/out of every block; A ~ N(0, 1) / r
    (divided by r, as gen3c_tpu's), B = 0, the JAX shapes."""
    jl = jlora.init_lora_params(jax.random.PRNGKey(1), jparams, rank=4)
    tl = tlora.init_lora_params(torch.Generator().manual_seed(1), _port_net(jparams), rank=4)
    assert set(tl) == set(jl) and len(tl) == 2 * 4 * JAX_TINY.dit.num_blocks
    for path, ab in tl.items():
        assert tuple(ab["a"].shape) == jl[path]["a"].shape
        assert tuple(ab["b"].shape) == jl[path]["b"].shape
        assert not ab["b"].any() and ab["a"].dtype == torch.float32
    a = torch.cat([ab["a"].flatten() for ab in tl.values()])
    assert abs(a.std().item() * 4 - 1.0) < 0.05 and abs(a.mean().item()) < 0.02


def test_init_from_plan_matches_jax(jparams):
    plan = tpeft.parse_layer_control(CONFIGS["every_vocabulary_layer"],
                                     num_blocks=JAX_TINY.dit.num_blocks)
    jl = jlora.init_lora_params(jax.random.PRNGKey(1), jparams, plan=plan)
    tl = tlora.init_lora_params(torch.Generator().manual_seed(1), _port_net(jparams), plan=plan)
    assert set(tl) == set(jl) == set(plan)
    for path, ab in tl.items():
        assert tuple(ab["a"].shape) == jl[path]["a"].shape
        assert tuple(ab["b"].shape) == jl[path]["b"].shape
    assert tlora.plan_scales(plan) == jlora.plan_scales(plan)
    with pytest.raises(ValueError):
        tlora.init_lora_params(torch.Generator(), _port_net(jparams), plan={"blocks/9/fa/q/w":
                                                                           (2, 1.0)})
    with pytest.raises(ValueError):
        tlora.init_lora_params(torch.Generator(), _port_net(jparams), targets=r"nothing$")


def _random_b(jl, seed):
    rng = np.random.default_rng(seed)
    return {p: {"a": ab["a"], "b": jnp.asarray(rng.standard_normal(ab["b"].shape), jnp.float32)}
            for p, ab in jl.items()}


@pytest.mark.parametrize("use_plan", [False, True])
def test_apply_lora_fp32_matches_jax(jparams, use_plan):
    plan = (tpeft.parse_layer_control(CONFIGS["per_layer_rank_scale"],
                                      num_blocks=JAX_TINY.dit.num_blocks) if use_plan else None)
    jl = _random_b(jlora.init_lora_params(jax.random.PRNGKey(1), jparams, rank=4, plan=plan), 2)
    scales = jlora.plan_scales(plan) if plan else None
    merged = dit_state_from_jax(jax.tree.map(np.asarray, jlora.apply_lora(jparams, jl, 0.7, scales)))
    net = _port_net(jparams)
    got = tlora.apply_lora(net, lora_state_from_jax(jax.tree.map(np.asarray, jl)), 0.7, scales)
    assert set(got) == {tpeft.port_name(p) for p in jl}
    for name, w in got.items():
        want = merged[name]
        assert (want - dict(net.named_parameters())[name]).abs().max() > 0  # the merge moved it
        assert (w - want).abs().max().item() <= 1e-6 * want.abs().max().item(), name


def test_apply_lora_bf16_matches_jax_op_by_op(jparams):
    """bf16 weights: (A @ B) in fp32, cast to bf16, then W + s * ab in bf16,
    against gen3c_tpu's apply_lora run op by op."""
    jbf = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    jl = _random_b(jlora.init_lora_params(jax.random.PRNGKey(1), jbf, rank=4), 3)
    with jax.disable_jit():
        merged = dit_state_from_jax(jax.tree.map(np.asarray, jlora.apply_lora(jbf, jl, 0.3)))
    net = _port_net(jparams).to(torch.bfloat16)
    got = tlora.apply_lora(net, lora_state_from_jax(jax.tree.map(np.asarray, jl)), 0.3)
    total = diff = 0
    base = dict(net.named_parameters())
    for name, w in got.items():
        want = merged[name]
        assert w.dtype == want.dtype == torch.bfloat16
        d = (w.float() - want.float()).abs()
        # one bf16 step of the larger of the sum and its first operand (the
        # sum may cancel to near 0)
        assert (d <= 2 ** -7 * torch.maximum(want.float().abs(), base[name].float().abs())).all()
        total += d.numel()
        diff += int((d > 0).sum())
    assert diff <= 1e-3 * total, (diff, total)


def test_lora_attached_merges_and_restores(jparams):
    """Within lora_attached the net computes with the merged weights (its
    output equals the net loaded with apply_lora's weights); after it, the
    base's parameters are the same objects with the same bits."""
    jl = _random_b(jlora.init_lora_params(jax.random.PRNGKey(1), jparams, rank=4), 4)
    tl = lora_state_from_jax(jax.tree.map(np.asarray, jl))
    net = _port_net(jparams)
    before = {n: (p, p.detach().clone()) for n, p in net.named_parameters()}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, 81, T, H, W)).astype(np.float32))
    t = torch.tensor([0.3])
    ctx = torch.from_numpy(rng.standard_normal((B, 16, 1024)).astype(np.float32))
    merged_net = _port_net(jparams)
    with torch.no_grad():
        for name, w in tlora.apply_lora(net, tl, 0.5).items():
            merged_net.get_parameter(name).copy_(w)
        want = merged_net(x, t, ctx, fps=24.0)
        with tlora.lora_attached(net, tl, 0.5):
            got = net(x, t, ctx, fps=24.0)
        plain = net(x, t, ctx, fps=24.0)
    assert torch.equal(got, want) and not torch.equal(got, plain)
    after = dict(net.named_parameters())
    assert set(after) == set(before)
    for n, (p, v) in before.items():
        assert after[n] is p and torch.equal(p, v), n


# ------------------------------ training ------------------------------


def test_three_lora_train_steps_match_jax(jparams):
    """jax.jit(lora_train_step) with gen3c_tpu's make_optimizer (warmup 2,
    clip 0.11, active on the steps whose grad-norm exceeds it: lr 0, lr/2,
    lr) against the port's step with the same
    optimizer and JAX's draws: loss per step, then every adapter."""
    jopt = jts.make_optimizer(lr=LR, grad_clip=0.11, warmup_steps=2)
    jl = jlora.init_lora_params(jax.random.PRNGKey(1), jparams, rank=4)
    jstate = jopt.init(jl)
    jstep = jax.jit(partial(jlora.lora_train_step, cfg=JAX_TINY.dit, optimizer=jopt, scale=0.8))
    net = _port_net(jparams)
    base = {n: p.detach().clone() for n, p in net.named_parameters()}
    tl = lora_state_from_jax(jax.tree.map(np.asarray, jl))
    opt = tts.make_optimizer(lr=LR, grad_clip=0.11, warmup_steps=2)
    state = opt.init(tlora.lora_leaves(tl))
    norms = []
    for i in range(3):
        batch = _batch(20 + i)
        rng = jax.random.PRNGKey(200 + i)
        jl, jstate, jm = jstep(jl, jstate, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                               rng)
        tl, state, m = tlora.lora_train_step(
            tl, state, net, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
            GEN3C_TINY_PRESET.dit, opt, scale=0.8, draws=_jax_draws(rng, batch["x0"].shape))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        norms.append(float(m["grad_norm"]))
    assert max(norms) > 0.11  # the clip was active on some step
    want = lora_state_from_jax(jax.tree.map(np.asarray, jl))
    moved = max((want[p]["b"]).abs().max().item() for p in want)
    assert moved > LR  # B started at 0 and moved by more than one step
    for p, ab in want.items():
        for key in "ab":
            err = (tl[p][key].detach() - ab[key]).abs().max().item()
            assert err <= 0.05 * LR, (p, key, err)
    for n, p in net.named_parameters():  # the base is frozen and unchanged
        assert torch.equal(p, base[n]) and not p.requires_grad, n


def test_lora_remat_is_bitwise(jparams):
    results = []
    for remat in (False, True):
        net = _port_net(jparams)
        tl = lora_state_from_jax(jax.tree.map(
            np.asarray, _random_b(jlora.init_lora_params(jax.random.PRNGKey(1), jparams, rank=4),
                                  6)))
        opt = tts.make_optimizer(lr=LR, warmup_steps=1)
        state = opt.init(tlora.lora_leaves(tl))
        batch = {k: torch.from_numpy(v) for k, v in _batch(7).items()}
        draws = tts.draw_step(torch.Generator().manual_seed(8), batch["x0"].shape, False, False)
        for _ in range(2):
            tl, state, m = tlora.lora_train_step(tl, state, net, batch, None,
                                                 GEN3C_TINY_PRESET.dit, opt, remat=remat,
                                                 draws=draws)
        results.append((m, tlora.lora_leaves(tl)))
    (m0, l0), (m1, l1) = results
    assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert all(torch.equal(l0[k], l1[k]) for k in l0)


def test_lora_training_reduces_loss_and_freezes_base(jparams):
    """tests/test_lora.py's check on the port: six steps on one batch with
    fixed draws lower the loss, and the base stays bitwise as it was."""
    net = _port_net(jparams)
    base = {n: p.detach().clone() for n, p in net.named_parameters()}
    tl = tlora.init_lora_params(torch.Generator().manual_seed(1), net, rank=4)
    opt = tts.make_optimizer(lr=5e-3, weight_decay=0.0, grad_clip=1e9, warmup_steps=1)
    state = opt.init(tlora.lora_leaves(tl))
    batch = {k: torch.from_numpy(v) for k, v in _batch(9).items()}
    draws = tts.draw_step(torch.Generator().manual_seed(7), batch["x0"].shape, False, False)
    losses = []
    for _ in range(6):
        tl, state, m = tlora.lora_train_step(tl, state, net, batch, None, GEN3C_TINY_PRESET.dit,
                                             opt, draws=draws)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    for n, p in net.named_parameters():
        assert torch.equal(p, base[n]), n
